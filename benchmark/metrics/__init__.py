"""One reader per metric, named as the metric: `read(obs)` returns the
number from a run's observations, or None where there is nothing to read
(see `benchmark/driver.py` for the keys of `obs`)."""
