"""Host-to-host transport of the multi-host engine (`frames`). The device
mesh (the JAX package's `parallel/mesh.py`) is not ported yet: it comes
with the multi-device engine."""
