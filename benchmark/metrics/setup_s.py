"""Seconds from the process's start to the window's first request: import,
CUDA, the kernels from their build caches, the engine, its election and
the warm-up traffic (host clock)."""


def read(obs):
    return obs["setup_s"]
