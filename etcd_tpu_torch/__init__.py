"""etcd_tpu_torch: the batched multi-tenant etcd engine in PyTorch and CUDA.

G Raft groups × P peer slots stepped as dense tensor programs on one
NVIDIA GPU (the JAX package `etcd_tpu` is the reference implementation).
Entry points run on the card unless the caller passes `device="cpu"`.
Importing the package builds its C extensions at first use
(`native_build`), before any loader looks for them.
"""

from etcd_tpu_torch import native_build as _native_build

__version__ = "0.1.0"

_native_build.ensure()
