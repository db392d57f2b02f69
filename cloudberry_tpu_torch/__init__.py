"""cloudberry_tpu_torch — the PyTorch + CUDA port of cloudberry_tpu.

The JAX package ``cloudberry_tpu`` is the reference; this package is its
port to PyTorch on an NVIDIA Hopper GPU (H100), one slice at a time. It
imports neither JAX nor any module of the JAX package: the host layers
(types, columnar batches, catalog, SQL parser, binder, planner) are copies
with their imports rewritten, and the device layers (exec/) are written in
PyTorch, with every Pallas kernel of the reference replaced by a CUDA C++
kernel for sm_90a (exec/cuda_kernels.py, csrc/).

It runs single-segment statements on one device, over in-RAM tables or a
durable store, with admission (memory budget, tiling, resource queues,
the red line), EXPLAIN ANALYZE and the observability plane (obs/).
"""

from cloudberry_tpu_torch.config import Config, get_config, set_config
from cloudberry_tpu_torch.session import Session

__version__ = "0.1.0"
__all__ = ["Config", "get_config", "set_config", "Session", "__version__"]
