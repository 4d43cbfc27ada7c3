"""pagraph_tpu_torch — the PyTorch/CUDA port of pagraph_tpu.

Neighbor-sampled GNN minibatch training with a degree-ranked device feature
cache, written for one NVIDIA Hopper GPU.  The JAX package ``pagraph_tpu``
is the reference each module is held against in the tests; this package
imports nothing of it (nor of JAX) and keeps its own copies of the host code
it needs.  The two Pallas kernels of ``pagraph_tpu/ops/pallas_gather.py`` are
CUDA C++ here (``csrc/gather_kernels.cu``, wrapped by ``ops/gather_kernels``).
"""
from .config import (
    CacheConfig,
    Config,
    ModelConfig,
    PartitionConfig,
    SamplerConfig,
    TrainConfig,
)
from .graph import CSRGraph, gcn_norm

__version__ = "0.1.0"
