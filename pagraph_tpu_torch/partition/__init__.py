"""Graph partitioning (the port of ``pagraph_tpu/partition/``): PaGraph's
self-reliant closures, the hash, computation-aware greedy (dg) and
Kernighan-Lin partitioners, and locality reordering.  Each module is the
port's own copy of the JAX package's, with the same results; the native
backends run on the port's host library (``csrc/host_native.cpp``)."""
from .dg_part import dg_assign, dg_partition
from .hash_part import hash_partition
from .kl_part import kl_assign, kl_bisect, kl_partition
from .ordering import apply_reordering, reorder_map
from .utils import extract_partition, hop_closure, partition_stats
