"""Platform helpers: host allocator tuning, a threaded random fill, and the
device-memory budget (the port of ``pagraph_tpu/utils/platform.py``).

The budget reads the card through ``torch.cuda.mem_get_info`` (the
reference's own probe: ``total - peak_allocated - peak_cached - 1 GiB``,
PaGraph/storage/storage.py:77-88).  A CPU device has no budget and raises:
there is no default size to fall back to, so a missing card is never taken
for an empty one.  The JAX module's ``use_fast_prng`` and
``enable_compilation_cache`` have no counterpart: torch's generators have
one implementation, and the port's kernels are built once into
``pagraph_tpu_torch/_build/``.
"""
from __future__ import annotations

import ctypes

import torch

from .device import resolve_device

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_allocator_tuned = False


def trim_host_allocator() -> None:
    """One-shot ``malloc_trim(0)``: hand the heap's freed tail back to the
    OS.  ``tune_host_allocator`` disables automatic trimming so freed numpy
    temporaries stay warm; call this between phases when the next one needs
    the headroom more than the warmth."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.malloc_trim(ctypes.c_size_t(0))
    except (OSError, AttributeError):    # no glibc
        pass


def tune_host_allocator(warm_bytes: int = 0, threads: int = 4) -> None:
    """Serve large allocations from the (never-trimmed) heap arena, so freed
    pages stay warm, and pre-fault ``warm_bytes`` of it once with parallel
    first-touch.  On hosts that fault fresh anonymous pages slowly, glibc's
    default (mmap every allocation over 128 KiB and unmap it on free)
    re-faults every large numpy temporary.  Once a process."""
    global _allocator_tuned
    if _allocator_tuned:
        return
    _allocator_tuned = True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(1 << 30))
        libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(-1))
    except (OSError, AttributeError):    # no glibc
        return
    if warm_bytes <= 0:
        return
    import concurrent.futures as cf

    import numpy as np

    buf = np.empty(warm_bytes // 8, dtype=np.float64)
    n = len(buf)
    chunk = (n + threads - 1) // threads
    with cf.ThreadPoolExecutor(threads) as ex:
        list(ex.map(lambda i: buf[i * chunk: (i + 1) * chunk].fill(0), range(threads)))
    del buf  # pages stay in the heap arena, warm


def parallel_random(shape, *, dtype="float32", seed: int = 0, threads: int = 4):
    """Multi-threaded uniform random fill: independent per-chunk PCG streams
    (``SeedSequence((seed, i))``) across threads parallelize both the page
    faults and the generation.  Equal to the JAX package's for the same
    shape, seed and threads."""
    import concurrent.futures as cf

    import numpy as np

    out = np.empty(shape, dtype=dtype)
    flat = out.reshape(-1)
    n = flat.size
    chunk = (n + threads - 1) // threads

    def fill(i):
        rng = np.random.default_rng(np.random.SeedSequence((seed, i)))
        lo = i * chunk
        hi = min(n, lo + chunk)
        if lo < hi:
            rng.random(out=flat[lo:hi], dtype=out.dtype)

    with cf.ThreadPoolExecutor(threads) as ex:
        list(ex.map(fill, range(threads)))
    return out


def free_device_bytes(device: torch.device) -> int:
    """Free memory of a CUDA device, as ``mem_get_info`` reports it; a CPU
    device raises ``ValueError``."""
    if device.type != "cuda":
        raise ValueError("capacity=None sizes the cache from free GPU "
                         "memory: give a capacity on a CPU device")
    return torch.cuda.mem_get_info(device)[0]


def device_memory_stats(device=None) -> dict:
    """Device memory of a card (bytes), under the JAX package's keys:
    ``bytes_in_use``, what this process's tensors hold
    (``torch.cuda.memory_allocated``), and ``bytes_limit``, what it could
    hold: that plus the card's free bytes (``mem_get_info``).  ``None`` is
    the card; a CPU device raises ``ValueError``."""
    dev = resolve_device(device)
    free = free_device_bytes(dev)
    in_use = int(torch.cuda.memory_allocated(dev))
    return {"bytes_in_use": in_use, "bytes_limit": in_use + int(free)}


def free_hbm_bytes(device=None, reserve: int = 1 << 30) -> int:
    """Device memory free after a reserve margin, the JAX package's
    ``bytes_limit - bytes_in_use - reserve`` (floored at 0): the card's free
    bytes less ``reserve``."""
    s = device_memory_stats(device)
    return max(0, s["bytes_limit"] - s["bytes_in_use"] - reserve)
