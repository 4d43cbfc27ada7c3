"""Wrappers of the CUDA gather kernels, their plain PyTorch versions, the
autograd Functions that train through them, and the launch counters.

The port's counterpart of ``pagraph_tpu/ops/pallas_gather.py``:

=====================  ===============================================  ==========================
wrapper                computes                                         replaces
=====================  ===============================================  ==========================
``gather_rows``        ``out[r] = src[ids[r]]``                         ``gather_rows_pallas`` (K1)
``assemble_from_map``  ``cache_values[pos]`` if ``pos = cache_map        ``gather_rows_pallas`` (K1)
                       [nids[r]] >= 0``, else ``miss_feats               + ``assemble_features_from_map``
                       [miss_slot[r]]``
``scatter_add_rows``   ``grad_src[ids[r]] += grad_out[r]``              backward of K1
``gather_reduce``      masked ``mean``/``sum`` of ``src[pos[n, k]]``    ``gather_mean_pallas`` (K2)
``gather_reduce_bwd``  ``grad_src[pos[n,k]] += grad_out[n] (/count)``   backward of K2
=====================  ===============================================  ==========================

Dispatch is by the device of the tensors and nothing else: on CUDA tensors a
wrapper launches its kernel (``csrc/gather_kernels.cu``, built at first use by
``ops/_build.py``) or raises; on CPU tensors it runs the plain version.  There
is no fallback from a failed build or launch.  :func:`plain_versions` runs the
plain versions on CUDA tensors too, so a check on the card can hold a whole
train step against them.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches its
kernel, and nowhere else.  Indices must be in range: the kernels do not
bounds-check them (the sampler and the cache plan produce them).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator

import torch

KINDS = ("mean", "sum")

LAUNCHES: Dict[str, int] = {
    "gather_rows": 0,
    "assemble_from_map": 0,
    "scatter_add_rows": 0,
    "gather_reduce_mean": 0,
    "gather_reduce_sum": 0,
    "gather_reduce_bwd_mean": 0,
    "gather_reduce_bwd_sum": 0,
}

_PLAIN_ON_CUDA = contextvars.ContextVar("pagraph_plain_on_cuda", default=False)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


@contextlib.contextmanager
def plain_versions() -> Iterator[None]:
    """Inside this block every wrapper runs its plain version, on CUDA
    tensors too (for holding the kernels against them on the card)."""
    token = _PLAIN_ON_CUDA.set(True)
    try:
        yield
    finally:
        _PLAIN_ON_CUDA.reset(token)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference on the card)
# ---------------------------------------------------------------------------

def gather_rows_plain(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return src[ids.long()]


def assemble_from_map_plain(cache_values, cache_map, nids, miss_slot,
                            miss_feats) -> torch.Tensor:
    pos = cache_map[nids.long()]
    hit = (pos >= 0)[:, None]
    hits = cache_values[pos.clamp(min=0).long()]
    if miss_feats.shape[0] == 0:
        return torch.where(hit, hits, torch.zeros_like(hits))
    return torch.where(hit, hits, miss_feats[miss_slot.long()])


def scatter_add_rows_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                           num_src: int) -> torch.Tensor:
    out = grad_out.new_zeros((num_src, grad_out.shape[1]))
    return out.index_add_(0, ids.long(), grad_out)


def _count(mask: torch.Tensor, dtype) -> torch.Tensor:
    return mask.sum(dim=1, keepdim=True).clamp(min=1).to(dtype)


def reduce_msgs_plain(msgs: torch.Tensor, mask: torch.Tensor,
                      kind: str) -> torch.Tensor:
    """Masked reduction of ``msgs [N, F, D]`` over the fan-out axis; rows
    with no valid slot get zeros (DGL's empty-mailbox default)."""
    s = torch.where(mask[..., None], msgs, 0.0).sum(dim=1)
    return s / _count(mask, s.dtype) if kind == "mean" else s


def gather_reduce_plain(src, pos, mask, kind: str) -> torch.Tensor:
    return reduce_msgs_plain(src[pos.long()], mask, kind)


def gather_reduce_bwd_plain(grad_out, pos, mask, num_src: int,
                            kind: str) -> torch.Tensor:
    g = grad_out / _count(mask, grad_out.dtype) if kind == "mean" else grad_out
    rows, slots = mask.nonzero(as_tuple=True)
    out = grad_out.new_zeros((num_src, grad_out.shape[1]))
    return out.index_add_(0, pos[rows, slots].long(), g[rows])


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _use_kernel(*tensors: torch.Tensor) -> bool:
    """True: launch the kernel; False: run the plain version.  Raises for
    mixed devices or a device that is neither CPU nor CUDA."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return not _PLAIN_ON_CUDA.get()


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _vec(d: int, *tables: torch.Tensor) -> int:
    """1 if rows can move as float4: D % 4 == 0 and 16-byte-aligned bases."""
    return int(d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tables))


def _lib():
    from ._build import load
    return load("gather_kernels")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def gather_rows(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``src[ids]`` for ``src`` f32 ``[S, D]`` and ``ids`` int32 ``[N]``."""
    if not _use_kernel(src, ids):
        return gather_rows_plain(src, ids)
    _check(src, "src", torch.float32, 2)
    _check(ids, "ids", torch.int32, 1)
    n, d = ids.shape[0], src.shape[1]
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if n and d:
        _raise_on(_lib().pg_gather_rows(
            src.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
            _vec(d, src, out), _stream(src.device)), "pg_gather_rows")
        LAUNCHES["gather_rows"] += 1
    return out


def assemble_from_map(cache_values: torch.Tensor, cache_map: torch.Tensor,
                      nids: torch.Tensor, miss_slot: torch.Tensor,
                      miss_feats: torch.Tensor) -> torch.Tensor:
    """Layer-0 features from the device cache plus the shipped miss rows:
    row r is ``cache_values[cache_map[nids[r]]]`` when that is ``>= 0``,
    else ``miss_feats[miss_slot[r]]`` (zeros if there are no miss rows)."""
    if not _use_kernel(cache_values, cache_map, nids, miss_slot, miss_feats):
        return assemble_from_map_plain(cache_values, cache_map, nids,
                                       miss_slot, miss_feats)
    _check(cache_values, "cache_values", torch.float32, 2)
    _check(cache_map, "cache_map", torch.int32, 1)
    _check(nids, "nids", torch.int32, 1)
    _check(miss_slot, "miss_slot", torch.int32, 1)
    _check(miss_feats, "miss_feats", torch.float32, 2)
    n, d = nids.shape[0], cache_values.shape[1]
    if miss_slot.shape[0] != n:
        raise ValueError(f"miss_slot has {miss_slot.shape[0]} rows, nids {n}")
    if miss_feats.shape[1] != d:
        raise ValueError(f"miss_feats width {miss_feats.shape[1]} != cache width {d}")
    out = torch.empty((n, d), dtype=torch.float32, device=cache_values.device)
    if n and d:
        _raise_on(_lib().pg_assemble_from_map(
            cache_values.data_ptr(), cache_map.data_ptr(), nids.data_ptr(),
            miss_slot.data_ptr(), miss_feats.data_ptr(), out.data_ptr(), n, d,
            miss_feats.shape[0], _vec(d, cache_values, miss_feats, out),
            _stream(out.device)), "pg_assemble_from_map")
        LAUNCHES["assemble_from_map"] += 1
    return out


def scatter_add_rows(grad_out: torch.Tensor, ids: torch.Tensor,
                     num_src: int) -> torch.Tensor:
    """Backward of :func:`gather_rows`: a zeroed ``[num_src, D]`` table with
    ``grad_out[r]`` added at row ``ids[r]`` (f32 atomics on the card)."""
    if not _use_kernel(grad_out, ids):
        return scatter_add_rows_plain(grad_out, ids, num_src)
    _check(grad_out, "grad_out", torch.float32, 2)
    _check(ids, "ids", torch.int32, 1)
    n, d = grad_out.shape
    if ids.shape[0] != n:
        raise ValueError(f"ids has {ids.shape[0]} rows, grad_out {n}")
    out = torch.zeros((num_src, d), dtype=torch.float32, device=grad_out.device)
    if n and d:
        _raise_on(_lib().pg_scatter_add_rows(
            grad_out.data_ptr(), ids.data_ptr(), out.data_ptr(), n, d,
            _stream(out.device)), "pg_scatter_add_rows")
        LAUNCHES["scatter_add_rows"] += 1
    return out


def _check_reduce(pos, mask, kind):
    if kind not in KINDS:
        raise ValueError(f"gather_reduce kind must be one of {KINDS}, got {kind!r}")
    _check(pos, "pos", torch.int32, 2)
    _check(mask, "mask", torch.bool, 2)
    if pos.shape != mask.shape:
        raise ValueError(f"pos {tuple(pos.shape)} and mask {tuple(mask.shape)} differ")


def gather_reduce(src: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                  kind: str = "mean") -> torch.Tensor:
    """``out[n] = sum_k mask[n,k] * src[pos[n,k]]``, divided by
    ``max(sum_k mask[n,k], 1)`` for ``kind="mean"``.  Masked slots are
    never loaded.  ``src`` f32 ``[S, D]``; ``pos`` int32 and ``mask`` bool
    ``[N, fanout]``."""
    if not _use_kernel(src, pos, mask):
        if kind not in KINDS:
            raise ValueError(f"gather_reduce kind must be one of {KINDS}, got {kind!r}")
        return gather_reduce_plain(src, pos, mask, kind)
    _check(src, "src", torch.float32, 2)
    _check_reduce(pos, mask, kind)
    (n, fanout), d = pos.shape, src.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=src.device)
    if n and d:
        _raise_on(_lib().pg_gather_reduce(
            src.data_ptr(), pos.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, fanout, d, int(kind == "mean"), _vec(d, src, out),
            _stream(out.device)), "pg_gather_reduce")
        LAUNCHES["gather_reduce_" + kind] += 1
    return out


def gather_reduce_bwd(grad_out: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor, num_src: int,
                      kind: str = "mean") -> torch.Tensor:
    """Backward of :func:`gather_reduce`: for each valid slot,
    ``grad_src[pos[n,k]] += grad_out[n]`` (divided by the row's count for
    ``mean``), into a zeroed ``[num_src, D]`` table (f32 atomics on the
    card)."""
    if not _use_kernel(grad_out, pos, mask):
        if kind not in KINDS:
            raise ValueError(f"gather_reduce kind must be one of {KINDS}, got {kind!r}")
        return gather_reduce_bwd_plain(grad_out, pos, mask, num_src, kind)
    _check(grad_out, "grad_out", torch.float32, 2)
    _check_reduce(pos, mask, kind)
    (n, fanout), d = pos.shape, grad_out.shape[1]
    if grad_out.shape[0] != n:
        raise ValueError(f"grad_out has {grad_out.shape[0]} rows, pos {n}")
    out = torch.zeros((num_src, d), dtype=torch.float32, device=grad_out.device)
    if n and d:
        _raise_on(_lib().pg_gather_reduce_bwd(
            grad_out.data_ptr(), pos.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, fanout, d, int(kind == "mean"), _stream(out.device)),
            "pg_gather_reduce_bwd")
        LAUNCHES["gather_reduce_bwd_" + kind] += 1
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
# The autograd engine runs a CUDA backward on its own thread, which does not
# see the forward's context: each Function records whether its forward ran
# under plain_versions() and its backward re-enters that mode.

def _mode(plain: bool):
    return plain_versions() if plain else contextlib.nullcontext()


class GatherRows(torch.autograd.Function):
    """``src[ids]`` whose gradient w.r.t. ``src`` is :func:`scatter_add_rows`."""

    @staticmethod
    def forward(ctx, src, ids):
        ctx.save_for_backward(ids)
        ctx.num_src = src.shape[0]
        ctx.plain = _PLAIN_ON_CUDA.get()
        return gather_rows(src, ids)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        grad_src = None
        if ctx.needs_input_grad[0]:
            with _mode(ctx.plain):
                grad_src = scatter_add_rows(grad_out.contiguous(), ids, ctx.num_src)
        return grad_src, None


class GatherReduce(torch.autograd.Function):
    """Fused gather + masked mean/sum whose gradient w.r.t. ``src`` is
    :func:`gather_reduce_bwd`."""

    @staticmethod
    def forward(ctx, src, pos, mask, kind):
        ctx.save_for_backward(pos, mask)
        ctx.num_src = src.shape[0]
        ctx.kind = kind
        ctx.plain = _PLAIN_ON_CUDA.get()
        return gather_reduce(src, pos, mask, kind)

    @staticmethod
    def backward(ctx, grad_out):
        pos, mask = ctx.saved_tensors
        grad_src = None
        if ctx.needs_input_grad[0]:
            with _mode(ctx.plain):
                grad_src = gather_reduce_bwd(grad_out.contiguous(), pos, mask,
                                             ctx.num_src, ctx.kind)
        return grad_src, None, None, None
