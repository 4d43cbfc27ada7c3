"""Wrappers of the CUDA gather kernels, their plain PyTorch versions, the
autograd Functions that train through them, and the launch counters.

The port's counterpart of ``pagraph_tpu/ops/pallas_gather.py``:

=====================  ===============================================  ==========================
wrapper                computes                                         replaces
=====================  ===============================================  ==========================
``block_gather_fwd``   both halves below from one table                 K1 + K2
``gather_rows``        ``out[r] = src[ids[r]]``                         ``gather_rows_pallas`` (K1)
``gather_reduce``      masked ``mean``/``sum`` of ``src[pos[n, k]]``    ``gather_mean_pallas`` (K2)
``assemble``           ``cache_values[s]`` if ``s = src_row[r] >= 0``,  ``gather_rows_pallas`` (K1)
                       else ``miss_feats[-1 - s]``; as f32 (int8:       + ``assemble_features``
                       times a per-column scale), or that cast to bf16  + ``dequantize_fused``
``block_gather_bwd``   both halves below into one table                 backward of K1 + K2
``scatter_add_rows``   ``grad_src[ids[r]] += grad_out[r]``              backward of K1
``gather_reduce_bwd``  ``grad_src[pos[n,k]] += grad_out[n] (/count)``   backward of K2
=====================  ===============================================  ==========================

The three forwards of a block's gathers are one kernel, ``pg_block_gather_fwd``:
``block_gather_fwd`` runs it with both halves (the forward of
:class:`BlockGather`, the main path's), ``gather_rows`` and ``gather_reduce``
with one half absent.  The three backwards are one kernel,
``pg_block_gather_bwd`` (a memset of the gradient table and one launch, in
one C call), run the same way by ``block_gather_bwd``, ``scatter_add_rows``
and ``gather_reduce_bwd``.  A train step launches 4 kernels: the assembly,
one block forward for each block, and one block backward for block 1 (the
layer-0 features need no gradient); 5 at bf16 compute (below).  The
assembly is one kernel, ``pg_assemble``, for the f32, bf16 and int8 cache
tiers (counted under ``assemble_f32``, ``assemble_bf16``,
``assemble_int8``).

Like the Pallas kernels, the block kernels compute at their table's dtype,
f32 or bf16 (``train.dtype="bfloat16"``): a bf16 table gives bf16 outputs
(the neighbor sum in f32 registers, rounded once) and a bf16 gradient table
(added in an f32 table, then rounded once by a second launch in the same C
call, counted under ``grad_to_bf16``).  Every table of one call has one
dtype.  At bf16 compute the assembly writes bf16 (``out_dtype``): the f32 value
rounded to nearest even, the JAX package's ``dequantize_fused`` followed by
``cast_apply``'s cast.  Each bf16 launch is counted under its own key: the
f32 key with ``_bf16`` (``block_gather_fwd_mean_bf16``), and
``assemble_<tier>_to_bf16`` for the assembly.

Dispatch is by the device of the tensors and nothing else: on CUDA tensors a
wrapper launches its kernel (``csrc/gather_kernels.cu``, built at first use by
``ops/_build.py``) or raises; on CPU tensors it runs the plain version.  There
is no fallback from a failed build or launch.  :func:`plain_versions` runs the
plain versions on CUDA tensors too, so a check on the card can hold a whole
train step against them.

Each wrapper adds one to its entry of :data:`LAUNCHES` where it launches its
kernel, and nowhere else.  It is a host counter: under CUDA-graph capture a
wrapper enqueues its kernel into the graph once and counts it once, and a
replay counts nothing, so a run's launches are the eager ones plus each
graph's captured launches times its replays
(``train.state.CapturedGraph``).  A kernel launches on
``torch.cuda.current_stream()`` of its tensors' device: the capture stream
while a graph is captured, and in a backward the stream autograd runs it on
(the forward's).  The build (:func:`_lib`, nvcc at first use) must have run
before a capture: the first, eager, epoch does it.  Indices must be in
range: the kernels do not bounds-check them (the sampler and the cache plan
produce them).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator

import torch

KINDS = ("mean", "sum")

# the block kernels' row dtypes -> the C element type code
ELEMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the assembly's output dtypes -> the LAUNCHES key's suffix
ASSEMBLE_OUT = {torch.float32: "", torch.bfloat16: "_to_bf16"}

_BLOCK_KEYS = ("block_gather_fwd_mean", "block_gather_fwd_sum", "gather_rows",
               "scatter_add_rows", "gather_reduce_mean", "gather_reduce_sum",
               "gather_reduce_bwd_mean", "gather_reduce_bwd_sum",
               "block_gather_bwd_mean", "block_gather_bwd_sum")

LAUNCHES: Dict[str, int] = {
    **{k + sfx: 0 for sfx in ("", "_bf16") for k in _BLOCK_KEYS},
    **{f"assemble_{tier}{sfx}": 0 for sfx in ASSEMBLE_OUT.values()
       for tier in ("f32", "bf16", "int8")},
    "grad_to_bf16": 0,
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


def assemble_plain(cache_values, src_row, miss_feats, scale=None,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Gather the typed rows, select, ``.float()``, times the scale, then
    ``.to(out_dtype)``."""
    s = src_row.long()
    rows = cache_values[s.clamp(min=0)]
    if miss_feats.shape[0]:
        rows = torch.where((s >= 0)[:, None], rows, miss_feats[(-1 - s).clamp(min=0)])
    rows = rows.float()
    return (rows if scale is None else rows * scale[None, :]).to(out_dtype)


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


def block_gather_fwd_plain(src, self_pos, pos, mask, kind: str):
    """``(gather_rows_plain(src, self_pos), gather_reduce_plain(src, pos,
    mask, kind))``; a ``None`` index is an absent half, whose output is
    ``None``."""
    return (None if self_pos is None else gather_rows_plain(src, self_pos),
            None if pos is None else gather_reduce_plain(src, pos, mask, kind))


def block_gather_bwd_plain(g_self, self_pos, g_neigh, pos, mask, num_src: int,
                           kind: str) -> torch.Tensor:
    """``scatter_add_rows_plain(g_self, self_pos) + gather_reduce_bwd_plain(
    g_neigh, pos, mask)``, added into one zeroed f32 table and returned at
    the gradients' dtype (bf16: rounded once); a ``None`` gradient is an
    absent half."""
    ref = g_self if g_self is not None else g_neigh
    out = torch.zeros((num_src, ref.shape[1]), dtype=torch.float32, device=ref.device)
    if g_self is not None:
        out.index_add_(0, self_pos.long(), g_self.float())
    if g_neigh is not None:
        g = g_neigh.float()
        g = g / _count(mask, g.dtype) if kind == "mean" else g
        rows, slots = mask.nonzero(as_tuple=True)
        out.index_add_(0, pos[rows, slots].long(), g[rows])
    return out.to(ref.dtype)


def scatter_add_rows_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                           num_src: int) -> torch.Tensor:
    return block_gather_bwd_plain(grad_out, ids, None, None, None, num_src, "sum")


def gather_reduce_bwd_plain(grad_out, pos, mask, num_src: int,
                            kind: str) -> torch.Tensor:
    return block_gather_bwd_plain(None, None, grad_out, pos, mask, num_src, kind)


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
    """1 if rows can move in 4-element units (a float4 of f32, 8 bytes of
    bf16): D % 4 == 0 and every base aligned to its unit."""
    return int(d % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                                  for t in tables))


def _row_dtype(*tables) -> torch.dtype:
    """The one row dtype of a call's tables (``None`` entries are absent
    halves): f32 or bf16, else ``TypeError``."""
    dtypes = {t.dtype for t in tables if t is not None}
    if len(dtypes) != 1:
        raise TypeError("the tables of one call must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    (dtype,) = dtypes
    if dtype not in ELEMENT_CODES:
        raise TypeError(f"rows must be one of {list(ELEMENT_CODES)}, got {dtype}")
    return dtype


def _key(base: str, dtype: torch.dtype) -> str:
    return base if dtype == torch.float32 else base + "_bf16"


def _lib():
    from ._build import load
    return load("gather_kernels")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {rc}")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"gather_reduce kind must be one of {KINDS}, got {kind!r}")


def _check_reduce(pos, mask, kind):
    _check_kind(kind)
    _check(pos, "pos", torch.int32, 2)
    _check(mask, "mask", torch.bool, 2)
    if pos.shape != mask.shape:
        raise ValueError(f"pos {tuple(pos.shape)} and mask {tuple(mask.shape)} differ")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _block_fwd_kernel(key: str, src, self_pos, pos, mask, kind: str):
    """Check the halves that are present, allocate their outputs with
    ``torch.empty`` at the table's dtype and run ``pg_block_gather_fwd``
    (one launch), counted under ``LAUNCHES[key]`` (``key_bf16`` for a bf16
    table); an absent half (``None`` index) returns ``None``."""
    _check(src, "src", src.dtype, 2)
    d = src.shape[1]
    n_self = n_neigh = fanout = 0
    out_self = out_neigh = None
    if self_pos is not None:
        _check(self_pos, "self_pos", torch.int32, 1)
        n_self = self_pos.shape[0]
        out_self = torch.empty((n_self, d), dtype=src.dtype, device=src.device)
    if pos is not None:
        _check_reduce(pos, mask, kind)
        n_neigh, fanout = pos.shape
        out_neigh = torch.empty((n_neigh, d), dtype=src.dtype, device=src.device)
    outs = [t for t in (out_self, out_neigh) if t is not None]
    if (n_self or n_neigh) and d:
        _raise_on(_lib().pg_block_gather_fwd(
            src.data_ptr(), _ptr(self_pos), n_self, _ptr(pos), _ptr(mask), n_neigh,
            fanout, _ptr(out_self), _ptr(out_neigh), d, int(kind == "mean"),
            _vec(d, src, *outs), ELEMENT_CODES[src.dtype], _stream(src.device)),
            "pg_block_gather_fwd")
        LAUNCHES[_key(key, src.dtype)] += 1
    return out_self, out_neigh


def block_gather_fwd(src: torch.Tensor, self_pos, pos, mask,
                     kind: str = "mean"):
    """Both gathers of a block from one source table ``src`` f32 or bf16
    ``[S, D]``: ``(src[self_pos], gather_reduce(src, pos, mask, kind))`` for
    ``self_pos`` int32 ``[N_self]``, ``pos`` int32 and ``mask`` bool
    ``[N, fanout]``, at ``src.dtype``.  A ``None`` index is an absent half,
    whose output is ``None``.  On the card: one launch for both."""
    _check_kind(kind)
    _row_dtype(src)
    if self_pos is None and pos is None:
        raise ValueError("block_gather_fwd needs at least one half")
    present = [src] + ([self_pos] if self_pos is not None else []) + (
        [pos, mask] if pos is not None else [])
    if not _use_kernel(*present):
        return block_gather_fwd_plain(src, self_pos, pos, mask, kind)
    return _block_fwd_kernel("block_gather_fwd_" + kind, src, self_pos, pos, mask, kind)


def gather_rows(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``src[ids]`` for ``src`` f32 or bf16 ``[S, D]`` and ``ids`` int32
    ``[N]`` (on the card, the block forward kernel with its neighbor half
    absent)."""
    _row_dtype(src)
    if not _use_kernel(src, ids):
        return gather_rows_plain(src, ids)
    return _block_fwd_kernel("gather_rows", src, ids, None, None, "sum")[0]


# rows a group of lanes of the assembly kernel writes (kRowsPerGroup)
ASSEMBLE_ROWS = 4
# the cache tiers the assembly reads: row dtype -> (C tier, LAUNCHES key, unit bytes)
ASSEMBLE_TIERS = {torch.float32: (0, "assemble_f32", 16),
                  torch.bfloat16: (1, "assemble_bf16", 8),
                  torch.int8: (2, "assemble_int8", 4)}


def assemble(cache_values: torch.Tensor, src_row: torch.Tensor,
             miss_feats: torch.Tensor, scale=None,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Layer-0 features ``[n, D]`` from the device cache plus the shipped
    miss rows: row r is ``cache_values[s]`` when ``s = src_row[r] >= 0``,
    else ``miss_feats[-1 - s]``, widened to f32 and, for the int8 tier,
    multiplied by ``scale`` f32 ``[D]``; written as ``out_dtype``, f32 or
    bf16 (that f32 value rounded to nearest even).  ``cache_values`` and
    ``miss_feats`` share one row dtype: f32, bf16 or int8 (which needs the
    scale; the others take none)."""
    if cache_values.dtype not in ASSEMBLE_TIERS:
        raise TypeError(f"cache_values must be one of {list(ASSEMBLE_TIERS)}, "
                        f"got {cache_values.dtype}")
    if out_dtype not in ASSEMBLE_OUT:
        raise TypeError(f"out_dtype must be one of {list(ASSEMBLE_OUT)}, got {out_dtype}")
    tier, key, unit = ASSEMBLE_TIERS[cache_values.dtype]
    if (scale is not None) != (cache_values.dtype == torch.int8):
        raise ValueError("the int8 tier needs a scale; the f32 and bf16 tiers take none")
    tables = [cache_values, src_row, miss_feats] + ([] if scale is None else [scale])
    if not _use_kernel(*tables):
        return assemble_plain(cache_values, src_row, miss_feats, scale, out_dtype)
    _check(cache_values, "cache_values", cache_values.dtype, 2)
    _check(miss_feats, "miss_feats", cache_values.dtype, 2)
    _check(src_row, "src_row", torch.int32, 1)
    n, d = src_row.shape[0], cache_values.shape[1]
    if miss_feats.shape[1] != d:
        raise ValueError(f"miss_feats width {miss_feats.shape[1]} != cache width {d}")
    if scale is not None:
        _check(scale, "scale", torch.float32, 1)
        if scale.shape[0] != d:
            raise ValueError(f"scale has {scale.shape[0]} columns, the cache {d}")
    # the kernel writes rows in groups of ASSEMBLE_ROWS: pad, and return a view
    out = torch.empty((-(-n // ASSEMBLE_ROWS) * ASSEMBLE_ROWS, d), dtype=out_dtype,
                      device=cache_values.device)
    if n and d:
        vec = int(d % 4 == 0 and cache_values.data_ptr() % unit == 0
                  and miss_feats.data_ptr() % unit == 0
                  and out.data_ptr() % (4 * out.element_size()) == 0
                  and (scale is None or scale.data_ptr() % 16 == 0))
        _raise_on(_lib().pg_assemble(
            cache_values.data_ptr(), _ptr(miss_feats) if miss_feats.numel() else None,
            src_row.data_ptr(), _ptr(scale), out.data_ptr(), n, d, tier, vec,
            int(out_dtype == torch.bfloat16), _stream(out.device)), "pg_assemble")
        LAUNCHES[key + ASSEMBLE_OUT[out_dtype]] += 1
    return out[:n]


def gather_reduce(src: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                  kind: str = "mean") -> torch.Tensor:
    """``out[n] = sum_k mask[n,k] * src[pos[n,k]]``, divided by
    ``max(sum_k mask[n,k], 1)`` for ``kind="mean"``.  Masked slots are
    never loaded.  ``src`` f32 or bf16 ``[S, D]``, the output at its dtype;
    ``pos`` int32 and ``mask`` bool ``[N, fanout]`` (on the card, the block
    forward kernel with its self half absent)."""
    _check_kind(kind)
    _row_dtype(src)
    if not _use_kernel(src, pos, mask):
        return gather_reduce_plain(src, pos, mask, kind)
    return _block_fwd_kernel("gather_reduce_" + kind, src, None, pos, mask, kind)[1]


def _block_bwd_kernel(key: str, g_self, self_pos, g_neigh, pos, mask,
                      num_src: int, kind: str) -> torch.Tensor:
    """Check the halves that are present, allocate the table with
    ``torch.empty`` at the gradients' dtype (and, for bf16, the f32 table the
    kernel adds into) and run ``pg_block_gather_bwd`` (memset + one launch,
    counted under ``LAUNCHES[key]``; for bf16 gradients under ``key_bf16``,
    and the rounding launch under ``grad_to_bf16``)."""
    tables = [t for t in (g_self, g_neigh) if t is not None]
    dtype = tables[0].dtype
    n_self = n_neigh = fanout = 0
    if g_self is not None:
        _check(g_self, "g_self", dtype, 2)
        _check(self_pos, "self_pos", torch.int32, 1)
        n_self = self_pos.shape[0]
        if g_self.shape[0] != n_self:
            raise ValueError(f"g_self has {g_self.shape[0]} rows, self_pos {n_self}")
    if g_neigh is not None:
        _check(g_neigh, "g_neigh", dtype, 2)
        _check_reduce(pos, mask, kind)
        n_neigh, fanout = pos.shape
        if g_neigh.shape[0] != n_neigh:
            raise ValueError(f"g_neigh has {g_neigh.shape[0]} rows, pos {n_neigh}")
    d = tables[0].shape[1]
    if any(t.shape[1] != d for t in tables):
        raise ValueError(f"incoming gradients of widths {[t.shape[1] for t in tables]}")
    dev = tables[0].device
    if not (n_self or n_neigh) or not d:
        return torch.zeros((num_src, d), dtype=dtype, device=dev)
    out = torch.empty((num_src, d), dtype=dtype, device=dev)
    acc = out if dtype == torch.float32 else torch.empty(
        (num_src, d), dtype=torch.float32, device=dev)
    _raise_on(_lib().pg_block_gather_bwd(
        _ptr(g_self), _ptr(self_pos), n_self, _ptr(g_neigh), _ptr(pos), _ptr(mask),
        n_neigh, fanout, out.data_ptr(), None if acc is out else acc.data_ptr(),
        num_src, d, int(kind == "mean"), _vec(d, *tables, acc), ELEMENT_CODES[dtype],
        _stream(dev)), "pg_block_gather_bwd")
    LAUNCHES[_key(key, dtype)] += 1
    if acc is not out:
        LAUNCHES["grad_to_bf16"] += 1
    return out


def block_gather_bwd(g_self, self_pos, g_neigh, pos, mask, num_src: int,
                     kind: str = "mean") -> torch.Tensor:
    """Backward of :class:`BlockGather` w.r.t. its source table: a
    ``[num_src, D]`` table with ``g_self[r]`` added at row ``self_pos[r]`` and,
    for each valid slot, ``g_neigh[r]`` (divided by the row's count for
    ``mean``) at row ``pos[r, k]``, at the gradients' dtype (f32 or bf16,
    the same for both; bf16 adds in f32 and rounds once).  A ``None``
    gradient is an absent half, whose indices are not read.  On the card:
    one memset and one launch (vector reductions on 4-element units when
    D % 4 == 0), and for bf16 one more launch that rounds the table."""
    _check_kind(kind)
    if g_self is None and g_neigh is None:
        raise ValueError("block_gather_bwd needs at least one incoming gradient")
    _row_dtype(g_self, g_neigh)
    present = ([g_self, self_pos] if g_self is not None else []) + (
        [g_neigh, pos, mask] if g_neigh is not None else [])
    if not _use_kernel(*present):
        return block_gather_bwd_plain(g_self, self_pos, g_neigh, pos, mask,
                                      num_src, kind)
    return _block_bwd_kernel("block_gather_bwd_" + kind, g_self, self_pos,
                             g_neigh, pos, mask, num_src, kind)


def scatter_add_rows(grad_out: torch.Tensor, ids: torch.Tensor,
                     num_src: int) -> torch.Tensor:
    """Backward of :func:`gather_rows`: a zeroed ``[num_src, D]`` table with
    ``grad_out[r]`` added at row ``ids[r]``, at ``grad_out``'s dtype (on the
    card, the block backward kernel with its neighbor half absent)."""
    _row_dtype(grad_out)
    if not _use_kernel(grad_out, ids):
        return scatter_add_rows_plain(grad_out, ids, num_src)
    return _block_bwd_kernel("scatter_add_rows", grad_out, ids, None, None, None,
                             num_src, "sum")


def gather_reduce_bwd(grad_out: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor, num_src: int,
                      kind: str = "mean") -> torch.Tensor:
    """Backward of :func:`gather_reduce`: for each valid slot,
    ``grad_src[pos[n,k]] += grad_out[n]`` (divided by the row's count for
    ``mean``), into a zeroed ``[num_src, D]`` table at ``grad_out``'s dtype
    (on the card, the block backward kernel with its self half absent)."""
    _check_kind(kind)
    _row_dtype(grad_out)
    if not _use_kernel(grad_out, pos, mask):
        return gather_reduce_bwd_plain(grad_out, pos, mask, num_src, kind)
    return _block_bwd_kernel("gather_reduce_bwd_" + kind, None, None, grad_out,
                             pos, mask, num_src, kind)


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


class BlockGather(torch.autograd.Function):
    """A block's two gathers of one source table, ``(src[self_pos],
    gather_reduce(src, pos, mask, kind))``, in one :func:`block_gather_fwd`
    launch on the card, whose gradient w.r.t. ``src`` is one
    :func:`block_gather_bwd`: one memset and one kernel launch, where the two
    Functions above take two launches forward, and two memsets, two launches
    and an add backward."""

    @staticmethod
    def forward(ctx, src, self_pos, pos, mask, kind):
        ctx.save_for_backward(self_pos, pos, mask)
        ctx.num_src = src.shape[0]
        ctx.kind = kind
        ctx.plain = _PLAIN_ON_CUDA.get()
        # an output that nothing uses arrives as None: its half is absent
        ctx.set_materialize_grads(False)
        return block_gather_fwd(src, self_pos, pos, mask, kind)

    @staticmethod
    def backward(ctx, g_self, g_neigh):
        self_pos, pos, mask = ctx.saved_tensors
        grad_src = None
        if ctx.needs_input_grad[0] and (g_self is not None or g_neigh is not None):
            with _mode(ctx.plain):
                grad_src = block_gather_bwd(
                    None if g_self is None else g_self.contiguous(), self_pos,
                    None if g_neigh is None else g_neigh.contiguous(), pos, mask,
                    ctx.num_src, ctx.kind)
        return grad_src, None, None, None, None
