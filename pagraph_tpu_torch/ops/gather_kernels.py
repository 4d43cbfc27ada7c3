"""Wrappers of the CUDA gather kernels, their plain PyTorch versions, the
autograd Functions that train through them, and the launch counters.

The port's counterpart of ``pagraph_tpu/ops/pallas_gather.py``:

=====================  ===============================================  ==========================
wrapper                computes                                         replaces
=====================  ===============================================  ==========================
``block_gather_fwd``   both halves below from one table                 K1 + K2
``gather_rows``        ``out[r] = src[ids[r]]``                         ``gather_rows_pallas`` (K1)
``gather_reduce``      masked ``mean``/``sum``/``max`` of               ``gather_mean_pallas`` (K2)
                       ``src[pos[n, k]]`` (also device inference's
                       window reduction, ``models/inference.py``)
``assemble``           ``cache_values[s]`` if ``s = src_row[r] >= 0``,  ``gather_rows_pallas`` (K1)
                       else ``miss_feats[-1 - s]``; as f32 (int8:       + ``assemble_features``
                       times a per-column scale), or that cast to bf16  + ``dequantize_fused``
``block_gather_bwd``   both halves below into one table                 backward of K1 + K2
``scatter_add_rows``   ``grad_src[ids[r]] += grad_out[r]``              backward of K1
``gather_reduce_bwd``  ``grad_src[pos[n,k]] += grad_out[n] (/count)``   backward of K2
                       (max: ``/ ties`` at the tied maxima)
``dropout_block_fwd``  dropout, then a prefix-layout block's self rows  none: XLA's elementwise
                       and masked ``mean``/``sum`` (no gather)          passes in the JAX package
``dropout_block_bwd``  its gradient, each source row written once       their autograd
``dropout_bits``       the packed keep-mask of a dropout draw: bit li   none: ``jax.random``'s
                       set iff unit li of ``torch.randint``'s int16     bits in XLA
                       draw from the generator is kept
``gat_attention_fwd``  GAT's masked softmax over a prefix-layout        none: XLA's einsums and
                       block's self edge and slots, and the weighted    softmax in the JAX
                       sum of ``z`` (reading each row once)             package
``gat_attention_bwd``  its gradient, each row of ``z`` written once,    their autograd
                       and those of the two attention vectors
=====================  ===============================================  ==========================

The ``max`` kind (the pool aggregator's; XLA in the JAX package,
``pagraph_tpu/ops/aggregate.py:62-64``) is the per-column max over the valid
slots, 0 for a row with none.  Its backward splits each output gradient
equally among the valid slots that reach the max, as JAX's gradient of
``jnp.max`` and torch's of ``amax`` do, so it reads the source table too:
:func:`block_gather_bwd` and :func:`gather_reduce_bwd` take ``src`` for it.

The forwards of a block's gathers are one kernel, ``pg_block_gather_fwd``:
``block_gather_fwd`` runs it with both halves (the forward of
:class:`BlockGather`, the main path's), ``gather_rows`` and ``gather_reduce``
with one half absent; the neighbor half alone at a fan-out with no
unrolled instantiation (:data:`UNROLLED_FANOUTS`: device inference's
windows of 32 to 4096 slots) runs the window kernel, ``pg_window_reduce``,
instead (:func:`window_plan`).  The backwards of both halves are one kernel,
``pg_block_gather_bwd`` (a memset of the gradient table and one launch, in
one C call), run the same way by ``block_gather_bwd`` and
``gather_reduce_bwd``; ``scatter_add_rows`` has a kernel of its own,
``pg_scatter_add_rows``: one cooperative launch that zeroes its table
(:func:`scatter_grid`).  A train step launches 4 kernels: the assembly,
one block forward for each block, and one block backward for block 1 (the
layer-0 features need no gradient); 5 at bf16 compute (below).  The
assembly is one kernel, ``pg_assemble``, for the f32, bf16 and int8 cache
tiers (counted under ``assemble_f32``, ``assemble_bf16``,
``assemble_int8``).

Like the Pallas kernels, the block kernels compute at their table's dtype,
f32 or bf16 (``train.dtype="bfloat16"``): a bf16 table gives bf16 outputs
(the neighbor sum in f32 registers, rounded once) and a bf16 gradient table
(added in an f32 table, then rounded once: by a second launch in the same C
call, counted under ``grad_to_bf16``, for the block backward; inside its one
launch for ``scatter_add_rows``).  Every table of one call has one
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

The on-device sampler's prefix-layout blocks need no gather: a block's self
rows are its source's first ``n`` rows and destination ``r``'s messages the
``fanout`` rows from ``n + r * fanout``.  There the model's dropout and both
halves of the block are one kernel, ``pg_dropout_block_fwd``, which reads the
source and its packed keep-mask once and writes the ``[n, D]`` outputs, and
the gradient one more, ``pg_dropout_block_bwd``, a pure map that writes each
source row once (:class:`DropoutBlock`; counted under
``dropout_block_fwd_<kind>`` and ``dropout_block_bwd_<kind>``, ``_bf16`` for
bf16 rows).  The keep-mask (:func:`dropout_bits`: ``pg_dropout_bits``,
counted under ``dropout_bits``, its units in :data:`DRAWN_UNITS`) holds one
bit an element of the source, set iff that unit of one ``torch.randint`` of
int16 in [-32768, 32768) of the source's shape from the generator (the same
Philox draw as int32 in [0, 65536), moved down by 32768) is below ``thresh -
32768``; the kernel computes torch's Philox units itself and advances the
generator as far as torch would.  Under CUDA-graph capture it reads the
generator's seed and offset from a device word that the capturing
``train.state.CapturedGraph`` writes before each replay (:class:`GraphDraws`).
An on-device step launches the assembly, one keep-mask and one dropout block
forward a block, and one backward a block after the first (the layer-0
features take no gradient).

GAT's attention over a prefix-layout block is one kernel forward,
``pg_gat_attention_fwd``, a warp a destination row and head, which reads
the head's slice of the self row and of each valid slot's row of ``z``
once, computes both scores from them and the masked softmax in one pass,
and writes ``[n, K, H]`` with each row and head's max and denominator; and
one C call backward, ``pg_gat_attention_bwd`` (:class:`GatAttention`,
counted under ``gat_attention_fwd`` and ``gat_attention_bwd``), which
writes each row of ``z``'s gradient once and the two attention vectors'
gradients through per-CTA partials summed in a fixed order (a second
launch in the same call).  Float32 only: bf16 compute keeps the plain
chain.  An on-device GAT step launches the assembly and, for each block,
one attention forward and one backward (block 0's too: ``z`` depends on
``w``).

Phase marks (:func:`mark`): an empty kernel ``pg_mark_<phase>`` a phase of
a train step (:data:`MARK_PHASES`), launched where the phase starts, so
that a profiler's trace splits the step's kernels by phase, inside a
replayed CUDA graph too.  A graph captures its marks whatever the switch;
:class:`GraphMarks` finds their nodes once and enables them only for
traced replays.  They are not counted in :data:`LAUNCHES`.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import functools
import math
from typing import Dict, Iterator, NamedTuple, Optional, Sequence

import torch

KINDS = ("mean", "sum", "max")
# the reduction kinds -> the C kind code
KIND_CODES = {"sum": 0, "mean": 1, "max": 2}

# the block kernels' row dtypes -> the C element type code
ELEMENT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the assembly's output dtypes -> the LAUNCHES key's suffix
ASSEMBLE_OUT = {torch.float32: "", torch.bfloat16: "_to_bf16"}

# the kinds the fused dropout block reduces with
DROPOUT_BLOCK_KINDS = ("mean", "sum")

_BLOCK_KEYS = ("gather_rows", "scatter_add_rows",
               *(f"{base}_{kind}" for base in ("block_gather_fwd", "block_gather_bwd",
                                               "gather_reduce", "gather_reduce_bwd")
                 for kind in KINDS),
               *(f"dropout_block_{way}_{kind}" for way in ("fwd", "bwd")
                 for kind in DROPOUT_BLOCK_KINDS))

LAUNCHES: Dict[str, int] = {
    **{k + sfx: 0 for sfx in ("", "_bf16") for k in _BLOCK_KEYS},
    **{f"assemble_{tier}{sfx}": 0 for sfx in ASSEMBLE_OUT.values()
       for tier in ("f32", "bf16", "int8")},
    "grad_to_bf16": 0,
    "gat_attention_fwd": 0,
    "gat_attention_bwd": 0,
    "dropout_bits": 0,
}
# the units each kernel that draws has drawn, counted as LAUNCHES counts its
# launches (a captured draw once, at capture)
DRAWN_UNITS: Dict[str, int] = {"dropout_bits": 0}

_PLAIN_ON_CUDA = contextvars.ContextVar("pagraph_plain_on_cuda", default=False)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, DRAWN_UNITS):
        for k in counts:
            counts[k] = 0


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


_NEG_FILL = -1e30      # the JAX package's masked-slot value for the max kind


def reduce_msgs_plain(msgs: torch.Tensor, mask: torch.Tensor,
                      kind: str) -> torch.Tensor:
    """Masked reduction of ``msgs [N, F, D]`` over the fan-out axis; rows
    with no valid slot get zeros (DGL's empty-mailbox default).  ``max`` is
    the JAX package's ``where(mask, msgs, -1e30)``, ``max``, ``where(count >
    0, m, 0)``, through ``amax``, whose gradient splits equally among ties
    as ``jnp.max``'s does."""
    if kind == "max":
        m = torch.where(mask[..., None], msgs, _NEG_FILL).amax(dim=1)
        return torch.where(mask.any(dim=1, keepdim=True), m, 0.0)
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
                           kind: str, src=None) -> torch.Tensor:
    """``scatter_add_rows_plain(g_self, self_pos) + gather_reduce_bwd_plain(
    g_neigh, pos, mask, num_src, kind, src)``, added into one zeroed f32
    table and returned at the gradients' dtype (bf16: rounded once); a
    ``None`` gradient is an absent half.  The max kind reads ``src``."""
    ref = g_self if g_self is not None else g_neigh
    out = torch.zeros((num_src, ref.shape[1]), dtype=torch.float32, device=ref.device)
    if g_self is not None:
        out.index_add_(0, self_pos.long(), g_self.float())
    if g_neigh is not None:
        g = g_neigh.float()
        if kind == "max":
            # g / ties at each valid slot that reaches its column's max, as
            # jnp.max's and amax's gradients split it
            msgs = src[pos.long()].float()
            valid = mask[..., None]
            tie = valid & (msgs == torch.where(valid, msgs, -torch.inf).amax(1, keepdim=True))
            contrib = torch.where(tie, g[:, None, :] / tie.sum(1, keepdim=True).clamp(min=1), 0.0)
            out.index_add_(0, pos.reshape(-1).long(), contrib.reshape(-1, g.shape[1]))
        else:
            g = g / _count(mask, g.dtype) if kind == "mean" else g
            rows, slots = mask.nonzero(as_tuple=True)
            out.index_add_(0, pos[rows, slots].long(), g[rows])
    return out.to(ref.dtype)


def pack_bits(kept: torch.Tensor) -> torch.Tensor:
    """A bool tensor's elements, in order, as one bit each: int32
    ``[ceil(numel / 32)]``, element ``li`` bit ``li % 32`` of word ``li //
    32`` (unset past the last element)."""
    flat = kept.reshape(-1)
    pad = -flat.numel() % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # made on the device: a copy from the host would break a CUDA-graph capture
    weights = torch.ones(8, dtype=torch.uint8, device=flat.device) << torch.arange(
        8, dtype=torch.uint8, device=flat.device)
    return (flat.view(-1, 8).to(torch.uint8) * weights).sum(1, dtype=torch.uint8).view(
        torch.int32)


def unpack_bits(words: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """The bool tensor of ``shape`` that :func:`pack_bits` packed into
    ``words``."""
    n = math.prod(shape)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words.view(torch.uint8)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n].view(*shape).bool()


def dropout_bits_plain(shape: Sequence[int], thresh: int, generator: torch.Generator,
                       device) -> torch.Tensor:
    """:func:`dropout_bits` in torch: one ``torch.randint`` of int16 in
    [-32768, 32768) of ``shape`` from ``generator``, each unit kept iff it is
    below ``thresh - 32768``, packed by :func:`pack_bits`."""
    bits = torch.randint(-(1 << 15), 1 << 15, tuple(shape), generator=generator,
                         device=device, dtype=torch.int16)
    return pack_bits(bits < thresh - (1 << 15))


def dropout_block_fwd_plain(x, keep, inv_keep: float, mask, with_self: bool, kind: str):
    """``(drop(x)[:n], reduce_msgs_plain(drop(x)[n:n + n * f], mask, kind))``
    with ``drop(x) = where(kept, x * inv_keep, 0)``, ``kept`` the packed
    keep-mask ``keep`` unpacked to ``x``'s shape (``keep`` ``None``: ``x``),
    and ``n, f = mask.shape``: the model's dropout followed by a
    prefix-layout block's two halves, op for op; the first output is
    ``None`` unless ``with_self``."""
    n, f = mask.shape
    xd = x if keep is None else torch.where(unpack_bits(keep, x.shape), x * inv_keep, 0.0)
    neigh = reduce_msgs_plain(xd[n:n + n * f].reshape(n, f, *x.shape[1:]), mask, kind)
    return (xd[:n] if with_self else None), neigh


def dropout_block_bwd_plain(g_self, g_neigh, keep, inv_keep: float, mask, num_src: int,
                            kind: str) -> torch.Tensor:
    """The gradient of :func:`dropout_block_fwd_plain` w.r.t. ``x`` ``[num_src,
    D]`` as autograd computes it: ``g_self`` on rows ``[0, n)``, ``g_neigh``
    (divided by the row's count for ``mean``) on each valid message row, zero
    elsewhere, then ``where(kept, ., 0) * inv_keep``.  A ``None`` gradient
    is zero."""
    n, f = mask.shape
    ref = g_self if g_self is not None else g_neigh
    d = ref.shape[1]
    zeros = functools.partial(torch.zeros, dtype=ref.dtype, device=ref.device)
    if g_neigh is None:
        msgs = zeros((n * f, d))
    else:
        g = g_neigh / _count(mask, g_neigh.dtype) if kind == "mean" else g_neigh
        msgs = torch.where(mask[..., None], g[:, None, :], 0.0).reshape(n * f, d)
    g = torch.cat([zeros((n, d)) if g_self is None else g_self, msgs,
                   zeros((num_src - n * (1 + f), d))])
    return g if keep is None else torch.where(unpack_bits(keep, g.shape), g, 0.0) * inv_keep


def scatter_add_rows_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                           num_src: int) -> torch.Tensor:
    return block_gather_bwd_plain(grad_out, ids, None, None, None, num_src, "sum")


def gather_reduce_bwd_plain(grad_out, pos, mask, num_src: int,
                            kind: str, src=None) -> torch.Tensor:
    return block_gather_bwd_plain(None, None, grad_out, pos, mask, num_src, kind, src)


GAT_SLOPE = 0.2         # LeakyReLU's slope on GAT's attention logits
_GAT_NEG = -1e30        # a masked slot's logit: its exp is exactly 0 in f32 and bf16


def gat_softmax_plain(z_self, z_neigh, as_dst, an_dst, an_nbr, mask):
    """GAT's two-part stable softmax and weighted sum (the JAX package's):
    ``z_self [n, K, H]``, ``z_neigh [n, F, K, H]``, the destinations' two
    scores ``as_dst``, ``an_dst [n, K]``, the slots' ``an_nbr [n, F, K]``,
    ``mask [n, F]``.  The self edge stays out of the ``[n, F, K]`` tensors,
    masked slots hold ``-1e30``.  ``(out [n, K, H], max [n, K], denominator
    [n, K])``."""
    e_n = torch.nn.functional.leaky_relu(as_dst[:, None, :] + an_nbr, GAT_SLOPE)
    e_s = torch.nn.functional.leaky_relu(as_dst + an_dst, GAT_SLOPE)
    e_n = torch.where(mask[..., None], e_n, _GAT_NEG)
    m = torch.maximum(e_n.amax(dim=1), e_s)              # [n, K]
    w_n = torch.exp(e_n - m[:, None, :])
    w_s = torch.exp(e_s - m)
    denom = w_n.sum(dim=1) + w_s
    alpha_n = w_n / denom[:, None, :]
    alpha_s = w_s / denom
    out = torch.einsum("nfk,nfkh->nkh", alpha_n, z_neigh) + alpha_s[..., None] * z_self
    return out, m, denom


def _gat_split(z, heads: int, hd: int, n: int, f: int):
    """``(z3 [S, K, H], its self rows [n, K, H], its slot rows [n, F, K, H])``
    of a prefix-layout block's ``z``."""
    z3 = z.unflatten(1, (heads, hd))
    return z3, z3[:n], z3[n:n + n * f].unflatten(0, (n, f))


def gat_attention_fwd_plain(z, a_s, a_n, mask):
    """GAT's attention over a prefix-layout block as ``models/gat.py`` chains
    it, op for op: both scores of every row of ``z [S, K*H]`` (``a_s``,
    ``a_n`` ``[K, H]``), then :func:`gat_softmax_plain` over the self rows
    ``[0, n)`` and the slots ``n + r * F + k`` (``n, F = mask.shape``).
    ``(out [n, K, H], stats [2, n, K])``: ``stats`` the max and the
    denominator."""
    heads, hd = a_s.shape
    n, f = mask.shape
    z3, z_self, z_neigh = _gat_split(z, heads, hd, n, f)
    att_s = torch.einsum("nkh,kh->nk", z3, a_s)
    att_n = torch.einsum("nkh,kh->nk", z3, a_n)
    out, m, denom = gat_softmax_plain(z_self, z_neigh, att_s[:n], att_n[:n],
                                      att_n[n:n + n * f].unflatten(0, (n, f)), mask)
    return out, torch.stack([m, denom])


def gat_attention_bwd_plain(g, z, a_s, a_n, mask, out, stats, num_src: int):
    """The gradient of :func:`gat_attention_fwd_plain` from ``g [n, K, H]``,
    its ``out`` and ``stats``, by the kernel's formulas: ``alpha = exp(e -
    max) / den``, ``S = g . out``, for each edge ``dpre = alpha (g . z_j -
    S) lrelu'(pre)``, ``dz_j = alpha g + dpre a_n``, ``dz_r = alpha_self g
    + sum(dpre) a_s + dpre_self a_n``, zero on masked slots and on rows past
    ``n * (1 + F)``.  ``(dz [num_src, K*H], d a_s, d a_n)``."""
    heads, hd = a_s.shape
    n, f = mask.shape
    _, zs, zn = _gat_split(z, heads, hd, n, f)
    m, den = stats[0], stats[1]

    def lrelu(x):
        return torch.where(x > 0, x, GAT_SLOPE * x)

    def slope(x):
        return torch.where(x > 0, torch.ones_like(x), torch.full_like(x, GAT_SLOPE))

    s = torch.einsum("nkh,kh->nk", zs, a_s)
    pre_s = s + torch.einsum("nkh,kh->nk", zs, a_n)
    pre_n = s[:, None, :] + torch.einsum("nfkh,kh->nfk", zn, a_n)
    big_s = (g * out).sum(-1)                                    # [n, K]
    al_s = torch.exp(lrelu(pre_s) - m) / den
    al_n = torch.where(mask[..., None], torch.exp(lrelu(pre_n) - m[:, None]) / den[:, None],
                       0.0)
    dp_s = al_s * ((g * zs).sum(-1) - big_s) * slope(pre_s)
    dp_n = al_n * (torch.einsum("nkh,nfkh->nfk", g, zn) - big_s[:, None]) * slope(pre_n)
    dsum = dp_s + dp_n.sum(1)
    dz_s = al_s[..., None] * g + dsum[..., None] * a_s + dp_s[..., None] * a_n
    dz_n = al_n[..., None] * g[:, None] + dp_n[..., None] * a_n
    dz = torch.cat([dz_s.flatten(1), dz_n.reshape(n * f, heads * hd),
                    z.new_zeros((num_src - n * (1 + f), heads * hd))])
    da_s = torch.einsum("nk,nkh->kh", dsum, zs)
    da_n = torch.einsum("nk,nkh->kh", dp_s, zs) + torch.einsum("nfk,nfkh->kh", dp_n, zn)
    return dz, da_s, da_n


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
    table); an absent half (``None`` index) returns ``None``.  The neighbor
    half alone at a fan-out outside :data:`UNROLLED_FANOUTS` runs the
    window kernel instead (:func:`window_plan`)."""
    if self_pos is None and pos is not None and pos.dim() == 2 \
            and pos.shape[1] not in UNROLLED_FANOUTS:
        return None, _window_kernel(key, src, pos, mask, kind)
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
            fanout, _ptr(out_self), _ptr(out_neigh), d, KIND_CODES[kind],
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


# fan-outs with an unrolled instantiation of the block kernels
# (PG_FANOUT_SWITCH in csrc/gather_kernels.cu)
UNROLLED_FANOUTS = (1, 2, 3, 4, 5, 8, 10, 15, 16, 20, 25)
THREADS, WARPS = 256, 8          # a CTA of the block kernels (kThreads)
WINDOW_TILE = 4096               # slots of indices a window CTA stages (kWinTile)
WINDOW_CTA_FANOUT = 512          # from this fan-out a window row takes a whole CTA


class WindowPlan(NamedTuple):
    """The window kernel's geometry: ``1 << warps_log2`` warps a row
    (``WARPS >> warps_log2`` rows a CTA), ``1 << lanes_log2`` lanes a worker,
    ``tile`` slots a row staged in shared memory at a time, ``grid`` CTAs,
    ``smem`` bytes of dynamic shared memory."""
    warps_log2: int
    lanes_log2: int
    tile: int
    grid: int
    smem: int

    @property
    def rows_per_cta(self) -> int:
        return WARPS >> self.warps_log2

    @property
    def workers(self) -> int:
        """Workers (groups of lanes) that share one row's slots."""
        return (1 << self.warps_log2) << (5 - self.lanes_log2)


def window_plan(rows: int, fanout: int, d: int, vec: bool) -> Optional[WindowPlan]:
    """How :func:`gather_reduce` runs ``rows`` windows of ``fanout`` slots
    of ``d``-column rows on the card (``vec``: 4-column units): ``None`` for
    a fan-out with an unrolled instantiation (the block forward kernel),
    else the window kernel's :class:`WindowPlan`.  From
    :data:`WINDOW_CTA_FANOUT` slots a row takes the CTA's 8 warps, below it
    one warp; a worker is the smallest power of two of lanes covering the
    row's units, at most a warp.  A pure function of its arguments (the
    element type does not change it: the partials take 16 bytes a thread)."""
    if fanout in UNROLLED_FANOUTS:
        return None
    wlg = 3 if fanout >= WINDOW_CTA_FANOUT else 0
    units = d // 4 if vec else d
    lg = 0
    while (1 << lg) < units and lg < 5:
        lg += 1
    per_cta = WARPS >> wlg
    tile = max(1, min(fanout, WINDOW_TILE // per_cta))
    stride = -(-tile // 16) * 16
    # window_smem_bytes: the mbarrier, positions and mask bytes, partials, counts
    smem = 16 + 5 * per_cta * stride + THREADS * 16 + WARPS * 4
    return WindowPlan(wlg, lg, tile, -(-rows // per_cta), smem)


# CTAs a SM of the cooperative scatter kernel (at most what a SM holds of it)
SCATTER_CTAS_PER_SM = 1


def scatter_grid(n_ids: int, num_src: int, d: int, vec: bool, sms: int = 132) -> int:
    """CTAs of :func:`scatter_add_rows`'s cooperative launch for ``n_ids``
    gradient rows into a ``[num_src, d]`` table (``vec``: 4-column units) on
    a card of ``sms`` SMs: a thread a unit of the larger of the two, at most
    :data:`SCATTER_CTAS_PER_SM` a SM (all must be resident at once), at
    least one.  A pure function of its arguments; the element type does not
    change it."""
    units = d // 4 if vec else d
    work = max(n_ids, num_src) * units
    return max(1, min(SCATTER_CTAS_PER_SM * sms, -(-work // THREADS)))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _window_kernel(key: str, src, pos, mask, kind: str) -> torch.Tensor:
    """Check, allocate the output with ``torch.empty`` and run
    ``pg_window_reduce`` (one launch) by :func:`window_plan`, counted under
    ``LAUNCHES[key]`` (``key_bf16`` for a bf16 table)."""
    _check(src, "src", src.dtype, 2)
    _check_reduce(pos, mask, kind)
    rows, fanout = pos.shape
    d = src.shape[1]
    out = torch.empty((rows, d), dtype=src.dtype, device=src.device)
    if rows and d:
        vec = _vec(d, src, out)
        plan = window_plan(rows, fanout, d, bool(vec))
        _raise_on(_lib().pg_window_reduce(
            src.data_ptr(), pos.data_ptr(), mask.data_ptr(), rows, fanout, out.data_ptr(), d,
            KIND_CODES[kind], vec, ELEMENT_CODES[src.dtype], plan.warps_log2,
            plan.lanes_log2, plan.tile, plan.smem, _stream(src.device)), "pg_window_reduce")
        LAUNCHES[_key(key, src.dtype)] += 1
    return out


def gather_reduce(src: torch.Tensor, pos: torch.Tensor, mask: torch.Tensor,
                  kind: str = "mean") -> torch.Tensor:
    """``out[n] = sum_k mask[n,k] * src[pos[n,k]]``, divided by
    ``max(sum_k mask[n,k], 1)`` for ``kind="mean"``; for ``"max"`` the
    per-column max over the valid slots (0 for a row with none).  Masked
    slots are never loaded.  ``src`` f32 or bf16 ``[S, D]``, the output at
    its dtype; ``pos`` int32 and ``mask`` bool ``[N, fanout]``.  On the
    card: the block forward kernel with its self half absent at a fan-out
    in :data:`UNROLLED_FANOUTS`, else the window kernel
    (:func:`window_plan`), one launch either way."""
    _check_kind(kind)
    _row_dtype(src)
    if not _use_kernel(src, pos, mask):
        return gather_reduce_plain(src, pos, mask, kind)
    return _block_fwd_kernel("gather_reduce_" + kind, src, None, pos, mask, kind)[1]


def _block_bwd_kernel(key: str, g_self, self_pos, g_neigh, pos, mask,
                      num_src: int, kind: str, src=None) -> torch.Tensor:
    """Check the halves that are present, allocate the table with
    ``torch.empty`` at the gradients' dtype (and, for bf16, the f32 table the
    kernel adds into) and run ``pg_block_gather_bwd`` (memset + one launch,
    counted under ``LAUNCHES[key]``; for bf16 gradients under ``key_bf16``,
    and the rounding launch under ``grad_to_bf16``).  The max kind's
    neighbor half reads ``src`` ``[num_src, D]``."""
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
    reads_src = g_neigh is not None and kind == "max"
    if reads_src:
        _check(src, "src", dtype, 2)
        if tuple(src.shape) != (num_src, d):
            raise ValueError(f"src {tuple(src.shape)} is not [{num_src}, {d}]")
    dev = tables[0].device
    if not (n_self or n_neigh) or not d:
        return torch.zeros((num_src, d), dtype=dtype, device=dev)
    out = torch.empty((num_src, d), dtype=dtype, device=dev)
    acc = out if dtype == torch.float32 else torch.empty(
        (num_src, d), dtype=torch.float32, device=dev)
    _raise_on(_lib().pg_block_gather_bwd(
        _ptr(src) if reads_src else None, _ptr(g_self), _ptr(self_pos), n_self,
        _ptr(g_neigh), _ptr(pos), _ptr(mask), n_neigh, fanout, out.data_ptr(),
        None if acc is out else acc.data_ptr(), num_src, d, KIND_CODES[kind],
        _vec(d, *tables, acc, *([src] if reads_src else [])), ELEMENT_CODES[dtype],
        _stream(dev)), "pg_block_gather_bwd")
    LAUNCHES[_key(key, dtype)] += 1
    if acc is not out:
        LAUNCHES["grad_to_bf16"] += 1
    return out


def block_gather_bwd(g_self, self_pos, g_neigh, pos, mask, num_src: int,
                     kind: str = "mean", src=None) -> torch.Tensor:
    """Backward of :class:`BlockGather` w.r.t. its source table: a
    ``[num_src, D]`` table with ``g_self[r]`` added at row ``self_pos[r]`` and,
    for each valid slot, ``g_neigh[r]`` (divided by the row's count for
    ``mean``; for ``max``, divided by the row's ties and added only at the
    slots that reach the max, read from ``src``, the forward's table) at
    row ``pos[r, k]``, at the gradients' dtype (f32 or bf16, the same for
    both and for ``src``; bf16 adds in f32 and rounds once).  A ``None``
    gradient is an absent half, whose indices are not read.  On the card:
    one memset and one launch (vector reductions on 4-element units when
    D % 4 == 0), and for bf16 one more launch that rounds the table."""
    _check_kind(kind)
    if g_self is None and g_neigh is None:
        raise ValueError("block_gather_bwd needs at least one incoming gradient")
    reads_src = g_neigh is not None and kind == "max"
    if reads_src and src is None:
        raise ValueError("the max kind's backward needs the source table src")
    _row_dtype(g_self, g_neigh, src if reads_src else None)
    present = ([g_self, self_pos] if g_self is not None else []) + (
        [g_neigh, pos, mask] if g_neigh is not None else []) + ([src] if reads_src else [])
    if not _use_kernel(*present):
        return block_gather_bwd_plain(g_self, self_pos, g_neigh, pos, mask,
                                      num_src, kind, src)
    return _block_bwd_kernel("block_gather_bwd_" + kind, g_self, self_pos,
                             g_neigh, pos, mask, num_src, kind, src)


def scatter_add_rows(grad_out: torch.Tensor, ids: torch.Tensor,
                     num_src: int) -> torch.Tensor:
    """Backward of :func:`gather_rows`: a zeroed ``[num_src, D]`` table with
    ``grad_out[r]`` added at row ``ids[r]``, at ``grad_out``'s dtype (bf16:
    summed in an f32 scratch table, rounded once).  On the card: one
    cooperative launch of the scatter kernel (:func:`scatter_grid` CTAs),
    which zeroes the table itself, so no memset and no second launch at bf16;
    counted under ``LAUNCHES["scatter_add_rows"]`` (``_bf16``)."""
    _row_dtype(grad_out)
    if not _use_kernel(grad_out, ids):
        return scatter_add_rows_plain(grad_out, ids, num_src)
    _check(grad_out, "grad_out", grad_out.dtype, 2)
    _check(ids, "ids", torch.int32, 1)
    n, d = ids.shape[0], grad_out.shape[1]
    if grad_out.shape[0] != n:
        raise ValueError(f"grad_out has {grad_out.shape[0]} rows, ids {n}")
    dev = grad_out.device
    out = torch.empty((num_src, d), dtype=grad_out.dtype, device=dev)
    if num_src and d:
        acc = None if grad_out.dtype == torch.float32 else torch.empty(
            (num_src, d), dtype=torch.float32, device=dev)
        vec = _vec(d, grad_out, out, *([] if acc is None else [acc]))
        _raise_on(_lib().pg_scatter_add_rows(
            grad_out.data_ptr(), ids.data_ptr(), n, out.data_ptr(), _ptr(acc), num_src, d,
            vec, ELEMENT_CODES[grad_out.dtype],
            scatter_grid(n, num_src, d, bool(vec), _sm_count(dev)), _stream(dev)),
            "pg_scatter_add_rows")
        LAUNCHES[_key("scatter_add_rows", grad_out.dtype)] += 1
    return out


def gather_reduce_bwd(grad_out: torch.Tensor, pos: torch.Tensor,
                      mask: torch.Tensor, num_src: int,
                      kind: str = "mean", src=None) -> torch.Tensor:
    """Backward of :func:`gather_reduce`: for each valid slot,
    ``grad_src[pos[n,k]] += grad_out[n]`` (divided by the row's count for
    ``mean``; for ``max`` by its ties, at the tied slots of ``src``), into a
    zeroed ``[num_src, D]`` table at ``grad_out``'s dtype (on the card, the
    block backward kernel with its self half absent)."""
    if kind == "max" and src is None:
        raise ValueError("the max kind's backward needs the source table src")
    _check_kind(kind)
    _row_dtype(grad_out, src)
    if not _use_kernel(grad_out, pos, mask, *([src] if src is not None else [])):
        return gather_reduce_bwd_plain(grad_out, pos, mask, num_src, kind, src)
    return _block_bwd_kernel("gather_reduce_bwd_" + kind, None, None, grad_out,
                             pos, mask, num_src, kind, src)


def _unit(d: int, *tables: torch.Tensor) -> int:
    """The widest unit, 4, 2 or 1 elements, that divides ``d`` and to which
    every table's base is aligned."""
    for u in (4, 2):
        if d % u == 0 and all(t.data_ptr() % (u * t.element_size()) == 0 for t in tables):
            return u
    return 1


def _check_dropout_block(shape, keep, mask, kind: str) -> None:
    """``shape``: the block's source ``[S, D]``, which holds its ``n x (1 +
    f)`` rows; ``keep`` (if any) its packed keep-mask, int32 ``[ceil(S * D /
    32)]``."""
    if kind not in DROPOUT_BLOCK_KINDS:
        raise ValueError(f"the dropout block's kind must be one of {DROPOUT_BLOCK_KINDS}, "
                         f"got {kind!r}")
    _check(mask, "mask", torch.bool, 2)
    n, f = mask.shape
    if len(shape) != 2 or shape[0] < n * (1 + f):
        raise ValueError(f"a source of shape {tuple(shape)} holds fewer than the block's "
                         f"{n} x (1 + {f}) rows")
    if keep is not None:
        _check(keep, "keep", torch.int32, 1)
        words = -(-math.prod(shape) // 32)
        if keep.shape[0] != words:
            raise ValueError(f"a keep-mask of {keep.shape[0]} words for a source of shape "
                             f"{tuple(shape)}, not {words}")


def dropout_block_fwd(x: torch.Tensor, keep: Optional[torch.Tensor], inv_keep: float,
                      mask: torch.Tensor, with_self: bool = True, kind: str = "mean"):
    """Dropout and a prefix-layout block's two halves from its source ``x``
    f32 or bf16 ``[S, D]`` (``S >= n * (1 + f)``, ``n, f = mask.shape``):
    ``(drop(x)[:n], masked kind over drop(x)[n + r * f + k])``, ``drop(x) =
    where(kept, x * inv_keep, 0)`` for ``keep`` the packed keep-mask of
    ``x``'s elements (:func:`dropout_bits`), or ``x`` for ``keep`` ``None``;
    the first output ``None`` unless ``with_self``.  On the card: one
    launch, the sum over a row's slots in f32 in slot order (bf16: the sum
    and the mean rounded as torch rounds them)."""
    _check_dropout_block(x.shape, keep, mask, kind)
    if not _use_kernel(x, mask, *([] if keep is None else [keep])):
        return dropout_block_fwd_plain(x, keep, inv_keep, mask, with_self, kind)
    dtype = _row_dtype(x)
    _check(x, "x", dtype, 2)
    n, f = mask.shape
    d = x.shape[1]
    out_self = torch.empty((n, d), dtype=dtype, device=x.device) if with_self else None
    out_neigh = torch.empty((n, d), dtype=dtype, device=x.device)
    if n and d:
        tables = [x, out_neigh] + ([out_self] if with_self else [])
        _raise_on(_lib().pg_dropout_block_fwd(
            x.data_ptr(), _ptr(keep), inv_keep, mask.data_ptr(), n, f, d, _ptr(out_self),
            out_neigh.data_ptr(), KIND_CODES[kind], _unit(d, *tables), ELEMENT_CODES[dtype],
            _stream(x.device)), "pg_dropout_block_fwd")
        LAUNCHES[_key("dropout_block_fwd_" + kind, dtype)] += 1
    return out_self, out_neigh


def dropout_block_bwd(g_self: Optional[torch.Tensor], g_neigh: Optional[torch.Tensor],
                      keep: Optional[torch.Tensor], inv_keep: float, mask: torch.Tensor,
                      num_src: int, kind: str = "mean") -> torch.Tensor:
    """Backward of :func:`dropout_block_fwd` w.r.t. ``x`` ``[num_src, D]``
    from ``g_self`` and ``g_neigh`` ``[n, D]`` (a ``None`` gradient is zero),
    at their dtype; on the card one launch that writes each row once (no
    memset, no atomics), with autograd's arithmetic over the plain version."""
    ref = g_self if g_self is not None else g_neigh
    if ref is None:
        raise ValueError("dropout_block_bwd needs at least one incoming gradient")
    _check_dropout_block((num_src, ref.shape[1]), keep, mask, kind)
    grads = [t for t in (g_self, g_neigh) if t is not None]
    if not _use_kernel(mask, *grads, *([] if keep is None else [keep])):
        return dropout_block_bwd_plain(g_self, g_neigh, keep, inv_keep, mask, num_src, kind)
    dtype = _row_dtype(*grads)
    n, f = mask.shape
    d = ref.shape[1]
    for t in grads:
        _check(t, "g", dtype, 2)
        if tuple(t.shape) != (n, d):
            raise ValueError(f"a gradient of shape {tuple(t.shape)}, not [{n}, {d}]")
    grad = torch.empty((num_src, d), dtype=dtype, device=ref.device)
    if num_src and d:
        _raise_on(_lib().pg_dropout_block_bwd(
            _ptr(g_self), _ptr(g_neigh), _ptr(keep), inv_keep, mask.data_ptr(), n, f, num_src,
            d, grad.data_ptr(), KIND_CODES[kind], _unit(d, grad, *grads), ELEMENT_CODES[dtype],
            _stream(ref.device)), "pg_dropout_block_bwd")
        LAUNCHES[_key("dropout_block_bwd_" + kind, dtype)] += 1
    return grad


# -- the dropout keep-mask -------------------------------------------------------

# torch's threads a block for a random draw, and the kernel's (ATen's
# DistributionTemplates.h block_size_bound)
DRAW_THREADS = 256
# Philox units a thread takes from one curand4 (ATen's curand4_engine_calls)
DRAW_UNROLL = 4
# the most units torch.randint draws as one int16 launch (32-bit indexing of
# its bytes); a larger draw is split, with other Philox counters
MAX_DRAW_UNITS = 1 << 30


def draw_grid(n: int, sms: int, max_threads_per_sm: int) -> int:
    """The blocks of ATen's launch for an ``n``-unit draw (``n`` > 0) on a
    card of ``sms`` SMs: ``min(ceil(n / 256), sms * max_threads_per_sm /
    256)`` (``calc_execution_policy``)."""
    return min(-(-n // DRAW_THREADS), sms * (max_threads_per_sm // DRAW_THREADS))


def draw_increment(n: int, grid: int) -> int:
    """How far an ``n``-unit draw of ``grid`` blocks advances the
    generator's Philox offset: 4 a counter each thread takes, 0 for no unit."""
    if n == 0:
        return 0
    return ((n - 1) // (DRAW_THREADS * grid * DRAW_UNROLL) + 1) * DRAW_UNROLL


@functools.lru_cache(maxsize=None)
def _draw_props(device: torch.device):
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.max_threads_per_multi_processor


class GraphDraws:
    """The keep-mask draws (:func:`dropout_bits`) that one captured CUDA
    graph makes from ``generator``.  ``state`` (int64 ``[2]`` on the
    generator's device) holds the generator's seed and Philox offset for a
    replay; each draw captured reads it and adds its own offset within the
    graph (``increment`` so far), as torch offsets the draws of a registered
    generator.  Around a replay :meth:`before_replay` writes the state on
    the current stream and :meth:`after_replay` advances the generator by
    ``increment``, what the eager draws would advance it.  A graph must not
    also hold torch's own draws from ``generator``: torch's offsets within
    the graph do not count these, so :meth:`after_replay` raises if torch
    moved the generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.state = torch.zeros(2, dtype=torch.int64, device=generator.device)
        self.increment = 0
        self.units = 0

    def add(self, n: int, increment: int) -> int:
        """Record a captured draw of ``n`` units; its offset in the graph."""
        offset = self.increment
        self.increment += increment
        self.units += n
        return offset

    def before_replay(self) -> Optional[int]:
        """The generator's offset for the replay that follows (``None``: no
        draw to feed), its seed and offset written into ``state``."""
        if not self.increment:
            return None
        seed, offset = self.generator.initial_seed(), self.generator.get_offset()
        dev = self.state.device
        _raise_on(_lib().pg_dropout_bits_state(self.state.data_ptr(), seed, offset,
                                               _stream(dev)), "pg_dropout_bits_state")
        return offset

    def after_replay(self, offset: Optional[int]) -> None:
        if offset is None:
            return
        if self.generator.get_offset() != offset:
            raise RuntimeError("a captured graph drew from the dropout generator through torch "
                               "beside dropout_bits: their Philox offsets overlap")
        self.generator.set_offset(offset + self.increment)


_GRAPH_DRAWS: contextvars.ContextVar = contextvars.ContextVar("pagraph_graph_draws",
                                                              default=None)


@contextlib.contextmanager
def capturing_draws(draws: Optional[GraphDraws]) -> Iterator[None]:
    """Inside this block, under capture, :func:`dropout_bits` records its
    draws in ``draws`` (the capturing graph's)."""
    token = _GRAPH_DRAWS.set(draws)
    try:
        yield
    finally:
        _GRAPH_DRAWS.reset(token)


def dropout_bits(shape: Sequence[int], thresh: int, generator: torch.Generator,
                 device) -> torch.Tensor:
    """The packed keep-mask of one dropout draw over a tensor of ``shape``:
    int32 ``[ceil(n / 32)]`` (``n`` its elements), bit ``li % 32`` of word
    ``li // 32`` set iff unit ``li`` of ``torch.randint(-32768, 32768, shape,
    generator=generator, dtype=torch.int16)`` is below ``thresh - 32768``
    (``thresh`` in 1..65535), with ``generator`` advanced as far as that
    call advances it.  On CPU tensors and under :func:`plain_versions` that
    call itself (:func:`dropout_bits_plain`); on the card one launch of
    ``pg_dropout_bits``, which computes the same Philox units, counted under
    ``LAUNCHES["dropout_bits"]`` and ``DRAWN_UNITS["dropout_bits"]``.  Under
    CUDA-graph capture the draw reads the generator's state at each replay,
    which needs the capture to be a ``train.state.CapturedGraph`` registered
    with ``generator``."""
    device = torch.device(device)
    if device.type == "cpu" or (device.type == "cuda" and _PLAIN_ON_CUDA.get()):
        return dropout_bits_plain(shape, thresh, generator, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not 0 < thresh < 1 << 16:
        raise ValueError(f"thresh must be in 1..65535, got {thresh}")
    n = math.prod(shape)
    if n > MAX_DRAW_UNITS:
        raise ValueError(f"a draw of {n} units: torch.randint splits draws of more than "
                         f"{MAX_DRAW_UNITS} int16 units, so dropout_bits takes none")
    keep = torch.empty(-(-n // 32), dtype=torch.int32, device=device)
    if n == 0:
        return keep
    sms, threads = _draw_props(device)
    grid = draw_grid(n, sms, threads)
    inc = draw_increment(n, grid)
    state, seed = None, 0
    if torch.cuda.is_current_stream_capturing():
        draws = _GRAPH_DRAWS.get()
        if draws is None or draws.generator is not generator:
            raise RuntimeError("dropout_bits under CUDA-graph capture needs a "
                               "train.state.CapturedGraph registered with its generator")
        offset = draws.add(n, inc)
        state = draws.state.data_ptr()
    else:
        seed, offset = generator.initial_seed(), generator.get_offset()
        generator.set_offset(offset + inc)
    _raise_on(_lib().pg_dropout_bits(keep.data_ptr(), n, thresh, state, seed, offset, grid,
                                     sms, _stream(device)), "pg_dropout_bits")
    LAUNCHES["dropout_bits"] += 1
    DRAWN_UNITS["dropout_bits"] += n
    return keep


# the backward's CTAs a head and SM: its warps walk the head's rows with a
# stride, so few CTAs keep few partials of the attention vectors' gradients
GAT_BWD_CTAS_PER_SM = 2
# the widest head the kernels take, in units (a lane holds at most 4 of a head)
GAT_MAX_UNITS = 4 * 32


def _check_gat(z, a_s, a_n, mask) -> None:
    _check(mask, "mask", torch.bool, 2)
    if a_s.dim() != 2 or a_s.shape != a_n.shape:
        raise ValueError(f"a_s {tuple(a_s.shape)} and a_n {tuple(a_n.shape)} must be one "
                         "[heads, head_dim] shape")
    n, f = mask.shape
    if z.dim() != 2 or z.shape[1] != a_s.numel() or z.shape[0] < n * (1 + f):
        raise ValueError(f"z {tuple(z.shape)} is not [>= {n} x (1 + {f}), "
                         f"{a_s.shape[0]} x {a_s.shape[1]}]")


def _gat_unit(hd: int, *tables: torch.Tensor) -> int:
    """4 where :func:`_unit` finds 4-float units, else 1 (the kernels'
    two widths)."""
    unit = 4 if _unit(hd, *tables) == 4 else 1
    if -(-hd // unit) > GAT_MAX_UNITS:
        raise ValueError(f"heads of {hd} floats in units of {unit}: more than the "
                         f"kernels' {GAT_MAX_UNITS}")
    return unit


def gat_attention_fwd(z: torch.Tensor, a_s: torch.Tensor, a_n: torch.Tensor,
                      mask: torch.Tensor):
    """GAT's attention over a prefix-layout block from ``z`` f32 ``[S,
    K*H]`` (``S >= n * (1 + F)``, ``n, F = mask.shape``), ``a_s`` and
    ``a_n`` f32 ``[K, H]``: ``(out [n, K, H], stats [2, n, K])``, as
    :func:`gat_attention_fwd_plain`; on the card one launch (the softmax
    online, the sums in f32 in another order)."""
    _check_gat(z, a_s, a_n, mask)
    if not _use_kernel(z, a_s, a_n, mask):
        return gat_attention_fwd_plain(z, a_s, a_n, mask)
    for t, name in ((z, "z"), (a_s, "a_s"), (a_n, "a_n")):
        _check(t, name, torch.float32, 2)
    heads, hd = a_s.shape
    n, f = mask.shape
    out = torch.empty((n, heads, hd), dtype=torch.float32, device=z.device)
    stats = torch.empty((2, n, heads), dtype=torch.float32, device=z.device)
    if n:
        _raise_on(_lib().pg_gat_attention_fwd(
            z.data_ptr(), a_s.data_ptr(), a_n.data_ptr(), mask.data_ptr(), n, f, heads, hd,
            out.data_ptr(), stats.data_ptr(), _gat_unit(hd, z, a_s, a_n, out),
            _stream(z.device)), "pg_gat_attention_fwd")
        LAUNCHES["gat_attention_fwd"] += 1
    return out, stats


def gat_attention_bwd(g: torch.Tensor, z: torch.Tensor, a_s: torch.Tensor, a_n: torch.Tensor,
                      mask: torch.Tensor, out: torch.Tensor, stats: torch.Tensor,
                      num_src: int):
    """Backward of :func:`gat_attention_fwd` from ``g [n, K, H]`` and its
    ``out`` and ``stats``: ``(dz [num_src, K*H], d a_s, d a_n)``, as
    :func:`gat_attention_bwd_plain`; on the card one C call (each row of
    ``dz`` written once; the attention vectors' gradients from per-CTA
    partials summed in a fixed order, so the same inputs give the same
    bits)."""
    _check_gat(z, a_s, a_n, mask)
    if num_src < z.shape[0]:
        raise ValueError(f"num_src {num_src} is below z's {z.shape[0]} rows")
    if not _use_kernel(g, z, a_s, a_n, mask, out, stats):
        return gat_attention_bwd_plain(g, z, a_s, a_n, mask, out, stats, num_src)
    for t, name, ndim in ((g, "g", 3), (z, "z", 2), (a_s, "a_s", 2), (a_n, "a_n", 2),
                          (out, "out", 3), (stats, "stats", 3)):
        _check(t, name, torch.float32, ndim)
    heads, hd = a_s.shape
    n, f = mask.shape
    dz = torch.empty((num_src, heads * hd), dtype=torch.float32, device=z.device)
    da = torch.empty((2, heads, hd), dtype=torch.float32, device=z.device)
    ctas = max(1, min(-(-n // WARPS),
                      _sm_count(z.device) * GAT_BWD_CTAS_PER_SM // heads))
    partial = torch.empty((heads, ctas, 2, hd), dtype=torch.float32, device=z.device)
    _raise_on(_lib().pg_gat_attention_bwd(
        z.data_ptr(), a_s.data_ptr(), a_n.data_ptr(), mask.data_ptr(), out.data_ptr(),
        stats.data_ptr(), g.data_ptr(), n, f, num_src, heads, hd, dz.data_ptr(),
        da.data_ptr(), partial.data_ptr(), ctas, _gat_unit(hd, g, z, a_s, a_n, out, dz),
        _stream(z.device)), "pg_gat_attention_bwd")
    LAUNCHES["gat_attention_bwd"] += 1
    return dz, da[0], da[1]


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
        # the max kind's backward reads the source rows
        ctx.save_for_backward(pos, mask, src if kind == "max" else None)
        ctx.num_src = src.shape[0]
        ctx.kind = kind
        ctx.plain = _PLAIN_ON_CUDA.get()
        return gather_reduce(src, pos, mask, kind)

    @staticmethod
    def backward(ctx, grad_out):
        pos, mask, src = ctx.saved_tensors
        grad_src = None
        if ctx.needs_input_grad[0]:
            with _mode(ctx.plain):
                grad_src = gather_reduce_bwd(grad_out.contiguous(), pos, mask,
                                             ctx.num_src, ctx.kind, src)
        return grad_src, None, None, None


class BlockGather(torch.autograd.Function):
    """A block's two gathers of one source table, ``(src[self_pos],
    gather_reduce(src, pos, mask, kind))``, in one :func:`block_gather_fwd`
    launch on the card, whose gradient w.r.t. ``src`` is one
    :func:`block_gather_bwd`: one memset and one kernel launch, where the two
    Functions above take two launches forward, and two memsets, two launches
    and an add backward.  The max kind keeps ``src`` for its backward."""

    @staticmethod
    def forward(ctx, src, self_pos, pos, mask, kind):
        ctx.save_for_backward(self_pos, pos, mask, src if kind == "max" else None)
        ctx.num_src = src.shape[0]
        ctx.kind = kind
        ctx.plain = _PLAIN_ON_CUDA.get()
        # an output that nothing uses arrives as None: its half is absent
        ctx.set_materialize_grads(False)
        return block_gather_fwd(src, self_pos, pos, mask, kind)

    @staticmethod
    def backward(ctx, g_self, g_neigh):
        self_pos, pos, mask, src = ctx.saved_tensors
        grad_src = None
        if ctx.needs_input_grad[0] and (g_self is not None or g_neigh is not None):
            with _mode(ctx.plain):
                grad_src = block_gather_bwd(
                    None if g_self is None else g_self.contiguous(), self_pos,
                    None if g_neigh is None else g_neigh.contiguous(), pos, mask,
                    ctx.num_src, ctx.kind, src)
        return grad_src, None, None, None, None


class DropoutBlock(torch.autograd.Function):
    """Dropout and a prefix-layout block's halves, :func:`dropout_block_fwd`,
    whose gradient w.r.t. ``x`` is one :func:`dropout_block_bwd`.  It keeps
    the packed keep-mask and the block's mask for its backward.  Returns
    ``(self, neigh)``, or ``neigh`` alone without the self half."""

    @staticmethod
    def forward(ctx, x, keep, mask, inv_keep, kind, with_self):
        ctx.save_for_backward(keep, mask)
        ctx.args = (inv_keep, x.shape[0], kind, with_self)
        ctx.plain = _PLAIN_ON_CUDA.get()
        # an output that nothing uses arrives as None: its gradient is zero
        ctx.set_materialize_grads(False)
        out_self, out_neigh = dropout_block_fwd(x, keep, inv_keep, mask, with_self, kind)
        return (out_self, out_neigh) if with_self else out_neigh

    @staticmethod
    def backward(ctx, *grads):
        keep, mask = ctx.saved_tensors
        inv_keep, num_src, kind, with_self = ctx.args
        g_self, g_neigh = grads if with_self else (None, grads[0])
        grad_x = None
        if ctx.needs_input_grad[0] and (g_self is not None or g_neigh is not None):
            with _mode(ctx.plain):
                grad_x = dropout_block_bwd(
                    None if g_self is None else g_self.contiguous(),
                    None if g_neigh is None else g_neigh.contiguous(), keep, inv_keep, mask,
                    num_src, kind)
        return grad_x, None, None, None, None, None


class GatAttention(torch.autograd.Function):
    """GAT's attention over a prefix-layout block, :func:`gat_attention_fwd`
    (``out [n, K, H]``), whose gradients w.r.t. ``z``, ``a_s`` and ``a_n``
    are one :func:`gat_attention_bwd`.  It keeps ``z``, the attention
    vectors, the mask, its output and the stats for its backward."""

    @staticmethod
    def forward(ctx, z, a_s, a_n, mask):
        out, stats = gat_attention_fwd(z, a_s, a_n, mask)
        ctx.save_for_backward(z, a_s, a_n, mask, out, stats)
        ctx.plain = _PLAIN_ON_CUDA.get()
        return out

    @staticmethod
    def backward(ctx, g):
        z, a_s, a_n, mask, out, stats = ctx.saved_tensors
        with _mode(ctx.plain):
            dz, da_s, da_n = gat_attention_bwd(g.contiguous(), z, a_s, a_n, mask, out, stats,
                                               z.shape[0])
        return dz, da_s, da_n, None


# ---------------------------------------------------------------------------
# phase marks
# ---------------------------------------------------------------------------

# the phases a train step marks, in the order of the marker kernels
# pg_mark_<phase> (kMarks in csrc/gather_kernels.cu)
MARK_PHASES = ("epoch", "sample", "fetch", "forward", "backward", "sync", "optimizer",
               "accumulate", "epoch_end")


def mark(phase: str, device: torch.device, traced: bool) -> None:
    """Mark where ``phase`` starts on ``device``'s current stream with its
    empty kernel ``pg_mark_<phase>`` (one thread, no memory touched), which
    a profiler's trace names, inside a replayed CUDA graph too.  On the CPU
    nothing.  On the card: under CUDA-graph capture always, so that one
    graph serves traced and untraced replays (:class:`GraphMarks` enables or
    disables its marker nodes); else only when ``traced``.  Not counted in
    :data:`LAUNCHES`."""
    if phase not in MARK_PHASES:
        raise ValueError(f"phase must be one of {MARK_PHASES}, got {phase!r}")
    if device.type != "cuda" or not (traced or torch.cuda.is_current_stream_capturing()):
        return
    _raise_on(_lib().pg_mark(MARK_PHASES.index(phase), _stream(device)), "pg_mark")


class GraphMarks:
    """The marker kernel nodes of one captured CUDA graph (a
    ``torch.cuda.CUDAGraph(keep_graph=True)``, instantiated), found once
    by their function; :meth:`set` enables or disables all of them in the
    graph's executable, for the replays that follow (not one in flight).
    As captured they are enabled."""

    def __init__(self, graph: torch.cuda.CUDAGraph):
        lib = _lib()
        raw = graph.raw_cuda_graph()
        n, found = ctypes.c_int64(), ctypes.c_int64()
        _raise_on(lib.pg_graph_num_nodes(raw, ctypes.byref(n)), "pg_graph_num_nodes")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        _raise_on(lib.pg_graph_find_marks(raw, nodes, n.value, ctypes.byref(found)),
                  "pg_graph_find_marks")
        self._nodes = (ctypes.c_void_p * found.value)(*nodes[:found.value])
        self._exec = graph.raw_cuda_graph_exec()
        self.enabled = True

    def __len__(self) -> int:
        return len(self._nodes)

    def set(self, enabled: bool) -> None:
        if enabled == self.enabled:
            return
        _raise_on(_lib().pg_graph_enable_nodes(self._exec, self._nodes, len(self._nodes),
                                               int(enabled)), "pg_graph_enable_nodes")
        self.enabled = enabled
