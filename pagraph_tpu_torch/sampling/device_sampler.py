"""Neighbor sampling on the device (the port of
``pagraph_tpu/sampling/device_sampler.py``).

When the in-neighbor CSR and the full feature cache both fit in device
memory, an epoch needs nothing from the host: the train-vertex permutation,
the sampling, the layer-0 fetch, forward, backward and Adam all run on the
card (:mod:`pagraph_tpu_torch.train.device_epoch`).  This module is the
sampler of that path, in torch ops on the CSR's device.

Design, as in the JAX package:

  * The per-vertex policy of the host sampler: in-degree ``d == 0`` -> every
    slot masked; ``0 < d <= fanout`` -> all ``d`` in-neighbors; ``d >
    fanout`` -> uniform draws with replacement.
  * No deduplication, so every shape is static: layer ``i`` is
    ``cat(layer i+1, its sampled neighbors)``, ``B * prod(fanout_h + 1)``
    rows, and the inner layer is a prefix of the outer one.  The blocks
    carry ``prefix_layout=True``, so aggregation is a slice
    (:mod:`pagraph_tpu_torch.ops.aggregate`).
  * The random integers are an argument (``draws``, int32 in ``[0, 2^31 -
    1)``; :func:`hop_draws` makes them with a ``torch.Generator``).  torch's
    and ``jax.random``'s streams differ, so the tests hand both packages the
    same integers and the batches are equal.
  * Nothing here waits for the device: no ``.item()``, ``nonzero``, boolean
    indexing or ``unique``, and every index tensor is made on the device.

One deviation: the generic draw reads ``indices[start + off]``, which for a
trailing vertex with no in-edges is ``indices[E]``, out of range when ``E``
is already a multiple of 8.  ``jnp.take`` does not raise there; torch
indexing does (and asserts on the card).  The port clamps the read; the slot
is masked, so the batch is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph import CSRGraph
from ..utils.device import resolve_device
from .block import Block, MiniBatch

_ROW_W = 8        # aligned-window width (32-byte rows) of the paired draw
_DRAW_HIGH = 2**31 - 1


def pad_indices(indices: np.ndarray) -> np.ndarray:
    """Zero-pad a CSR ``indices`` vector to a multiple of 8, so the paired
    draw can view it as ``[E/8, 8]`` rows.  Sampled positions are always
    ``< deg``, so the padding is never selected."""
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    pad = (-indices.shape[0]) % _ROW_W
    if pad:
        indices = np.concatenate([indices, np.zeros(pad, np.int32)])
    return indices


@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Device-resident in-neighbor CSR, int32.

    ``ptr_pairs[v] = (indptr[v], deg[v])`` gives both pointer lookups of a
    vertex in one 8-byte row.  The paired draw gathers aligned rows from
    ``indices.view(-1, 8)``, a free view of the padded ``indices`` (the JAX
    package builds that table on the host, behind a ``paired`` flag, because
    a device-side reshape re-tiles it on the TPU).
    """

    indptr: torch.Tensor       # int32 [N+1]
    indices: torch.Tensor      # int32 [E rounded up to 8]
    ptr_pairs: torch.Tensor    # int32 [N, 2] (start, deg)

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @classmethod
    def from_graph(cls, graph: CSRGraph, device=None) -> "DeviceCSR":
        """Copy ``graph`` to ``device`` (``None``: the GPU, ``RuntimeError``
        without one)."""
        if graph.num_edges >= np.iinfo(np.int32).max:
            raise ValueError(
                f"{graph.num_edges} edges overflow int32 indptr; "
                "on-device sampling requires < 2^31 edges per partition")
        device = resolve_device(device)
        indptr32 = graph.indptr.astype(np.int32)
        pairs = np.stack([indptr32[:-1], np.diff(indptr32)], axis=1)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)

        return cls(indptr=put(indptr32), indices=put(pad_indices(graph.indices)),
                   ptr_pairs=put(pairs))

    def nbytes(self) -> int:
        """Device bytes held."""
        return 4 * (self.indptr.numel() + self.indices.numel() + self.ptr_pairs.numel())


def _vertex_ptrs(csr: DeviceCSR, dst: torch.Tensor,
                 prefix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(start, deg)`` of each dst vertex.  ``prefix`` holds the pointers
    already fetched for the leading entries of ``dst`` (hop h's dst is a
    prefix of hop h+1's), which are reused instead of gathered again."""
    rest = dst[prefix[0].shape[0]:] if prefix is not None else dst
    pairs = csr.ptr_pairs.index_select(0, rest)
    starts, deg = pairs[:, 0], pairs[:, 1]
    if prefix is not None:
        starts = torch.cat([prefix[0], starts])
        deg = torch.cat([prefix[1], deg])
    return starts, deg


def _paired_path(paired: bool, fanout: int) -> bool:
    return paired and fanout >= 2


def draw_width(fanout: int, paired: bool) -> int:
    """Columns of a hop's ``draws``: one a slot, or one a window of 8 slots
    on the paired path."""
    return -(-fanout // _ROW_W) if _paired_path(paired, fanout) else fanout


def hop_draws(generator: torch.Generator, n: int, fanout: int, paired: bool,
              device, *, steps: Optional[int] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The random integers of one hop over ``n`` dst vertices: int32
    ``[n, draw_width(fanout, paired)]`` in ``[0, 2^31 - 1)``, the range of
    the JAX package's ``jax.random.randint``, made on ``device``
    (``generator``'s).  ``steps`` adds a leading dimension: that many
    steps' draws in one call.  ``out`` (int32, of that shape) receives
    them in place: the same integers as a fresh tensor."""
    shape = (n, draw_width(fanout, paired))
    shape = shape if steps is None else (steps, *shape)
    if out is not None:
        if tuple(out.shape) != shape or out.dtype != torch.int32:
            raise ValueError(f"out must be int32 {list(shape)}, got {out.dtype} "
                             f"{list(out.shape)}")
        return torch.randint(0, _DRAW_HIGH, shape, generator=generator, out=out)
    return torch.randint(0, _DRAW_HIGH, shape, generator=generator, device=device,
                         dtype=torch.int32)


def sample_hop(csr: DeviceCSR, dst: torch.Tensor, dst_mask: torch.Tensor,
               fanout: int, draws: torch.Tensor, *, paired: bool = False,
               ptrs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ``fanout`` in-neighbors of each dst vertex (int32 ``[n]``,
    mask bool ``[n]``) from ``draws`` (:func:`hop_draws`).

    Returns ``(nbr int32 [n, fanout], mask bool [n, fanout])``; masked slots
    hold vertex 0.  ``paired=True`` (at fan-out >= 2) is the JAX package's
    row-gather draw: each window of 8 slots takes one draw ``g = start + o``
    and one aligned 8-entry row of ``indices``; slot j takes the element at
    ``(g & ~7) | ((g & 7) ^ j)`` if that lies in the vertex's list, else
    ``g``.  Each slot is uniform over the list; slots of one window are
    correlated; ``deg <= fanout`` vertices draw with replacement instead of
    taking all (the mask is the same).  See the JAX docstring for the
    derivation.
    """
    n = dst.shape[0]
    width = draw_width(fanout, paired)
    if tuple(draws.shape) != (n, width):
        raise ValueError(f"draws must be [{n}, {width}], got {tuple(draws.shape)}")
    starts, deg = ptrs if ptrs is not None else _vertex_ptrs(csr, dst)
    dev = dst.device
    safe = deg.clamp(min=1)
    k = torch.arange(fanout, device=dev, dtype=torch.int32)[None, :]
    small = deg[:, None] <= fanout
    mask = torch.where(small, k < deg[:, None], (deg > 0)[:, None]) & dst_mask[:, None]
    e = csr.indices.shape[0]
    if e == 0:                                   # no edges: every slot masked
        return torch.zeros((n, fanout), dtype=torch.int32, device=dev), mask
    if _paired_path(paired, fanout):
        if e % _ROW_W:
            raise ValueError("the paired draw needs indices padded to a "
                             "multiple of 8 (DeviceCSR.from_graph pads them)")
        nrows = e // _ROW_W
        rows = csr.indices.view(nrows, _ROW_W)
        g = starts[:, None] + draws % safe[:, None]            # [n, nwin]
        # trailing deg-0 vertices have g == e: clamp the row (slot masked)
        row = (g >> 3).clamp(max=nrows - 1)
        win = rows.index_select(0, row.reshape(-1)).view(n, width, _ROW_W)
        j = k[0]
        wj = torch.div(j, _ROW_W, rounding_mode="floor")       # window of slot j
        gw = g.index_select(1, wj)                             # [n, fanout]
        cand = (gw & ~(_ROW_W - 1)) | ((gw & (_ROW_W - 1)) ^ (j % _ROW_W)[None, :])
        pos = cand - starts[:, None]
        chosen = torch.where((pos >= 0) & (pos < deg[:, None]), cand, gw)
        lane = (chosen & (_ROW_W - 1)).long()                  # same row as g
        nbr = win.index_select(1, wj).gather(2, lane[..., None])[..., 0]
        return torch.where(mask, nbr, 0), mask
    offs = torch.where(small, k % safe[:, None], draws % safe[:, None])
    # a trailing deg-0 vertex has start == e: clamp the read (slot masked)
    idx = (starts[:, None] + offs).clamp(max=e - 1)
    nbr = csr.indices.index_select(0, idx.reshape(-1)).view(n, fanout)
    return torch.where(mask, nbr, 0), mask


def hop_sizes(batch_size: int, fanouts: Sequence[int]) -> Tuple[int, ...]:
    """Dst vertices of each hop: ``B * prod(fanout_h + 1)`` over the inner
    hops (6000, 18000 at batch 6000 and fan-out 2)."""
    sizes, n = [], batch_size
    for f in fanouts:
        sizes.append(n)
        n *= f + 1
    return tuple(sizes)


def sample_minibatch_device(
    csr: DeviceCSR,
    seeds: torch.Tensor,            # int32 [B] (padded slots: any valid id)
    seed_mask: torch.Tensor,        # bool  [B]
    num_hops: int,
    fanout,                         # int, or per-hop sequence ([0]: from the seeds)
    draws: Sequence[torch.Tensor],  # one hop_draws tensor a hop
    labels: Optional[torch.Tensor] = None,   # int32 [N] per-vertex labels
    paired: bool = False,
) -> MiniBatch:
    """Expand ``seeds`` into a padded :class:`MiniBatch` on their device.

    Layer ``i`` is ``cat(layer i+1 ids, layer i+1's sampled neighbors)``, so
    its width is ``B * prod(fanout_h + 1)`` over the inner hops and the inner
    layer is a prefix of the outer one.
    """
    fanouts = (tuple(int(f) for f in fanout) if isinstance(fanout, (tuple, list))
               else (int(fanout),) * num_hops)
    if len(fanouts) != num_hops:
        raise ValueError(f"{len(fanouts)} fan-outs {fanouts} for {num_hops} hops")
    if len(draws) != num_hops:
        raise ValueError(f"{len(draws)} draws tensors for {num_hops} hops")
    dev = seeds.device
    cur, curm = seeds.to(torch.int32), seed_mask
    layers = [(cur, curm)]
    blocks_rev = []
    ptrs = None
    for hop, f in enumerate(fanouts):
        # hop h's dst is a prefix of hop h+1's dst: reuse fetched pointers
        ptrs = _vertex_ptrs(csr, cur, prefix=ptrs)
        nbr, emask = sample_hop(csr, cur, curm, f, draws[hop], paired=paired, ptrs=ptrs)
        n = cur.shape[0]
        blocks_rev.append(Block(
            neigh_pos=torch.arange(n, n + n * f, device=dev, dtype=torch.int32).view(n, f),
            neigh_mask=emask,
            self_pos=torch.arange(n, device=dev, dtype=torch.int32),
            prefix_layout=True,
        ))
        cur = torch.cat([cur, nbr.reshape(-1)])
        curm = torch.cat([curm, emask.reshape(-1)])
        layers.append((cur, curm))
    layers.reverse()
    lab = (labels.index_select(0, seeds) if labels is not None
           else torch.zeros(seeds.shape, dtype=torch.int32, device=dev))
    return MiniBatch(
        layer_nids=tuple(ids for ids, _ in layers),
        layer_mask=tuple(m for _, m in layers),
        blocks=tuple(reversed(blocks_rev)),
        labels=lab,
    )
