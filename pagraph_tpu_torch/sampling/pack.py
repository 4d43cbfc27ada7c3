"""Packed batch transfer (the port of ``pagraph_tpu/sampling/pack.py``):
a host minibatch and its fetch plan in three flat buffers, an int32 one, a
uint8 one and the miss rows in the cache tier's dtype (f32, bf16 or int8).

The layout is the JAX package's lean one (``device_plan=True``): the int32
buffer holds ``src_row`` (the port's plan, :class:`storage.cache.FetchPlan`,
one index a layer-0 row, in place of JAX's ``layer0_nids`` and its device
residency map), ``labels``, ``self_pos`` and ``neigh_pos``; the uint8 buffer
holds ``input_mask``, ``seed_mask`` and ``neigh_mask`` bit-packed, 8 flags a
byte, little-endian.  The sections the two layouts share are byte-equal to
JAX's ``pack`` of the same MiniBatch; a section whose flag count is not a
multiple of 8 ends in a zero-padded byte (the JAX layout requires caps
divisible by 8).  The device unpacks with static slices and views
(:func:`unpack`); inner-layer ids and masks never cross, as in JAX.

The halo exchange's layout (``halo`` > 0, the ``ici`` feature source,
``parallel/halo.py``) carries no miss rows (``bucket`` 0): ``src_row`` is
the exchange's (:func:`parallel.halo.src_rows`) and the plan's requests,
``halo`` int32 (``P x H``), close the int32 buffer (:func:`halo_req`), so
a replayed graph finds them in its static buffers.

A batch packs into pageable memory; a group of K batches stacks into
``[K, ...]`` buffers (:func:`stack`), pinned for the card, their miss rows
padded to the group's largest bucket, and crosses in one copy a buffer.

The sampling service's slots (``sampling/service.py``) hold a whole host
MiniBatch, every layer's ids and masks included, in the JAX package's full
layout less its plan sections (a worker has no cache, so its plan is
empty): :class:`SlotLayout`, written by :func:`pack_slot` and read back by
:func:`unpack_numpy` as numpy views (the JAX package's ``unpack_numpy``).
Those run without torch, which the functions that make tensors import
themselves: the service's workers import this module and never load it.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

from .block import Block, MiniBatch

if TYPE_CHECKING:
    import torch


def _bytes(flags: int) -> int:
    return -(-flags // 8)


@dataclasses.dataclass(frozen=True)
class BatchLayout:
    """Static layout of the packed buffers (hashable: a graph key)."""

    caps: Tuple[int, ...]       # per-layer capacities, outermost first
    fanouts: Tuple[int, ...]    # per-block fanout, outermost block first
    total_dim: int              # feature width
    bucket: int                 # miss rows (a power-of-two bucket, or 0)
    halo: int = 0               # halo requests (P x H; 0 without the exchange)

    @property
    def hops(self) -> int:
        return len(self.caps) - 1

    def block_sizes(self) -> Tuple[int, ...]:
        """neigh_pos/neigh_mask elements per block (cap_dst * fanout)."""
        return tuple(c * f for c, f in zip(self.caps[1:], self.fanouts))

    def i32_sections(self):
        return [("src_row", self.caps[0]), ("labels", self.caps[-1]),
                ("self_pos", sum(self.caps[1:])), ("neigh_pos", sum(self.block_sizes()))
                ] + ([("halo_req", self.halo)] if self.halo else [])

    def u8_sections(self):
        return [("input_mask", _bytes(self.caps[0])), ("seed_mask", _bytes(self.caps[-1])),
                ("neigh_mask", _bytes(sum(self.block_sizes())))]

    @property
    def i32_size(self) -> int:
        return sum(n for _, n in self.i32_sections())

    @property
    def u8_size(self) -> int:
        return sum(n for _, n in self.u8_sections())


def make_layout(caps: Sequence[int], fanouts: Sequence[int], total_dim: int,
                bucket: int, halo: int = 0) -> BatchLayout:
    """``fanouts``: per block, outermost block first
    (``SamplerConfig.block_fanouts()``); ``halo``: the exchange's requests
    a batch."""
    caps = tuple(int(c) for c in caps)
    fanouts = tuple(int(f) for f in fanouts)
    if len(fanouts) != len(caps) - 1:
        raise ValueError(f"need {len(caps) - 1} block fanouts, got {fanouts}")
    return BatchLayout(caps, fanouts, int(total_dim), int(bucket), int(halo))


def _packbits(arr) -> np.ndarray:
    return np.packbits(np.asarray(arr, dtype=bool).ravel(), bitorder="little")


def pack(mb: MiniBatch, src_row: np.ndarray, miss_feats: torch.Tensor,
         layout: BatchLayout, halo_req: Optional[np.ndarray] = None,
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A host MiniBatch and its plan -> ``(i32, u8, miss)`` host tensors in
    pageable memory (``miss`` is ``miss_feats`` itself); :func:`stack`
    makes the one pinned copy.  ``halo_req``: the exchange's requests
    (``layout.halo`` of them)."""
    import torch

    if tuple(miss_feats.shape) != (layout.bucket, layout.total_dim):
        raise ValueError(f"miss rows {tuple(miss_feats.shape)} do not match the layout's "
                         f"{(layout.bucket, layout.total_dim)}")
    i32 = np.empty(layout.i32_size, dtype=np.int32)
    u8 = np.empty(layout.u8_size, dtype=np.uint8)
    if (halo_req is None) != (layout.halo == 0) or (
            halo_req is not None and np.asarray(halo_req).size != layout.halo):
        raise ValueError(f"halo requests do not match the layout's {layout.halo}")
    parts = ([src_row, mb.labels] + [b.self_pos for b in mb.blocks]
             + [b.neigh_pos for b in mb.blocks] + ([] if halo_req is None else [halo_req]))
    at = 0
    for a in parts:
        flat = np.asarray(a).ravel()
        i32[at:at + flat.size] = flat
        at += flat.size
    at = 0
    for a in (_packbits(mb.layer_mask[0]), _packbits(mb.layer_mask[-1]),
              _packbits(np.concatenate([np.asarray(b.neigh_mask).ravel()
                                        for b in mb.blocks]))):
        u8[at:at + a.size] = a
        at += a.size
    return torch.from_numpy(i32), torch.from_numpy(u8), miss_feats


@dataclasses.dataclass(frozen=True)
class PackedGroup:
    """K packed batches: ``i32 [K, i32_size]``, ``u8 [K, u8_size]``,
    ``miss [K, layout.bucket, D]`` (each batch's rows, then padding)."""

    layout: BatchLayout     # bucket: the group's largest
    i32: torch.Tensor
    u8: torch.Tensor
    miss: torch.Tensor

    @property
    def k(self) -> int:
        return self.i32.shape[0]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.i32, self.u8, self.miss))

    def to(self, device, non_blocking: bool = False) -> "PackedGroup":
        return PackedGroup(self.layout, *(t.to(device, non_blocking=non_blocking)
                                          for t in (self.i32, self.u8, self.miss)))


def stack(items: List[Tuple[BatchLayout, torch.Tensor, torch.Tensor, torch.Tensor]],
          *, pin_memory: bool = False) -> PackedGroup:
    """Stack packed batches ``(layout, i32, u8, miss)`` into one group, the
    miss rows padded with zeros to the largest bucket (as the JAX package's
    loop does), in new buffers, pinned with ``pin_memory``."""
    import torch

    layout0 = items[0][0]
    bucket = max(it[0].bucket for it in items)
    layout = dataclasses.replace(layout0, bucket=bucket)
    k, d = len(items), layout.total_dim
    i32 = torch.stack([it[1] for it in items],
                      out=torch.empty((k, layout.i32_size), dtype=torch.int32,
                                      pin_memory=pin_memory))
    u8 = torch.stack([it[2] for it in items],
                     out=torch.empty((k, layout.u8_size), dtype=torch.uint8,
                                     pin_memory=pin_memory))
    miss = torch.empty((k, bucket, d), dtype=items[0][3].dtype, pin_memory=pin_memory)
    for j, it in enumerate(items):
        b = it[3].shape[0]
        miss[j, :b].copy_(it[3])
        miss[j, b:].zero_()
    return PackedGroup(layout, i32, u8, miss)


def _split(arr: torch.Tensor, sizes):
    out, at = [], 0
    for s in sizes:
        out.append(arr[at:at + s])
        at += s
    return out


def _unpackbits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Little-endian bit unpack on the tensor's device -> bool ``[n]``."""
    import torch

    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, None] >> shifts) & 1).reshape(-1)[:n].bool()


def unpack(layout: BatchLayout, i32: torch.Tensor, u8: torch.Tensor,
           miss: Optional[torch.Tensor] = None
           ) -> Tuple[MiniBatch, torch.Tensor, Optional[torch.Tensor]]:
    """One batch's buffers -> ``(MiniBatch, src_row, miss)`` on their
    device: static slices and views, and one bit unpack a mask section.
    Inner-layer ids and masks were not shipped: the ids are zeros, the
    masks of the layers between input and seeds all true, as in JAX."""
    import torch

    caps, fanouts = layout.caps, layout.fanouts
    src_row, labels, self_flat, npos_flat = _split(
        i32, [n for _, n in layout.i32_sections()])[:4]
    in_bits, seed_bits, nmask_bits = _split(u8, [n for _, n in layout.u8_sections()])
    sizes = layout.block_sizes()
    nmask = _unpackbits(nmask_bits, sum(sizes))
    blocks = tuple(
        Block(neigh_pos=p.view(caps[b + 1], fanouts[b]),
              neigh_mask=m.view(caps[b + 1], fanouts[b]), self_pos=s)
        for b, (p, m, s) in enumerate(zip(_split(npos_flat, sizes), _split(nmask, sizes),
                                          _split(self_flat, caps[1:]))))
    zeros = torch.zeros(max(caps), dtype=torch.int32, device=i32.device)
    ones = torch.ones(max(caps), dtype=torch.bool, device=i32.device)
    layer_mask = ((_unpackbits(in_bits, caps[0]),)
                  + tuple(ones[:c] for c in caps[1:-1])
                  + (_unpackbits(seed_bits, caps[-1]),))
    mb = MiniBatch(layer_nids=tuple(zeros[:c] for c in caps), layer_mask=layer_mask,
                   blocks=blocks, labels=labels)
    return mb, src_row, miss


def halo_req(layout: BatchLayout, i32: torch.Tensor) -> torch.Tensor:
    """One batch's halo requests (a view of its int32 buffer): int32
    ``[layout.halo]``."""
    return i32[layout.i32_size - layout.halo:]


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Layout of a sampling-service slot: int32 ``layer_nids`` (every
    layer), ``labels``, ``self_pos``, ``neigh_pos``; uint8 ``layer_mask``
    (every layer) and ``neigh_mask``, a byte a flag."""

    caps: Tuple[int, ...]
    fanouts: Tuple[int, ...]

    def block_sizes(self) -> Tuple[int, ...]:
        return tuple(c * f for c, f in zip(self.caps[1:], self.fanouts))

    def i32_sections(self):
        return [("layer_nids", sum(self.caps)), ("labels", self.caps[-1]),
                ("self_pos", sum(self.caps[1:])), ("neigh_pos", sum(self.block_sizes()))]

    def u8_sections(self):
        return [("layer_mask", sum(self.caps)), ("neigh_mask", sum(self.block_sizes()))]

    @property
    def i32_size(self) -> int:
        return sum(n for _, n in self.i32_sections())

    @property
    def u8_size(self) -> int:
        return sum(n for _, n in self.u8_sections())


def make_slot_layout(caps: Sequence[int], fanouts: Sequence[int]) -> SlotLayout:
    """``fanouts``: per block, outermost block first."""
    layout = make_layout(caps, fanouts, 0, 0)
    return SlotLayout(layout.caps, layout.fanouts)


def pack_slot(mb: MiniBatch, layout: SlotLayout, i32: np.ndarray, u8: np.ndarray) -> None:
    """Write a host MiniBatch into a slot's ``i32`` and ``u8`` rows."""
    at = 0
    for a in (*mb.layer_nids, mb.labels, *(b.self_pos for b in mb.blocks),
              *(b.neigh_pos for b in mb.blocks)):
        flat = np.asarray(a).ravel()
        i32[at:at + flat.size] = flat
        at += flat.size
    at = 0
    for a in (*mb.layer_mask, *(b.neigh_mask for b in mb.blocks)):
        flat = np.asarray(a).ravel()
        u8[at:at + flat.size] = flat
        at += flat.size


def unpack_numpy(layout: SlotLayout, i32: np.ndarray, u8: np.ndarray) -> MiniBatch:
    """A slot's rows -> a host MiniBatch of numpy views into them (no
    copy: the caller owns ``i32`` and ``u8``)."""
    caps, fanouts, sizes = layout.caps, layout.fanouts, layout.block_sizes()
    nids, labels, self_flat, npos_flat = _split(i32, [n for _, n in layout.i32_sections()])
    lmask, nmask_flat = (x.view(bool) for x in _split(u8, [n for _, n in layout.u8_sections()]))
    blocks = tuple(
        Block(neigh_pos=p.reshape(caps[b + 1], fanouts[b]),
              neigh_mask=m.reshape(caps[b + 1], fanouts[b]), self_pos=sp)
        for b, (p, m, sp) in enumerate(zip(_split(npos_flat, sizes), _split(nmask_flat, sizes),
                                           _split(self_flat, caps[1:]))))
    return MiniBatch(layer_nids=tuple(_split(nids, caps)), layer_mask=tuple(_split(lmask, caps)),
                     blocks=blocks, labels=labels)
