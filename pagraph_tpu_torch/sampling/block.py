"""Fixed-shape minibatch IR (the port of ``pagraph_tpu/sampling/block.py``).

A minibatch is a set of **statically shaped** padded arrays, numpy on the
host and torch tensors once shipped with :meth:`MiniBatch.to`.

Structure (L = num_hops):

    layer 0 (outermost, largest) ... layer L (seeds)
    block i connects layer i (sources) -> layer i+1 (destinations)

Invariants:
  * every destination vertex also appears in its source layer
    (``include_self``), so input features are gathered once for layer 0 and
    every deeper representation is reachable through ``self_pos``;
  * ``neigh_pos[i][d, k]`` indexes a row of layer i; masked (padded) slots
    point at position 0 and are excluded by ``neigh_mask``;
  * all positions are block-local, so device code never sees global ids.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def _ship(x: Array, device: torch.device, non_blocking: bool) -> torch.Tensor:
    """numpy or torch -> tensor on ``device``.  A host array bound for a GPU
    goes through a pinned buffer so a non-blocking copy is truly async."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    if non_blocking and device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=non_blocking)


@dataclasses.dataclass(frozen=True)
class Block:
    """One bipartite sampling level: sources (layer i) -> dests (layer i+1)."""

    neigh_pos: Array     # int32 [cap_dst, fanout] positions into src layer
    neigh_mask: Array    # bool  [cap_dst, fanout] valid sampled edge
    self_pos: Array      # int32 [cap_dst] position of dst vertex in src layer
    # Layout promise: self_pos == arange(cap_dst) and
    # neigh_pos == cap_dst + arange(cap_dst*fanout) (row-major), which turns
    # every aggregation gather into a contiguous slice.  Only the on-device
    # sampler (sampling/device_sampler.py) produces it; host batches are False.
    prefix_layout: bool = False

    @property
    def cap_dst(self) -> int:
        return self.neigh_pos.shape[0]

    @property
    def fanout(self) -> int:
        return self.neigh_pos.shape[1]

    def to(self, device, non_blocking: bool = False) -> "Block":
        device = torch.device(device)
        return Block(
            neigh_pos=_ship(self.neigh_pos, device, non_blocking),
            neigh_mask=_ship(self.neigh_mask, device, non_blocking),
            self_pos=_ship(self.self_pos, device, non_blocking),
            prefix_layout=self.prefix_layout,
        )


@dataclasses.dataclass(frozen=True)
class MiniBatch:
    """A sampled, padded, statically shaped training minibatch."""

    layer_nids: Tuple[Array, ...]   # int32 [cap_i] local vertex ids (0-padded)
    layer_mask: Tuple[Array, ...]   # bool  [cap_i] valid entries
    blocks: Tuple[Block, ...]       # len == num_hops
    labels: Array                   # int32 [cap_seed]

    @property
    def num_hops(self) -> int:
        return len(self.blocks)

    @property
    def seed_mask(self) -> Array:
        return self.layer_mask[-1]

    @property
    def input_nids(self) -> Array:
        """Vertices whose features must be materialized (outermost layer)."""
        return self.layer_nids[0]

    @property
    def input_mask(self) -> Array:
        return self.layer_mask[0]

    def num_sampled_edges(self) -> int:
        """Total valid sampled edges."""
        return int(sum(int(b.neigh_mask.sum()) for b in self.blocks))

    def num_loaded_vertices(self) -> int:
        """Total valid vertices across layers (the reference's count_vnum
        metric)."""
        return int(sum(int(m.sum()) for m in self.layer_mask))

    def to(self, device, non_blocking: bool = False) -> "MiniBatch":
        device = torch.device(device)
        return MiniBatch(
            layer_nids=tuple(_ship(x, device, non_blocking)
                             for x in self.layer_nids),
            layer_mask=tuple(_ship(x, device, non_blocking)
                             for x in self.layer_mask),
            blocks=tuple(b.to(device, non_blocking) for b in self.blocks),
            labels=_ship(self.labels, device, non_blocking),
        )


def pad_1d(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if len(arr) > cap:
        raise ValueError(f"array of length {len(arr)} exceeds capacity {cap}")
    out = np.full(cap, fill, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


def validity_mask(n: int, cap: int) -> np.ndarray:
    m = np.zeros(cap, dtype=bool)
    m[:n] = True
    return m
