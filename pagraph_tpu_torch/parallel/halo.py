"""Features sharded across the ranks, each batch's layer-0 rows fetched from
their owners (the port of ``pagraph_tpu/parallel/halo.py``).

Instead of every rank caching hot vertices and reading misses from host
memory, the full feature matrix is split disjointly over the ranks' device
memory (:func:`shard_features`: cyclic, ``owner(v) = v % P``, ``slot(v) = v
// P``), and a batch's layer-0 rows come from their owners over two
``all_to_all`` collectives.  A rank then holds ``N * dim / P`` feature rows.

The exchange of one batch (:class:`HaloExchange`), with ``H`` the static
halo width:

1. ``req`` int32 ``[P, H]``: row q holds the offsets into owner q's shard of
   the rows this rank needs from q (:class:`HaloPlanner` on the host,
   :func:`device_halo_plan` on the device: the first ``H`` requests for
   each owner in position order; the rest are dropped and read zeros);
2. ``all_to_all_single`` of the requests: row p is what rank p asks of me;
3. the owner's local gather ``shard[reqs]`` at the tier's dtype, into a
   static send buffer;
4. ``all_to_all_single`` of the rows: row block q is what owner q served;
5. batch order, the int8 tier's dequant and the dropped rows' zeros in one
   ``pg_assemble`` launch (``ops/gather_kernels.py`` ``assemble``, the
   counterpart of the Pallas row gather): the received rows are its cache,
   one zero row its only miss row, ``src_row = slot`` where a request is
   valid and ``-1`` (the zero row) where not (:func:`src_rows`).

``H`` is static, so every split is equal and no split sizes are passed: the
exchange never waits for the host, and under ``nccl`` a CUDA graph captures
it.  Under gloo the collectives run eagerly, on CUDA tensors as on CPU ones.
The JAX package pads the exchanged rows to a multiple of 128 columns for the
TPU's lanes; the port exchanges the rows at their own width.

Only layer 0 crosses ranks: the inner layers of a minibatch are prefixes of
layer 0 (the sampler's subset invariant), reached through ``self_pos``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gather_kernels import assemble
from ..storage.cache import bucket_size

Array = Union[np.ndarray, torch.Tensor]


def shard_features(features: np.ndarray, num_shards: int) -> Tuple[np.ndarray, int]:
    """Cyclic sharding: ``(stacked [P, shard_rows, D], shard_rows)``, where
    shard r row j is vertex ``j * P + r`` and the tail is zero-padded.
    Cyclic ownership spreads consecutive ids, and with them the low-id hubs
    of power-law graphs, over every owner, so a skewed batch does not
    overflow one owner's static width."""
    n, d = features.shape
    shard_rows = -(-n // num_shards)
    padded = np.zeros((num_shards * shard_rows, d), dtype=features.dtype)
    padded[:n] = features
    return (np.ascontiguousarray(padded.reshape(shard_rows, num_shards, d).transpose(1, 0, 2)),
            shard_rows)


def shard_ids(rank: int, num_shards: int, num_nodes: int) -> np.ndarray:
    """The full vertex ids of shard ``rank``'s rows, in slot order."""
    return np.arange(rank, num_nodes, num_shards, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """One rank's exchange indices for one batch (numpy on the host, torch
    on the device)."""

    req: Array      # int32 [P, H] offsets into each owner's shard
    slot: Array     # int32 [cap0] index into the received [P * H] rows
    valid: Array    # bool  [cap0] requested (the others read zeros)


def src_rows(plan: HaloPlan) -> Array:
    """The assembly's ``src_row`` int32 ``[cap0]``: ``slot`` where the
    request is valid, ``-1`` (the zero row) where not."""
    if isinstance(plan.slot, torch.Tensor):
        return torch.where(plan.valid, plan.slot, -1).to(torch.int32)
    return np.where(plan.valid, plan.slot, -1).astype(np.int32)


class HaloPlanner:
    """Builds a rank's :class:`HaloPlan` on the host (vectorized numpy)."""

    def __init__(self, num_shards: int, shard_rows: int, halo_width: int):
        self.num_shards = num_shards
        self.shard_rows = shard_rows
        self.halo_width = halo_width

    def plan(self, full_nids: np.ndarray, mask: np.ndarray) -> HaloPlan:
        """``full_nids``: the full-graph ids of the batch's ``cap0`` layer-0
        rows; ``mask`` their validity."""
        p_, h_ = self.num_shards, self.halo_width
        nids = np.asarray(full_nids, dtype=np.int64)
        mask = np.asarray(mask, dtype=bool)
        owner = np.where(mask, nids % p_, 0).astype(np.int32)
        offset = (nids // p_).astype(np.int32)
        req = np.zeros((p_, h_), dtype=np.int32)
        slot = np.zeros(len(nids), dtype=np.int32)
        valid = mask.copy()
        for q in range(p_):
            sel = np.nonzero((owner == q) & mask)[0]
            take = sel[:h_]                     # the first H by position
            req[q, :len(take)] = offset[take]
            slot[take] = q * h_ + np.arange(len(take), dtype=np.int32)
            valid[sel[h_:]] = False
        return HaloPlan(req=req, slot=slot, valid=valid)


def halo_width_for(cap0: int, num_shards: int, slack: float = 1.5) -> int:
    """The static halo width: a balanced batch asks each owner for about
    ``cap0 / P`` rows; that times ``slack``, bucketed, at most ``cap0``."""
    w = int(slack * -(-cap0 // num_shards))
    return min(bucket_size(w, cap0), cap0)


def device_halo_plan(nids: torch.Tensor, mask: torch.Tensor, num_shards: int,
                     halo_width: int) -> HaloPlan:
    """:meth:`HaloPlanner.plan` on the device, with no host sync (a CUDA
    graph captures it): a request's rank among its owner's is the one-hot
    cumulative sum over ``[cap0, P]``; the requests past ``H`` are written
    to a spare row ``P`` of a ``[P + 1, H]`` buffer, which is cut off (the
    valid requests' ``(owner, rank)`` pairs are unique)."""
    p_, h_ = num_shards, halo_width
    ids = nids.long()
    owner = torch.where(mask, ids % p_, p_)
    offset = (ids // p_).to(torch.int32)
    onehot = owner[:, None] == torch.arange(p_, device=ids.device)[None, :]
    rank = torch.where(onehot, onehot.cumsum(0) - 1, 0).sum(1)
    valid = mask & (rank < h_)
    at = torch.where(valid, owner * h_ + rank, p_ * h_)
    req = torch.zeros((p_ + 1) * h_, dtype=torch.int32, device=ids.device)
    req.index_put_((at,), offset)
    return HaloPlan(req=req[:p_ * h_].view(p_, h_),
                    slot=torch.where(valid, owner * h_ + rank, 0).to(torch.int32),
                    valid=valid)


class HaloExchange:
    """The two-collective exchange over this rank's ``shard`` ``[shard_rows,
    D]`` (f32, bf16 or int8) at halo width ``H``, in the process group
    ``group`` (default: the default group), its buffers allocated once:
    the received requests int32 ``[P * H]``, the rows sent and received
    ``[P * H, D]`` at the shard's dtype, and one zero row.  ``scale``: the
    int8 tier's f32 ``[D]`` dequant scale."""

    def __init__(self, shard: torch.Tensor, halo_width: int, *,
                 group: Optional[dist.ProcessGroup] = None,
                 scale: Optional[torch.Tensor] = None):
        self.shard, self.halo_width, self.group, self.scale = shard, halo_width, group, scale
        self.world_size = dist.get_world_size(group)
        n, d = self.world_size * halo_width, shard.shape[1]
        dev = shard.device
        self.recv_req = torch.empty(n, dtype=torch.int32, device=dev)
        self.send = torch.empty((n, d), dtype=shard.dtype, device=dev)
        self.recv = torch.empty((n, d), dtype=shard.dtype, device=dev)
        self.zero_row = torch.zeros((1, d), dtype=shard.dtype, device=dev)
        self.calls = 0

    @property
    def bytes_per_step(self) -> int:
        """What one exchange sends from this rank: the requests and the
        rows (it receives as much)."""
        return self.recv_req.nbytes + self.send.nbytes

    def __call__(self, req: torch.Tensor, src_row: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``[cap0, D]`` layer-0 rows in batch order as ``out_dtype`` (f32 or
        bf16), from ``req`` int32 ``[P, H]`` and :func:`src_rows`."""
        dist.all_to_all_single(self.recv_req, req.reshape(-1), group=self.group)
        torch.index_select(self.shard, 0, self.recv_req, out=self.send)
        dist.all_to_all_single(self.recv, self.send, group=self.group)
        self.calls += 1
        return assemble(self.recv, src_row, self.zero_row, self.scale, out_dtype)


def exchange_features(shard: torch.Tensor, plan: HaloPlan, *,
                      group: Optional[dist.ProcessGroup] = None,
                      scale: Optional[torch.Tensor] = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One exchange of ``plan`` (its arrays on ``shard``'s device) through a
    fresh :class:`HaloExchange`: ``[cap0, D]`` rows, the invalid ones 0."""
    ex = HaloExchange(shard, plan.req.shape[1], group=group, scale=scale)
    return ex(plan.req, src_rows(plan), out_dtype)
