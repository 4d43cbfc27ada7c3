"""Neighbor sampling on the host CPU (numpy; the port of
``pagraph_tpu/sampling/sampler.py``).

Fixed fan-out with per-edge validity masks keeps every produced
:class:`MiniBatch` statically shaped.  Sampling policy per destination vertex
with in-degree ``d``:
  * ``d == 0``            -> all ``fanout`` slots masked out;
  * ``0 < d <= fanout``   -> take all ``d`` in-neighbors;
  * ``d > fanout``        -> ``fanout`` uniform draws **with replacement**.

Two backends, as in the JAX package: ``"numpy"`` (below; same seed, same
draws: batches identical to ``pagraph_tpu``'s ``backend="numpy"``) and
``"native"``, the C++/OpenMP sampler of ``csrc/host_native.cpp``
(:mod:`.native`), whose batches are bit-equal to ``pagraph_tpu``'s native
sampler from the same per-batch seed.  ``"auto"`` takes the native one and
falls back to numpy only where the JAX package does: when the library
cannot be built or loaded (or the config needs ``include_self=False``),
with a warning.  ``NeighborSampler.backend_name`` says which one runs.
"""
from __future__ import annotations

import warnings
from typing import Iterator, Optional, Sequence

import numpy as np

from ..config import SamplerConfig
from ..graph import CSRGraph
from .block import Block, MiniBatch, pad_1d, validity_mask


def _sample_fanout(
    graph: CSRGraph, dst: np.ndarray, fanout: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``fanout`` in-neighbors per dst vertex.

    Returns ``(nbr_ids int64 [n, fanout], mask bool [n, fanout])``.
    """
    n = len(dst)
    starts = graph.indptr[dst]
    deg = (graph.indptr[dst + 1] - starts).astype(np.int64)
    safe_deg = np.maximum(deg, 1)
    k = np.arange(fanout, dtype=np.int64)[None, :]
    small = deg[:, None] <= fanout                  # take-all regime
    draws = rng.integers(0, np.iinfo(np.int64).max, size=(n, fanout))
    offs = np.where(small, k % safe_deg[:, None], draws % safe_deg[:, None])
    # A vertex with no in-edges after the last edge row has indptr[v] == E;
    # its slots are all masked, so clip the read (pagraph_tpu's numpy sampler
    # raises IndexError there; every other read is unchanged).
    idx = np.minimum(starts[:, None] + offs, max(graph.num_edges - 1, 0))
    nbr = (graph.indices[idx].astype(np.int64) if graph.num_edges
           else np.zeros(idx.shape, dtype=np.int64))
    mask = np.where(small, k < deg[:, None], deg[:, None] > 0)
    return nbr, mask


def _pad_rows(arr: np.ndarray, cap: int) -> np.ndarray:
    if arr.shape[0] > cap:
        raise ValueError(f"{arr.shape[0]} rows exceed capacity {cap}")
    out = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def sample_minibatch(
    graph: CSRGraph,
    seeds: np.ndarray,
    config: SamplerConfig,
    caps: Sequence[int],
    rng: np.random.Generator,
    labels: Optional[np.ndarray] = None,
) -> MiniBatch:
    """Expand ``seeds`` by ``config.num_hops`` levels into a padded MiniBatch.

    ``caps[i]`` is the static capacity of layer i (0 = outermost).  If a
    layer's deduplicated vertex set exceeds its capacity, overflowing sampled
    vertices are dropped and their edges masked.
    """
    L = config.num_hops
    if len(caps) != L + 1:
        raise ValueError(f"{len(caps)} capacities for {L} hops")
    fanouts = config.hop_fanouts()
    seeds = np.asarray(seeds, dtype=np.int64)
    if len(seeds) > caps[-1]:
        raise ValueError(f"{len(seeds)} seeds exceed seed capacity {caps[-1]}")

    layer_ids = [seeds]            # seeds outward; reversed at the end
    blocks_rev = []
    cur = seeds
    for hop in range(L):
        cap_src = caps[L - hop - 1]
        nbr, mask = _sample_fanout(graph, cur, fanouts[hop], rng)
        # Deduplicate [cur ; sampled] in first-occurrence order so the dst
        # set occupies the prefix of the src layer.
        cand = np.concatenate([cur, nbr.ravel()])
        uniq_sorted, first_idx, inv_sorted = np.unique(
            cand, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank_of_sorted = np.empty_like(order)
        rank_of_sorted[order] = np.arange(len(order))
        pos = rank_of_sorted[inv_sorted]
        nxt = uniq_sorted[order]
        if len(nxt) > cap_src:
            nxt = nxt[:cap_src]
            overflow = pos >= cap_src
            pos = np.where(overflow, 0, pos)
            mask &= ~overflow[len(cur):].reshape(mask.shape)
        self_pos = pos[: len(cur)].astype(np.int32)
        neigh_pos = pos[len(cur):].reshape(len(cur), fanouts[hop]).astype(np.int32)
        neigh_pos = np.where(mask, neigh_pos, 0).astype(np.int32)
        cap_dst = caps[L - hop]
        blocks_rev.append(
            Block(
                neigh_pos=_pad_rows(neigh_pos, cap_dst),
                neigh_mask=_pad_rows(mask, cap_dst),
                self_pos=pad_1d(self_pos, cap_dst),
            )
        )
        layer_ids.append(nxt)
        cur = nxt

    layer_ids.reverse()
    blocks = tuple(reversed(blocks_rev))
    layer_nids = tuple(
        pad_1d(ids.astype(np.int32), caps[i]) for i, ids in enumerate(layer_ids)
    )
    layer_mask = tuple(
        validity_mask(len(ids), caps[i]) for i, ids in enumerate(layer_ids)
    )
    if labels is not None:
        lab = pad_1d(labels[seeds].astype(np.int32), caps[-1])
    else:
        lab = np.zeros(caps[-1], dtype=np.int32)
    return MiniBatch(
        layer_nids=layer_nids, layer_mask=layer_mask, blocks=blocks, labels=lab
    )


class NeighborSampler:
    """Iterator over an epoch of shuffled minibatches: shuffle the train
    vertices, chunk them into batches, expand each into a padded MiniBatch."""

    def __init__(
        self,
        graph: CSRGraph,
        train_nids: np.ndarray,
        config: SamplerConfig,
        labels: Optional[np.ndarray] = None,
        shuffle: bool = True,
        seed: Optional[int] = None,
        backend: Optional[str] = None,
        caps: Optional[Sequence[int]] = None,
    ):
        backend = backend or config.backend
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"unknown sampler backend {backend!r}")
        self.graph = graph
        self.train_nids = np.asarray(train_nids, dtype=np.int64)
        self.config = config
        self.labels = labels
        self.shuffle = shuffle
        self.caps = (tuple(caps) if caps is not None
                     else config.layer_capacities(graph.num_nodes))
        self.rng = np.random.default_rng(config.seed if seed is None else seed)
        self._native = None
        if backend != "numpy":
            try:
                self._native = self._native_sampler()
            except (RuntimeError, OSError, NotImplementedError) as e:
                if backend == "native":
                    raise
                warnings.warn(f"sampler backend 'auto' falls back to numpy: {e}",
                              RuntimeWarning, stacklevel=2)

    @property
    def backend_name(self) -> str:
        """The backend that samples: ``"native"`` or ``"numpy"``."""
        return "numpy" if self._native is None else "native"

    def _native_sampler(self):
        from .native import NativeSampler
        return NativeSampler(self.graph, self.config, self.caps)

    @property
    def num_batches(self) -> int:
        b = self.config.batch_size
        return (len(self.train_nids) + b - 1) // b

    def calibrate_caps(self, probes: int = 8, slack: float = 1.2,
                       pad: int = 256) -> tuple:
        """Shrink layer capacities from the worst case to observed occupancy.

        Worst-case caps (batch * (fanout+1)^hop) are pessimistic because
        deduplication collapses shared neighbors.  Probing a few batches and
        sizing to max*slack (rounded up to ``pad``) shrinks every device
        buffer and kernel proportionally.  Rare overflow later is handled by
        the sampler's edge-masking safety valve.
        """
        rng = np.random.default_rng(0xC0FFEE ^ self.config.seed)
        maxes = np.zeros(len(self.caps), dtype=np.int64)
        n = len(self.train_nids)
        for _ in range(probes):
            seeds = self.train_nids[
                rng.choice(n, size=min(self.config.batch_size, n),
                           replace=False)
            ]
            mb = self.sample(seeds)
            sizes = [int(m.sum()) for m in mb.layer_mask]
            maxes = np.maximum(maxes, sizes)
        new_caps = []
        for cap, mx in zip(self.caps, maxes):
            c = min(int(mx * slack + pad - 1) // pad * pad, cap)
            new_caps.append(max(c, 1))
        new_caps[-1] = self.caps[-1]          # seed layer stays batch-sized
        self.set_caps(tuple(new_caps))
        return self.caps

    def set_caps(self, caps: tuple) -> None:
        self.caps = tuple(int(c) for c in caps)
        if self._native is not None:
            self._native = self._native_sampler()

    def epoch(self) -> Iterator[MiniBatch]:
        order = (
            self.rng.permutation(len(self.train_nids))
            if self.shuffle
            else np.arange(len(self.train_nids))
        )
        nids = self.train_nids[order]
        b = self.config.batch_size
        for start in range(0, len(nids), b):
            yield self.sample(nids[start: start + b])

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        """One batch; the native backend draws a 31-bit seed for it from
        ``self.rng``, as the JAX package's does."""
        if self._native is not None:
            return self._native.sample(seeds, self.labels,
                                       int(self.rng.integers(0, 2**31 - 1)))
        return sample_minibatch(
            self.graph, seeds, self.config, self.caps, self.rng, self.labels
        )

    def __iter__(self) -> Iterator[MiniBatch]:
        return self.epoch()
