"""The benchmark's datasets: a graph, features, labels and a split made on
the run's device from a configuration's own ``data_seed``, in a few large
torch calls, anew in every run (a few seconds on the card; nothing is
written to disk).  The same seed on the same kind of device gives the same
arrays.

The graph is R-MAT (Chakrabarti et al., SDM'04) with the Graph500 quadrant
probabilities ``a, b, c = 0.57, 0.19, 0.19`` over ``2**scale`` ids, the
smallest power of two that holds the published vertex count.  Pairs with an
endpoint past the vertex count and self-loops are dropped, each pair is
made undirected (``min, max``) and deduplicated, and rounds of fresh draws
(sized by the last round's yield of new pairs) continue until there are at
least the published number of undirected edges; a seeded choice then keeps
exactly that many.  Vertex ids are permuted (as Graph500 does, so that id
order says nothing of degree), and each undirected edge is stored both
ways: the in-neighbor CSR has exactly the published directed edge count,
each row sorted.

Features are standard normal float32; labels are the argmax of the features
times a standard normal ``[dim, classes]`` projection (cheap, and not
learnable from the graph: learnability is not what the benchmark measures);
the split is a seeded permutation cut at the published train, val and test
counts.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

ARRAYS = ("indptr", "indices", "out_degrees", "features", "labels", "train", "val", "test")
_CHUNK = 1 << 25          # R-MAT draws a pass


def _rmat_keys(n_draws: int, scale: int, a: float, b: float, c: float, num_nodes: int,
               gen: torch.Generator) -> torch.Tensor:
    """Undirected keys ``lo * N + hi`` of ``n_draws`` R-MAT draws, the dropped
    pairs (an endpoint past ``num_nodes``, or a self-loop) left out."""
    dev = gen.device
    u = torch.zeros(n_draws, dtype=torch.int64, device=dev)
    v = torch.zeros(n_draws, dtype=torch.int64, device=dev)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = torch.rand(n_draws, generator=gen, device=dev)
        u.mul_(2).add_(r >= ab)
        v.mul_(2).add_(((r >= a) & (r < ab)) | (r >= abc))
    keep = (u < num_nodes) & (v < num_nodes) & (u != v)
    u, v = u[keep], v[keep]
    return torch.minimum(u, v) * num_nodes + torch.maximum(u, v)


def rmat_undirected(num_nodes: int, num_pairs: int, gen: torch.Generator, *, a: float = 0.57,
                    b: float = 0.19, c: float = 0.19) -> torch.Tensor:
    """Exactly ``num_pairs`` distinct undirected pairs: sorted int64 keys ``lo *
    N + hi`` (``lo < hi``), before the vertex permutation."""
    scale = max(1, int(np.ceil(np.log2(num_nodes))))
    if num_pairs > num_nodes * (num_nodes - 1) // 2:
        raise ValueError(f"{num_pairs} pairs do not fit {num_nodes} vertices")
    have = torch.zeros(0, dtype=torch.int64, device=gen.device)
    gain = 0.5                     # new distinct pairs a draw gave in the last round
    for _ in range(64):
        if have.numel() >= num_pairs:
            break
        draw = int((num_pairs - have.numel()) / max(gain, 0.01) * 1.05) + 4096
        parts = [have] + [_rmat_keys(min(_CHUNK, draw - at), scale, a, b, c, num_nodes, gen)
                          for at in range(0, draw, _CHUNK)]
        before = have.numel()
        have = torch.unique(torch.cat(parts))
        gain = (have.numel() - before) / draw
    else:
        raise RuntimeError("R-MAT did not reach the edge count in 64 rounds")
    if have.numel() > num_pairs:
        drop = torch.randperm(have.numel(), generator=gen, device=gen.device)
        keep = torch.ones(have.numel(), dtype=torch.bool, device=gen.device)
        keep[drop[:have.numel() - num_pairs]] = False
        have = have[keep]
    return have


def generate(data: dict, device="cpu") -> Dict[str, np.ndarray]:
    """Every array of a configuration's ``data`` section (``num_nodes``,
    ``num_edges`` directed, ``feat_dim``, ``num_classes``, ``split`` counts,
    ``rmat`` ``[a, b, c]``, ``data_seed``), made on ``device``, as numpy."""
    n = int(data["num_nodes"])
    if data["num_edges"] % 2:
        raise ValueError("a symmetric graph has an even directed edge count")
    counts = data["split"]
    if sum(counts.values()) > n:
        raise ValueError(f"split {counts} exceeds {n} vertices")
    gen = torch.Generator(device=device).manual_seed(int(data["data_seed"]))
    a, b, c = data["rmat"]
    keys = rmat_undirected(n, data["num_edges"] // 2, gen, a=a, b=b, c=c)
    perm = torch.randperm(n, generator=gen, device=gen.device)
    lo, hi = perm[keys // n], perm[keys % n]
    del keys
    directed = torch.sort(torch.cat([hi * n + lo, lo * n + hi])).values     # dst * N + src
    del lo, hi
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=gen.device)
    torch.cumsum(torch.bincount(directed // n, minlength=n), 0, out=indptr[1:])
    indices = (directed % n).to(torch.int32)
    del directed
    feats = torch.randn((n, int(data["feat_dim"])), generator=gen, device=gen.device)
    w = torch.randn((int(data["feat_dim"]), int(data["num_classes"])), generator=gen,
                    device=gen.device)
    w = w.double()             # float64: no TF32 setting can change a label
    labels = torch.cat([torch.argmax(feats[at:at + (1 << 18)].double() @ w, dim=1)
                        for at in range(0, n, 1 << 18)])
    split = torch.randperm(n, generator=gen, device=gen.device)
    out = {"indptr": indptr, "indices": indices,
           "out_degrees": torch.bincount(indices.long(), minlength=n).to(torch.int32),
           "features": feats, "labels": labels}
    at = 0
    for name in ("train", "val", "test"):
        out[name] = torch.sort(split[at:at + counts[name]]).values
        at += counts[name]
    return {k: v.cpu().numpy() for k, v in out.items()}
