"""The dataset generator gives the configuration's counts exactly, the same
arrays from the same data seed, and a symmetric graph without self-loops
(at a small stand-in size, on the CPU)."""
import numpy as np
import pytest
import torch

from gnnbench import data

SMALL = {"num_nodes": 5000, "num_edges": 2 * 60000, "feat_dim": 24, "num_classes": 7,
         "split": {"train": 800, "val": 300, "test": 2500}, "rmat": [0.57, 0.19, 0.19],
         "data_seed": 9}


@pytest.fixture(scope="module")
def arrays():
    return data.generate(SMALL)


def test_published_counts(arrays):
    n = SMALL["num_nodes"]
    assert set(arrays) == set(data.ARRAYS)
    assert arrays["indptr"].shape == (n + 1,) and arrays["indptr"][-1] == SMALL["num_edges"]
    assert arrays["indices"].shape == (SMALL["num_edges"],)
    assert arrays["indices"].dtype == np.int32 and arrays["indptr"].dtype == np.int64
    assert arrays["features"].shape == (n, SMALL["feat_dim"])
    assert arrays["features"].dtype == np.float32
    assert arrays["labels"].shape == (n,) and arrays["labels"].max() < SMALL["num_classes"]
    for k, v in SMALL["split"].items():
        assert len(arrays[k]) == v
    ids = np.concatenate([arrays["train"], arrays["val"], arrays["test"]])
    assert len(np.unique(ids)) == len(ids)
    assert (arrays["out_degrees"] == np.bincount(arrays["indices"], minlength=n)).all()


def test_symmetric_no_self_loops_sorted_rows(arrays):
    n, ip, ix = SMALL["num_nodes"], arrays["indptr"], arrays["indices"]
    dst = np.repeat(np.arange(n), np.diff(ip))
    assert (dst != ix).all()
    fwd = np.sort(dst.astype(np.int64) * n + ix)
    back = np.sort(ix.astype(np.int64) * n + dst)
    assert (fwd == back).all() and len(np.unique(fwd)) == len(fwd)
    key = dst.astype(np.int64) * n + ix
    assert (np.diff(key) > 0).all()


def test_labels_are_the_linear_projection(arrays):
    # a skewed degree distribution and labels spread over the classes
    deg = np.diff(arrays["indptr"])
    assert deg.max() > 20 * deg.mean()
    assert np.bincount(arrays["labels"]).min() > 0


def test_same_seed_same_arrays_other_seed_other_graph(arrays):
    again = data.generate(SMALL)
    assert all((arrays[k] == again[k]).all() for k in data.ARRAYS)
    other = data.generate({**SMALL, "data_seed": 10})
    assert not np.array_equal(arrays["indices"], other["indices"])


def test_dense_graph_reaches_its_count():
    # Reddit's density: mean degree 492 over few vertices needs several rounds
    keys = data.rmat_undirected(4000, 984000, torch.Generator().manual_seed(3))
    assert keys.numel() == torch.unique(keys).numel() == 984000
    lo, hi = keys // 4000, keys % 4000
    assert (lo < hi).all()


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_reference_partition_is_the_programs(arrays, hops):
    # the reference's closure and the program's (partition/utils.py) agree
    from pagraph_tpu_torch.graph import CSRGraph
    from pagraph_tpu_torch.partition.utils import extract_partition

    from gnnbench.reference.partition import closure

    g = CSRGraph(arrays["indptr"], arrays["indices"], arrays["out_degrees"])
    mine = arrays["train"][::3]
    art = extract_partition(g, mine, arrays["labels"], hops, backend="numpy")
    l2f, ip, ix, tl = closure(torch.from_numpy(arrays["indptr"]),
                              torch.from_numpy(arrays["indices"]), torch.from_numpy(mine), hops)
    assert (l2f.numpy() == art.local2full).all() and (ip.numpy() == art.graph.indptr).all()
    assert (ix.numpy() == art.graph.indices).all() and (tl.numpy() == art.train_nids).all()
