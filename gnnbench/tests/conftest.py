"""Fixtures of the benchmark's own tests: tiny cells that run the harness's
device path on the CPU, and the ``card`` marker for tests that need a CUDA
card (each decides inside its fixture, and skips without one)."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(arch: str, limits_from: str):
    """A small stand-in of a real cell: its own model shapes cut down, the
    real cell's limits."""
    from gnnbench.harness import load_cell

    wl, _ = load_cell(limits_from)
    wl = copy.deepcopy(wl)
    wl["name"] = f"tiny.{arch}"
    wl["trace_epochs"] = 1
    data = {"num_nodes": 3000, "num_edges": 40000, "feat_dim": 12, "num_classes": 5,
            "split": {"train": 700, "val": 100, "test": 1000},
            "rmat": [0.57, 0.19, 0.19], "data_seed": 4}
    if arch == "graphsage":
        model = {"arch": "graphsage", "n_layers": 2, "hidden": 16, "feat_dim": 12,
                 "n_classes": 5, "dropout": 0.5, "aggregator": "mean",
                 "skip_connection": False}
        sampler = {"batch_size": 128, "fanouts": [3, 4, 5]}
    else:
        model = {"arch": "gcn", "n_layers": 1, "hidden": 8, "feat_dim": 12, "n_classes": 5,
                 "dropout": 0.2, "skip_connection": True}
        sampler = {"batch_size": 128, "fanouts": [2, 2]}
    cfg = {"name": f"tiny-{arch}", "data": data, "model": model, "sampler": sampler,
           "train": {"lr": 0.003, "dtype": "float32"}}
    return wl, cfg


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gnnbench_cache"))


@pytest.fixture(params=[("graphsage", "sage-products.device"), ("gcn", "gcn-reddit.device")],
                ids=["sage", "gcn"])
def tiny(request):
    return tiny_cell(*request.param)
