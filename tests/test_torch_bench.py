"""``bench_torch.py`` (the port of ``bench.py``) against ``bench.py`` on
the CPU: a phase's output keys, miss rate and miss rows equal to
``bench.run``'s on the same tiny graph, and ``main``'s one JSON line in
``bench.py``'s schema (its ``build_result`` keys, from ``bench.main`` on the
same phase results) plus the card's name and power limit."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pagraph_tpu.data.synthetic import synthetic_dataset as jsynthetic
from pagraph_tpu_torch.data.synthetic import synthetic_dataset as tsynthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS_KW = dict(num_nodes=3000, num_edges=24000, feat_dim=100, num_classes=47, seed=3,
             kind="rmat")


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def benches():
    return _load("bench_torch_under_test", "bench_torch.py"), _load("bench_jax_reference",
                                                                    "bench.py")


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_run_matches_bench_py(benches):
    """The partial-cache phase with its probe: the same keys; the miss rate
    equal (the same native sampler's batches at the same capacity), and
    ``miss_rows_last_epoch`` the last epoch's misses, which JAX's cache
    holds when its probe starts."""
    bt, jb = benches
    tds, jds = tsynthetic(**DS_KW), jsynthetic(**DS_KW)
    cap = int(tds.num_nodes * 0.4)
    t = bt.run(tds, cache_enabled=True, epochs=2, capacity=cap, hit_probe=True, device="cpu")
    seen = {}
    probe = jb._hit_path_probe

    def recording_probe(tr, K=17):
        seen["miss_rows"] = int(tr.cache.miss_num)
        return probe(tr, K)
    jb._hit_path_probe = recording_probe
    try:
        j = jb.run(jds, cache_enabled=True, epochs=2, capacity=cap, hit_probe=True)
    finally:
        jb._hit_path_probe = probe
    assert set(t) == set(j) and set(t["probe"]) == set(j["probe"])
    assert t["miss_rate"] == j["miss_rate"] > 0
    assert t["probe"]["miss_rows_last_epoch"] == seen["miss_rows"] > 0
    assert t["probe"]["hit_step_ms"] is None         # no device time on the CPU
    assert t["probe"]["miss_mb_last_epoch"] == round(seen["miss_rows"] * 100 * 4 / 1e6, 1)
    assert np.isfinite(t["final_loss"]) and t["edges_per_s"] > 0
    assert {"step"} <= set(t["timers"])


def test_on_device_run_on_the_cpu(benches):
    bt, jb = benches
    out = bt.run(tsynthetic(**DS_KW), cache_enabled=True, epochs=2, on_device=True,
                 device="cpu")
    assert set(out) == {"epoch_time_s", "edges_per_s", "miss_rate", "final_loss",
                        "final_acc", "timers"}
    assert out["miss_rate"] == 0.0 and np.isfinite(out["final_loss"])


def _canned_run(cache_enabled, epochs, capacity=None, on_device=False,
                cache_dtype="float32", paired=False, hit_probe=False, **_):
    """Deterministic phase results, so both mains print comparable lines."""
    eps = (1e6 * (2 if on_device else 1) * (1.3 if paired else 1)
           * (1.1 if cache_dtype == "bfloat16" else 1) * (1 if cache_enabled else 0.25)
           * (0.5 if capacity else 1))
    out = {"epoch_time_s": 1e7 / eps, "edges_per_s": eps,
           "miss_rate": 0.2 if capacity else 0.0, "final_loss": 3.5, "final_acc": 0.125,
           "timers": {}}
    if hit_probe and not on_device:
        out["probe"] = {"hit_step_ms": 0.5, "miss_rows_last_epoch": 100,
                        "miss_mb_last_epoch": 0.04}
    return out


@pytest.mark.parametrize("phases", [None, "baseline,partial,full,device,paired,mlp,bf16",
                                    "full", "device,paired"])
def test_main_prints_bench_py_schema_plus_the_card(benches, monkeypatch, capsys, tmp_path,
                                                   phases):
    bt, jb = benches
    import pagraph_tpu.models.mlp_probe as jmlp
    import pagraph_tpu.utils.platform as jplatform
    import pagraph_tpu_torch.models.mlp_probe as tmlp
    import pagraph_tpu_torch.utils.platform as tplatform

    tds = tsynthetic(num_nodes=200, num_edges=1000, feat_dim=8, num_classes=3)
    jds = jsynthetic(num_nodes=200, num_edges=1000, feat_dim=8, num_classes=3)
    if phases is None:
        monkeypatch.delenv("PAGRAPH_BENCH_PHASES", raising=False)
    else:
        monkeypatch.setenv("PAGRAPH_BENCH_PHASES", phases)
    monkeypatch.setenv("PAGRAPH_BENCH_DATA", str(tmp_path))
    monkeypatch.setenv("PAGRAPH_BENCH_FAST_PRNG", "0")
    card = {"device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
            "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    for mod, ds in ((bt, tds), (jb, jds)):
        monkeypatch.setattr(mod, "run", lambda d, **kw: _canned_run(**kw))
        monkeypatch.setattr(mod, "build_dataset", lambda cache_dir, ds=ds: ds)
        monkeypatch.setattr(mod, "arm_watchdog", lambda seconds: None)
    monkeypatch.setattr(bt, "card_identity", lambda: card)
    tuned = []
    monkeypatch.setattr(tplatform, "tune_host_allocator", tuned.append)
    monkeypatch.setattr(jplatform, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(jmlp, "mlp_val_acc", lambda *a, **k: 0.3)
    monkeypatch.setattr(tmlp, "mlp_val_acc", lambda *a, **k: 0.3)
    lines = []
    for mod in (bt, jb):
        capsys.readouterr()
        mod.main()
        out = capsys.readouterr().out.strip().splitlines()
        assert len(out) == 1
        lines.append(json.loads(out[0]))
    t, j = lines
    assert tuned == [1 << 30]
    assert t["metric"] == j["metric"] == "edges_per_s_per_chip"
    t_detail = dict(t["detail"])
    assert t_detail.pop("device") == card["device"]
    assert t_detail.pop("power_limit_w") == 700.0
    assert _keys(t_detail) == _keys(j["detail"])
    assert _keys({**t, "detail": t_detail}) == _keys(j)
    acc_t, acc_j = t_detail.pop("accuracy_control", None), j["detail"].pop("accuracy_control", None)
    assert (acc_t is None) == (acc_j is None)
    assert t_detail == j["detail"]          # the same numbers from the same phase results
    assert {k: t[k] for k in ("value", "unit", "vs_baseline")} == {
        k: j[k] for k in ("value", "unit", "vs_baseline")}


def test_build_result_keys(benches):
    bt, _ = benches
    ds = tsynthetic(num_nodes=200, num_edges=1000, feat_dim=8, num_classes=3)
    card = {"device": "card", "power_limit_w": 350.0}
    runs = {k: _canned_run(True, 2, capacity=80 if k == "partial" else None,
                           on_device=k == "device", hit_probe=k == "partial")
            for k in ("partial", "full", "device")}
    base = _canned_run(False, 2)
    r = bt.build_result(ds, base, runs["partial"], runs["full"], runs["device"], card)
    assert set(r) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert set(r["detail"]) == {
        "workload", "epoch_time_s", "epochs_per_hr", "cache_hit_rate",
        "baseline_edges_per_s", "partial_cache_40pct", "host_pipeline_edges_per_s",
        "on_device_edges_per_s", "device", "power_limit_w"}
    assert set(r["detail"]["partial_cache_40pct"]) == {
        "edges_per_s", "hit_rate", "hit_step_ms", "miss_rows_last_epoch", "miss_mb_last_epoch"}
    assert r["value"] == round(runs["device"]["edges_per_s"], 1)   # the faster path
    assert r["vs_baseline"] == round(runs["device"]["edges_per_s"] / base["edges_per_s"], 3)


def test_bench_needs_a_card(benches, monkeypatch):
    bt, _ = benches
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.card_identity()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.run(tsynthetic(num_nodes=200, num_edges=1000, feat_dim=100, num_classes=47),
               cache_enabled=False, epochs=1)
