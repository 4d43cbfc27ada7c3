"""The port's offline and serving CLIs (``pagraph_tpu_torch.cli``:
``preprocess``, ``convert``, ``partition``, ``verify_partition``,
``analyze``, ``eval``, ``infer``) against ``pagraph_tpu.cli``'s on the CPU,
each command run by both packages on the same argv:

* the flag surface of each parser, action for action, the port's device
  commands (``eval``, ``infer``, ``analyze load-break``) adding
  ``--cpu-devices`` and nothing else;
* ``preprocess``, ``convert`` and ``partition`` write array-equal files
  (``partition --ordering`` rewrites its own copy of the dataset), and
  ``partition``, ``verify_partition`` and ``analyze count-vnum`` /
  ``cache-oracle`` print equal lines; ``analyze load-break`` its keys,
  batches and miss rate;
* ``eval`` and ``infer`` on a checkpoint trained by JAX's ``cli.train``
  and converted into the port's (``convert.params_from_jax``,
  ``train.checkpoint.save_checkpoint``), on both of the port's backends:
  logits within 1e-5 of each row's largest, predictions equal where JAX's
  top-two margin exceeds 1e-4, accuracies equal;
* the device commands raise "no CUDA device" without a card unless
  ``--cpu-devices`` is given.

The dataset is ``tests/test_cli.py``'s: 400 vertices, 3000 edges, 16-dim
features, 5 learnable classes."""
import argparse
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import scipy.sparse as spsp
import torch

import pagraph_tpu as pg
from pagraph_tpu.cli import analyze as janalyze
from pagraph_tpu.cli import convert as jconvert
from pagraph_tpu.cli import eval as jeval
from pagraph_tpu.cli import infer as jinfer
from pagraph_tpu.cli import partition as jpartition
from pagraph_tpu.cli import preprocess as jpreprocess
from pagraph_tpu.cli import verify_partition as jverify
from pagraph_tpu.data.formats import load_dataset as jload
from pagraph_tpu_torch.cli import analyze as tanalyze
from pagraph_tpu_torch.cli import common as tcommon
from pagraph_tpu_torch.cli import convert as tconvert
from pagraph_tpu_torch.cli import eval as teval
from pagraph_tpu_torch.cli import infer as tinfer
from pagraph_tpu_torch.cli import partition as tpartition
from pagraph_tpu_torch.cli import preprocess as tpreprocess
from pagraph_tpu_torch.cli import verify_partition as tverify
from pagraph_tpu_torch.data.formats import load_dataset as tload
from tests.test_torch_sampler import jax_model_fields

PAIRS = {"preprocess": (jpreprocess, tpreprocess), "convert": (jconvert, tconvert),
         "partition": (jpartition, tpartition), "verify_partition": (jverify, tverify),
         "analyze": (janalyze, tanalyze), "eval": (jeval, teval), "infer": (jinfer, tinfer)}
DEVICE_FLAG = ("--cpu-devices",)
CPU = ["--cpu-devices", "1"]
DS_FILES = ("adj.npz", "feat.npy", "labels.npy", "train.npy", "val.npy", "test.npy")
PART_FILES = ("subadj_{}.npz", "sub_trainid_{}.npy", "sub_train2fullid_{}.npy",
              "sub_label_{}.npy")


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    """The JAX CLI tests' dataset (tests/test_cli.py): 400 vertices, 3000
    edges, 16-dim features, 5 learnable classes."""
    out = str(tmp_path_factory.mktemp("ds") / "d")
    jpreprocess.main([
        "--out", out, "--gen", "uniform", "--vnum", "400", "--enum", "3000",
        "--feat-size", "16", "--num-classes", "5", "--learnable-labels",
    ])
    return out


@pytest.fixture(autouse=True)
def _cold_allocator(monkeypatch):
    """The CLIs warm host heap once a process; not in the test's."""
    import pagraph_tpu_torch.utils.platform as tplatform
    monkeypatch.setattr(tplatform, "tune_host_allocator", lambda *a, **k: None)


def _line(text):
    return json.loads([ln for ln in text.strip().splitlines() if ln.startswith("{")][-1])


def _arrays_equal(a, b):
    """Two saved files (.npy, or .npz key by key) hold equal arrays."""
    la, lb = np.load(a), np.load(b)
    if a.endswith(".npz"):
        assert sorted(la.files) == sorted(lb.files), (a, b)
        for k in la.files:
            np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{a}:{k}")
    else:
        assert la.dtype == lb.dtype, (a, b)
        np.testing.assert_array_equal(la, lb, err_msg=a)


def _datasets_equal(want_dir, got_dir):
    want, got = jload(want_dir), tload(got_dir)
    for name in ("indptr", "indices", "out_degrees"):
        np.testing.assert_array_equal(getattr(got.graph, name), getattr(want.graph, name))
    for name in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for f in DS_FILES:
        _arrays_equal(os.path.join(want_dir, f), os.path.join(got_dir, f))


# -- the flag surface ----------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, argv=("x",)):
    """The parser ``main`` builds, caught at its ``parse_args``."""
    seen = []

    def record(self, *a, **k):
        seen.append(self)
        raise _Parsed

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = record
    try:
        with pytest.raises(_Parsed):
            main(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen[0]


def _flags(p):
    """Every action of ``p`` (a subcommand's own, recursively)."""
    out = {}
    for a in p._actions:
        if a.dest == "help":
            continue
        if isinstance(a, argparse._SubParsersAction):
            out[a.dest] = {name: _flags(sp) for name, sp in a.choices.items()}
        else:
            out[a.dest] = (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs,
                           a.required)
    return out


@pytest.mark.parametrize("name", list(PAIRS))
def test_flag_surface_equals_jax(name):
    jmod, tmod = PAIRS[name]
    want, got = _flags(_parser_of(jmod.main)), _flags(_parser_of(tmod.main))
    if name in ("eval", "infer"):
        assert got.pop("cpu_devices")[:2] == (DEVICE_FLAG, 0)
    if name == "analyze":
        assert got["cmd"]["load-break"].pop("cpu_devices")[:2] == (DEVICE_FLAG, 0)
    assert got == want


# -- preprocess and convert ------------------------------------------------------------

def _edge_file(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "edges.txt"
    e = rng.integers(0, 150, size=(900, 2))
    path.write_text("# src dst\n" + "\n".join(f"{s} {d}" for s, d in e) + "\n")
    return str(path)


@pytest.mark.parametrize("argv", [
    ["--gen", "uniform", "--vnum", "300", "--enum", "1500"],
    ["--gen", "uniform", "--vnum", "300", "--learnable-labels", "--seed", "4"],
    ["--gen", "uniform", "--vnum", "300", "--enum", "2000", "--neighborhood-labels"],
    ["--gen", "rmat", "--scale", "8", "--train-frac", "0.5", "--val-frac", "0.2"],
    ["--ppfile", "EDGES", "--learnable-labels"],
    ["--ppfile", "EDGES", "--directed"],
], ids=["uniform", "learnable", "neighborhood", "rmat", "ppfile", "ppfile_directed"])
def test_preprocess_writes_jax_files(argv, tmp_path):
    argv = [_edge_file(tmp_path) if a == "EDGES" else a for a in argv]
    argv += ["--feat-size", "12", "--num-classes", "4"]
    jpreprocess.main(["--out", str(tmp_path / "j")] + argv)
    tpreprocess.main(["--out", str(tmp_path / "t")] + argv)
    _datasets_equal(str(tmp_path / "j"), str(tmp_path / "t"))


def test_preprocess_needs_a_source(tmp_path, capsys):
    for main in (tpreprocess.main, jpreprocess.main):
        with pytest.raises(SystemExit) as e:
            main(["--out", str(tmp_path / "x")])
        assert e.value.code == 2
        assert "need --ppfile or --gen" in capsys.readouterr().err


def _npz_source(ds_dir, src, feat_rows=None):
    """tests/test_cli.py's npz layout: adj.npz with feat.npy and labels.npy."""
    ds = jload(ds_dir)
    src.mkdir()
    spsp.save_npz(str(src / "adj.npz"), ds.graph.to_coo())
    np.save(str(src / "feat.npy"), ds.features[:feat_rows])
    np.save(str(src / "labels.npy"), ds.labels)
    return ["--from-npz", str(src / "adj.npz")]


def _reddit_source(src):
    """tests/test_cli.py's synthesized DGL-Reddit payload."""
    rng = np.random.default_rng(0)
    n = 300
    coo = spsp.random(n, n, density=0.02, format="coo", rng=rng, dtype=np.float32)
    src.mkdir()
    np.savez(src / "reddit_data.npz", feature=rng.random((n, 16), dtype=np.float32),
             label=rng.integers(0, 5, size=n),
             node_types=rng.choice([1, 2, 3], size=n, p=[0.65, 0.1, 0.25]))
    spsp.save_npz(src / "reddit_graph.npz", coo.tocsr())
    return ["--from-dgl-reddit", str(src)]


def _ogb_source(src, split: bool):
    """tests/test_cli.py's synthesized OGB layout, with or without split/."""
    rng = np.random.default_rng(1)
    n, e = 200, 1500
    src.mkdir()
    np.save(src / "edge_index.npy", rng.integers(0, n, size=(2, e)).astype(np.int64))
    np.save(src / "node_feat.npy", rng.random((n, 8), dtype=np.float32))
    np.save(src / "node_label.npy", rng.integers(0, 4, size=n))
    if split:
        (src / "split").mkdir()
        perm = rng.permutation(n)
        np.save(src / "split" / "train.npy", perm[:120])
        np.save(src / "split" / "valid.npy", perm[120:150])
        np.save(src / "split" / "test.npy", perm[150:])
    return ["--from-ogb", str(src)]


@pytest.mark.parametrize("layout", ["npz", "dgl_reddit", "ogb_split", "ogb_no_split"])
def test_convert_writes_jax_files(layout, ds_dir, tmp_path):
    src = tmp_path / "src"
    argv = {"npz": lambda: _npz_source(ds_dir, src),
            "dgl_reddit": lambda: _reddit_source(src),
            "ogb_split": lambda: _ogb_source(src, True),
            "ogb_no_split": lambda: _ogb_source(src, False)}[layout]()
    jconvert.main(["--out", str(tmp_path / "j")] + argv)
    tconvert.main(["--out", str(tmp_path / "t")] + argv)
    _datasets_equal(str(tmp_path / "j"), str(tmp_path / "t"))


def test_convert_row_mismatch_raises_jax_error(ds_dir, tmp_path):
    argv = _npz_source(ds_dir, tmp_path / "src", feat_rows=399)
    errors = []
    for main, out in ((jconvert.main, "j"), (tconvert.main, "t")):
        with pytest.raises(ValueError) as e:
            main(["--out", str(tmp_path / out)] + argv)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "features has 399 rows, graph has 400"


# -- partition and verify_partition -------------------------------------------------------

def _copies(ds_dir, tmp_path):
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(ds_dir, j)
    shutil.copytree(ds_dir, t)
    return j, t


@pytest.mark.parametrize("argv", [
    ["--method", "dg", "--assign-backend", "numpy"],
    ["--method", "dg", "--assign-backend", "native"],
    ["--method", "dg", "--assign-backend", "numpy", "--edge-balance"],
    ["--method", "dg", "--assign-backend", "native", "--edge-balance", "--partition", "3"],
    ["--method", "hash", "--seed", "3"],
    ["--method", "kl"],
    ["--method", "dg", "--ordering"],
], ids=["dg_numpy", "dg_native", "dg_numpy_edge", "dg_native_edge3", "hash", "kl",
        "dg_ordering"])
def test_partition_and_verify_equal_jax(argv, ds_dir, tmp_path, capsys):
    """Each package partitions its own copy of the dataset (``--ordering``
    rewrites it in place): equal datasets after, equal rank files,
    ``stats.json`` and lines; then ``verify_partition``'s lines equal."""
    j, t = _copies(ds_dir, tmp_path)
    argv = argv + ["--num-hops", "2"]
    jpartition.main(["--dataset", j] + argv)
    j_line = _line(capsys.readouterr().out)
    tpartition.main(["--dataset", t] + argv)
    t_line = _line(capsys.readouterr().out)
    assert t_line == j_line
    parts = int(argv[argv.index("--partition") + 1]) if "--partition" in argv else 2
    method = argv[argv.index("--method") + 1]
    assert j_line["num_parts"] == parts
    _datasets_equal(j, t)
    sub = f"partition_{parts}_{method}"
    assert sorted(os.listdir(os.path.join(t, sub))) == sorted(os.listdir(os.path.join(j, sub)))
    for r in range(parts):
        for f in PART_FILES:
            _arrays_equal(os.path.join(j, sub, f.format(r)), os.path.join(t, sub, f.format(r)))
    with open(os.path.join(j, sub, "stats.json")) as fj, \
            open(os.path.join(t, sub, "stats.json")) as ft:
        assert json.load(ft) == json.load(fj) == j_line

    vargv = ["--partition", str(parts), "--method", method, "--num-hops", "2"]
    jverify.main(["--dataset", j] + vargv)
    j_v = _line(capsys.readouterr().out)
    tverify.main(["--dataset", t] + vargv)
    t_v = _line(capsys.readouterr().out)
    assert t_v == j_v and t_v["coverage_ok"] and all(r["ok"] for r in t_v["partitions"])


def test_verify_partition_flags_a_dropped_edge(ds_dir, tmp_path, capsys, monkeypatch):
    """An in-edge of a train vertex dropped from ``subadj_0.npz``: both exit
    1 with the same errors.  ``--plot`` without matplotlib and networkx
    prints "plotting unavailable" and the checks decide the exit code."""
    j, t = _copies(ds_dir, tmp_path)
    argv = ["--partition", "2", "--method", "hash", "--num-hops", "2"]
    lines = []
    for main, d in ((jpartition.main, j), (tpartition.main, t)):
        main(["--dataset", d] + argv)
        path = os.path.join(d, "partition_2_hash", "subadj_0.npz")
        coo = spsp.load_npz(path).tocoo()
        train0 = np.load(os.path.join(d, "partition_2_hash", "sub_trainid_0.npy"))
        drop = int(np.nonzero(np.isin(coo.row, train0))[0][0])
        keep = np.arange(coo.nnz) != drop
        spsp.save_npz(path, spsp.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                                            shape=coo.shape))
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for main, d in ((jverify.main, j), (tverify.main, t)):
        with pytest.raises(SystemExit) as e:
            main(["--dataset", d, "--plot", str(tmp_path / "p.png")] + argv)
        assert e.value.code == 1
        out = capsys.readouterr()
        assert "plotting unavailable" in out.err
        lines.append(_line(out.out))
    assert lines[1] == lines[0]
    errors = lines[0]["partitions"][0]["errors"]
    assert not lines[0]["partitions"][0]["ok"] and errors
    assert errors[0].endswith("at depth 0 missing in-edges")
    assert not os.path.exists(tmp_path / "p.png")


# -- analyze --------------------------------------------------------------------------

@pytest.mark.parametrize("cmd", ["count-vnum", "cache-oracle"])
@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_analyze_host_commands_equal_jax(cmd, backend, ds_dir, capsys):
    argv = [cmd, "--dataset", ds_dir, "--batch-size", "64", "--num-neighbors", "3,2",
            "--n-layers", "1", "--sampler-backend", backend, "--seed", "2"]
    if cmd == "cache-oracle":
        argv += ["--top-frac", "0.3"]
    janalyze.main(argv)
    want = _line(capsys.readouterr().out)
    got = tanalyze.main(argv)
    assert _line(capsys.readouterr().out) == got == want


def test_analyze_synthetic_equals_jax(capsys):
    """``--synthetic N``: the same dataset as the JAX package builds."""
    argv = ["count-vnum", "--synthetic", "300", "--feat-size", "8", "--batch-size", "50",
            "--seed", "1"]
    janalyze.main(argv)
    want = _line(capsys.readouterr().out)
    assert tanalyze.main(argv) == want and want["batches"] > 0


@pytest.mark.parametrize("capacity", ["0", "160"])
def test_analyze_load_break_matches_jax(capacity, ds_dir, capsys):
    argv = ["load-break", "--dataset", ds_dir, "--batch-size", "64",
            "--cache-capacity", capacity]
    janalyze.main(argv)
    want = _line(capsys.readouterr().out)
    got = tanalyze.main(argv + CPU)
    assert _line(capsys.readouterr().out) == got
    assert set(got) == set(want) == {"batches", "sample_ms", "host_gather_ms", "h2d_ms",
                                      "miss_rate"}
    assert got["batches"] == want["batches"] > 0
    assert got["miss_rate"] == want["miss_rate"]
    assert (got["miss_rate"] == 1.0) == (capacity == "0")
    assert all(got[k] >= 0 for k in ("sample_ms", "host_gather_ms", "h2d_ms"))


def test_load_break_miss_rate_replays_its_batches(ds_dir, capsys):
    """``load-break``'s miss rate equals ``chip_smoke.py``'s numpy replay of
    its batches (a fresh sampler's epoch) against the cache's 160 highest
    out-degree vertices: the check its ``cli_tools`` phase makes at RMAT-20."""
    import pagraph_tpu_torch as pt
    from chip_smoke import replay_miss_rate

    ds = tload(ds_dir)
    got = tanalyze.main(["load-break", "--dataset", ds_dir, "--batch-size", "64",
                         "--cache-capacity", "160"] + CPU)
    sampler = pt.SamplerConfig(batch_size=64, fanout=2, num_hops=2, seed=0)
    assert 0.0 < got["miss_rate"] < 1.0
    assert got["miss_rate"] == replay_miss_rate(np, ds, sampler, 160)


# -- eval and infer on a converted checkpoint -------------------------------------------

MODELS = {
    "sage_mean": ["--arch", "graphsage", "--n-hidden", "8"],
    "gcn_preprocess": ["--arch", "gcn", "--n-hidden", "8", "--preprocess", "--n-layers", "2"],
    "gat": ["--arch", "gat", "--n-hidden", "8", "--num-heads", "2"],
}


@pytest.fixture(scope="module", params=list(MODELS))
def checkpoints(request, ds_dir, tmp_path_factory):
    """Two epochs of JAX's ``cli.train`` with a checkpoint each, and each
    checkpoint's params in a port checkpoint of the same name."""
    from pagraph_tpu.cli import train as jtrain
    from pagraph_tpu.train import checkpoint as jck
    from pagraph_tpu.train.state import create_state as jcreate
    from pagraph_tpu_torch.convert import params_from_jax
    from pagraph_tpu_torch.train import checkpoint as tck
    from pagraph_tpu_torch.train.state import create_state as tcreate

    model = MODELS[request.param]
    root = tmp_path_factory.mktemp(request.param)
    jdir, tdir = str(root / "jax"), str(root / "port")
    jtrain.main(["--dataset", ds_dir, "--batch-size", "64", "--num-neighbors", "2",
                 "--epochs", "2", "--lr", "0.01", "--ckpt-dir", jdir, "--ckpt-every", "1"]
                + model)
    p = argparse.ArgumentParser()
    tcommon.add_model_flags(p)
    args = p.parse_args(model)
    ds = jload(ds_dir)
    tcfg = tcommon.inference_config(args, feat_dim=ds.feat_dim, n_classes=ds.num_classes)
    jcfg = pg.Config(model=pg.ModelConfig(**jax_model_fields(vars(tcfg.model))),
                     sampler=pg.SamplerConfig(num_hops=tcfg.model.num_sampled_hops))
    template, _ = jcreate(jcfg)
    state = tcreate(tcfg, device="cpu")
    epochs = jck.list_checkpoints(jdir, args.arch)
    assert epochs == [0, 1]
    for e in epochs:
        js = jck.restore_checkpoint(jdir, args.arch, e, template)
        state.model.load_state_dict(params_from_jax(jax.device_get(js.params)))
        tck.save_checkpoint(tdir, args.arch, e, state)
    return model, jdir, tdir


@pytest.mark.parametrize("backend", ["host", "device"])
def test_eval_matches_jax(backend, checkpoints, ds_dir, capsys):
    model, jdir, tdir = checkpoints
    capsys.readouterr()
    want = jeval.main(["--dataset", ds_dir, "--ckpt-dir", jdir, "--backend", "host"] + model)
    j_out = capsys.readouterr().out
    got = teval.main(["--dataset", ds_dir, "--ckpt-dir", tdir, "--backend", backend]
                     + model + CPU)
    t_out = capsys.readouterr().out
    assert want is None and sorted(got) == [0, 1]
    assert _line(t_out) == _line(j_out) == {"results": {str(k): v for k, v in got.items()}}
    assert [ln for ln in t_out.splitlines() if ln.startswith("epoch")] == \
        [ln for ln in j_out.splitlines() if ln.startswith("epoch")]


@pytest.mark.parametrize("backend", ["host", "device"])
def test_infer_matches_jax(backend, checkpoints, ds_dir, tmp_path, capsys):
    model, jdir, tdir = checkpoints
    jp, tp = str(tmp_path / "j.npy"), str(tmp_path / "t.npy")
    want = jinfer.main(["--dataset", ds_dir, "--ckpt-dir", jdir, "--out", jp,
                        "--save-logits"] + model)
    got = tinfer.main(["--dataset", ds_dir, "--ckpt-dir", tdir, "--out", tp, "--save-logits",
                       "--backend", backend] + model + CPU)
    assert _line(capsys.readouterr().out) == got
    j_logits, t_logits = np.load(jp + ".logits.npy"), np.load(tp + ".logits.npy")
    j_preds, t_preds = np.load(jp), np.load(tp)
    assert t_logits.dtype == np.float32 and t_logits.shape == j_logits.shape
    assert t_logits.shape[0] == 400
    scale = np.abs(j_logits).max(axis=1, keepdims=True)
    assert (np.abs(t_logits - j_logits) <= 1e-5 * np.maximum(scale, 1.0)).all()
    top2 = np.sort(j_logits, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert clear.sum() > 350
    np.testing.assert_array_equal(t_preds[clear], j_preds[clear])
    np.testing.assert_array_equal(t_preds, t_logits.argmax(axis=1))
    assert t_preds.dtype == np.int64
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    assert got["epoch"] == 1 and got["out"] == tp


def test_infer_checkpoint_refusals_equal_jax(checkpoints, ds_dir, tmp_path):
    model, jdir, tdir = checkpoints
    for extra in (["--epoch", "7"], ["--ckpt-dir", str(tmp_path / "none")]):
        msgs = []
        for main, ck, tail in ((jinfer.main, jdir, []), (tinfer.main, tdir, CPU)):
            with pytest.raises(SystemExit) as e:
                main(["--dataset", ds_dir, "--ckpt-dir", ck, "--out",
                      str(tmp_path / "p.npy")] + model + extra + tail)
            msgs.append(str(e.value).replace(ck, "CK"))
        assert msgs[0] == msgs[1]
        assert "available: [0, 1]" in msgs[0] or "checkpoints under" in msgs[0]


# -- no silent CPU -------------------------------------------------------------------

def test_device_commands_need_a_card_unless_cpu_is_asked(ds_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = MODELS["sage_mean"]
    for main, argv in (
            (teval.main, ["--dataset", ds_dir, "--ckpt-dir", str(tmp_path)] + model),
            (tinfer.main, ["--dataset", ds_dir, "--ckpt-dir", str(tmp_path), "--out",
                           str(tmp_path / "p.npy")] + model),
            (tanalyze.main, ["load-break", "--dataset", ds_dir, "--batch-size", "64"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not os.path.exists(tmp_path / "p.npy")
