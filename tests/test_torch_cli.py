"""``pagraph_tpu_torch.cli`` against ``pagraph_tpu.cli`` on the CPU: the flag
surface and ``build_config`` field for field, the training CLI's summary
against JAX's on the same dataset and arguments, ``--partition`` as gloo
ranks spawned from one command and through ``cli.launch`` (equal lines),
``scalebench`` over rank counts, and the refusals.

``--cpu-devices N`` is the port's CPU run (up to N gloo ranks, one process
a rank), so each port command here passes it; on the CPU a cache needs a
capacity (the budget reads free GPU memory), hence ``--cache-capacity``."""
import argparse
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from pagraph_tpu.cli import common as jcommon
from pagraph_tpu_torch.cli import common as tcommon
from tests.test_torch_sampler import jax_fields

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY_KEYS = {"epochs", "mean_epoch_time_s", "final_loss", "final_acc", "miss_rate",
                "val_acc", "phase_timers"}
DP_KEYS = {"num_devices", "num_processes", "edges_per_epoch", "first_loss", "halo_drops"}
FLAG_GROUPS = ("add_model_flags", "add_sampler_flags", "add_cache_flags", "add_train_flags",
               "add_partition_flags", "add_multihost_flags")


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    """The JAX CLI tests' dataset (tests/test_cli.py): 400 vertices, 3000
    edges, 16-dim features, 5 learnable classes."""
    from pagraph_tpu.cli import preprocess

    out = str(tmp_path_factory.mktemp("ds") / "d")
    preprocess.main([
        "--out", out, "--gen", "uniform", "--vnum", "400", "--enum", "3000",
        "--feat-size", "16", "--num-classes", "5", "--learnable-labels",
    ])
    return out


@pytest.fixture(autouse=True)
def _cold_allocator(monkeypatch):
    """The CLIs warm 1 GiB of host heap once a process; not in the test's."""
    import pagraph_tpu_torch.utils.platform as tplatform
    monkeypatch.setattr(tplatform, "tune_host_allocator", lambda *a, **k: None)


def _parser(mod):
    p = argparse.ArgumentParser()
    for g in FLAG_GROUPS:
        getattr(mod, g)(p)
    return p


def _flags(p):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs)
            for a in p._actions if a.dest != "help"}


def test_flag_surface_equals_jax():
    assert _flags(_parser(tcommon)) == _flags(_parser(jcommon))


@pytest.mark.parametrize("argv", [
    [],
    ["--arch", "graphsage", "--num-neighbors", "15,10"],
    ["--no-cache"],
    ["--cache-dtype", "int8", "--cache-capacity", "77", "--compute-dtype", "bfloat16"],
    ["--on-device", "--epoch-dispatch", "steps", "--paired-draws", "--lr-schedule", "cosine",
     "--lr-decay-steps", "50"],
    ["--isolate", "--one2all", "--partition", "2", "--partition-method", "hash",
     "--edge-balance", "--preprocess", "--n-layers", "2", "--arch", "gcn"],
    ["--arch", "gat", "--num-heads", "2", "--eval-every", "1", "--eval-backend", "device",
     "--ckpt-dir", "/ck", "--ckpt-every", "3", "--halo-pipeline", "--seed", "5"],
])
def test_build_config_equals_jax(argv):
    t_args, j_args = _parser(tcommon).parse_args(argv), _parser(jcommon).parse_args(argv)
    t = tcommon.build_config(t_args, feat_dim=16, n_classes=5)
    j = jcommon.build_config(j_args, feat_dim=16, n_classes=5)
    assert jax_fields(dataclasses.asdict(t)) == dataclasses.asdict(j)
    t.validate()


def _train_argv(ds_dir, *extra, capacity="160"):
    return ["--dataset", ds_dir, "--arch", "graphsage", "--n-hidden", "8",
            "--batch-size", "64", "--num-neighbors", "2", "--epochs", "2",
            "--lr", "0.01", *(["--cache-capacity", capacity] if capacity else []), *extra]


def _json_line(text):
    return json.loads([ln for ln in text.strip().splitlines() if ln.startswith("{")][-1])


def test_train_cli_matches_jax(ds_dir, capsys):
    """One device: JAX's summary keys; the miss rate and the epochs equal
    (the same native sampler, the same cache at 160 vertices)."""
    from pagraph_tpu.cli import train as jtrain
    from pagraph_tpu_torch.cli import train as ttrain

    argv = _train_argv(ds_dir, "--cpu-devices", "1", "--json")
    t = ttrain.main(argv)
    t_line = _json_line(capsys.readouterr().out)
    j = jtrain.main(argv)
    j_line = _json_line(capsys.readouterr().out)
    assert set(t) == set(j) == SUMMARY_KEYS
    assert set(t_line) == set(j_line) == SUMMARY_KEYS - {"phase_timers"}
    assert t["epochs"] == j["epochs"] == 2
    assert t["miss_rate"] == j["miss_rate"] > 0
    assert np.isfinite(t["final_loss"])


def test_train_cli_on_device_and_trace(ds_dir, tmp_path):
    from pagraph_tpu_torch.cli import train as ttrain

    s = ttrain.main(_train_argv(ds_dir, "--cpu-devices", "1", "--on-device",
                                "--profile-dir", str(tmp_path), capacity=None))
    assert s["miss_rate"] == 0.0 and np.isfinite(s["final_loss"])
    (trace,) = os.listdir(tmp_path)
    with open(tmp_path / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "enqueue" in names             # the Trainer's scopes, under the trace


@pytest.fixture(scope="module")
def partition2(ds_dir):
    """``--partition 2`` in one command: 2 gloo ranks on the CPU; the
    returned summary and the printed line, rank 0's."""
    import contextlib
    import io

    from pagraph_tpu_torch.cli import train as ttrain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s = ttrain.main(_train_argv(ds_dir, "--partition", "2", "--partition-method",
                                    "hash", "--cpu-devices", "2", "--json"))
    return s, _json_line(buf.getvalue())


def test_train_cli_partition_spawns_ranks(partition2):
    s, line = partition2
    assert s["num_devices"] == s["num_processes"] == 2
    assert set(s) == SUMMARY_KEYS | DP_KEYS
    assert np.isfinite(s["final_loss"]) and s["epochs"] == 2
    assert line == {k: v for k, v in s.items() if k != "phase_timers"}


def test_launch_equals_the_in_process_partition_run(ds_dir, partition2, capfd, monkeypatch):
    """``cli.launch --nprocs 2`` runs the training CLI as 2 processes, one
    rank each over rank 0's TCP store: rank 0's line is the one-command
    run's (the same seeds, parts and gloo sums), its epoch time aside."""
    from pagraph_tpu_torch.cli import launch

    monkeypatch.setenv("PYTHONPATH", ROOT)
    capfd.readouterr()
    rc = launch.main(["--nprocs", "2", "--timeout", "240", "--", "python", "-m",
                      "pagraph_tpu_torch.cli.train",
                      *_train_argv(ds_dir, "--partition", "2", "--partition-method", "hash",
                                   "--cpu-devices", "1", "--json")])
    out = capfd.readouterr()
    assert rc == 0, out.err[-2000:]
    assert "exit codes: [0, 0]" in out.err
    got, want = _json_line(out.out), dict(partition2[1])
    got.pop("mean_epoch_time_s"), want.pop("mean_epoch_time_s")
    assert got == want


def test_scalebench_over_rank_counts(ds_dir):
    from pagraph_tpu_torch.cli import scalebench

    r = scalebench.main(_train_argv(ds_dir, "--device-counts", "1,2", "--cpu-devices", "2",
                                    "--partition-method", "hash"))
    assert r["platform"] == "cpu" and r["available_devices"] == 2 and r["note"]
    assert [x["devices"] for x in r["runs"]] == [1, 2]
    assert r["runs"][0]["efficiency"] == pytest.approx(1.0)
    for x in r["runs"]:
        assert x["edges_per_s"] > 0 and np.isfinite(x["final_loss"])


def test_refusals(ds_dir, capsys, monkeypatch):
    """Counts beyond the available ranks, ``--coordinator`` with
    ``--partition`` unequal to ``--num-processes``, and ``--one2all`` alone
    exit with the JAX package's errors; no card and no ``--cpu-devices``
    raises."""
    from pagraph_tpu.cli import scalebench as jscale
    from pagraph_tpu.cli import train as jtrain
    from pagraph_tpu_torch.cli import scalebench as tscale
    from pagraph_tpu_torch.cli import train as ttrain

    with pytest.raises(SystemExit) as e:
        tscale.main(_train_argv(ds_dir, "--device-counts", "1,4", "--cpu-devices", "2"))
    assert e.value.code == 2
    assert "device counts [4] exceed available devices (2)" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        jscale.main(_train_argv(ds_dir, "--device-counts", "1,16"))
    assert e.value.code == 2
    assert "device counts [16] exceed available devices (8)" in capsys.readouterr().err

    with pytest.raises(SystemExit) as e:
        ttrain.main(_train_argv(ds_dir, "--partition", "3", "--cpu-devices", "2"))
    assert e.value.code == 2 and "needs 3 ranks, have 2" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        ttrain.main(_train_argv(ds_dir, "--coordinator", "127.0.0.1:1", "--num-processes",
                                "2", "--partition", "3", "--cpu-devices", "1"))
    assert e.value.code == 2
    assert "multi-process training needs --partition == " in capsys.readouterr().err

    with pytest.raises(SystemExit) as e_t:
        ttrain.main(_train_argv(ds_dir, "--one2all", "--cpu-devices", "1"))
    with pytest.raises(SystemExit) as e_j:
        jtrain.main(_train_argv(ds_dir, "--one2all", "--cpu-devices", "1"))
    assert str(e_t.value) == str(e_j.value) and "--one2all needs --isolate" in str(e_t.value)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (ttrain.main, tscale.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(_train_argv(ds_dir))
    with pytest.raises(SystemExit) as e:         # --partition beyond the visible cards
        ttrain.main(_train_argv(ds_dir, "--partition", "2"))
    assert "have 0 (visible CUDA cards, one rank a card)" in capsys.readouterr().err


def test_spawn_commands_appends_the_rank_flags(tmp_path):
    """``parallel.multihost.spawn_commands`` (``cli.launch``'s launcher, the
    JAX package's ``spawn_local`` of a command line): each process gets the
    coordinator on one loopback port, the count and its own id, and its
    standard output goes to its file."""
    from pagraph_tpu_torch.parallel import spawn_commands

    paths = [str(tmp_path / f"out{i}") for i in range(2)]
    codes = spawn_commands(["-c", "import sys; print(sys.argv[1:])"], 2, timeout=60,
                           stdout_paths=paths)
    assert codes == [0, 0]
    argvs = [eval(open(p).read()) for p in paths]
    assert [a[4:] for a in argvs] == [["--process-id", "0"], ["--process-id", "1"]]
    assert argvs[0][:4] == argvs[1][:4] and argvs[0][2:4] == ["--num-processes", "2"]
    assert argvs[0][0] == "--coordinator" and argvs[0][1].startswith("127.0.0.1:")
    assert spawn_commands(["-c", "raise SystemExit(3)"], 1, timeout=60) == [3]
