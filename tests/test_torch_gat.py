"""The port's GAT against ``pagraph_tpu.models.gat``.

* Forward and parameter gradients on one ``MiniBatch``, host and prefix
  layout, one and two hidden layers (2 heads of 8), against the JAX
  ``apply`` and ``jax.grad``: logits within 1e-5, gradients within 1e-4.
* At bf16 compute the masked slots' ``exp`` is exactly 0: a destination
  with no valid neighbor gets exactly its own ``z`` (alpha_self is 1).
* One host train step calls the assembly, one ``gather_rows`` a block (the
  table ``[z | att_s | att_n]`` of the block's self rows and neighbor
  slots) and one ``scatter_add_rows`` a block, block 0 included (``z``
  depends on ``w``).
* At bf16 compute, one step's gradients against JAX's: no farther apart
  than bf16 rounding moves either from the f32 gradient.
* Lockstep ``Trainer`` epochs against JAX's on the host path (native
  sampler, K = 8) and the on-device path (JAX's random integers injected):
  losses and parameters within 1e-4 at f32, losses within 3e-2 at bf16
  compute (``tests/test_torch_gcn.py`` ``lockstep``).
* ``full_graph_logits`` on both backends (the host's numpy edge softmax;
  the device's three chunked edge scans, here in chunks smaller than the
  graph) against the JAX package's host and device backends within 1e-4 of
  each row's largest logit; ``evaluate`` equal.
* Checkpoint resume equal to the uninterrupted run bit for bit on both
  paths.
* ``convert.py`` round trips of the GAT tree (``layers[i].{w, a_self,
  a_neigh}``).
"""
import jax
import numpy as np
import pytest
import torch

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.models import gat as jgat
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models import inference as tinf
from pagraph_tpu_torch.sampling.block import Block as TBlock
from tests.test_torch_gcn import (check_bf16_grads, check_convert_round_trip,
                                  check_forward_and_grads,
                                  check_full_graph, check_resume, count_step_calls, lockstep,
                                  model_cfgs, sample_pair)
from tests.test_torch_gcn import datasets, hub_graph  # noqa: F401  (fixtures)

GAT = dict(hidden=8, num_heads=2)


@pytest.mark.parametrize("layout", ["host", "prefix"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_gat_forward_and_grads_match_jax(small_ds, layout, n_layers):
    jcfg, tcfg = model_cfgs("gat", n_layers=n_layers, **GAT)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, layout)
    jp = jgat.init_params(jax.random.PRNGKey(5), jcfg)
    check_forward_and_grads(jgat.apply, jcfg, tcfg, jp, jmb, tmb, feats)


@pytest.mark.parametrize("layout", ["host", "prefix"])
def test_gat_bf16_masked_slots_weigh_zero(layout):
    """A bf16 block whose rows 0-2 have no valid neighbor: their output is
    their own z, bit for bit (each masked slot's -1e30 logit gives exp 0)."""
    rng = np.random.default_rng(0)
    n, f = 6, 3
    mask = rng.random((n, f)) < 0.7
    mask[:3] = False
    if layout == "prefix":
        s, pos, self_pos = n + n * f, (n + np.arange(n * f)).reshape(n, f), np.arange(n)
    else:
        s = 20
        pos, self_pos = rng.integers(0, s, (n, f)), rng.integers(0, s, n)
    blk = TBlock(pos.astype(np.int32), mask, self_pos.astype(np.int32),
                 prefix_layout=layout == "prefix").to("cpu")
    layer = get_model(pt.ModelConfig(arch="gat", n_layers=1, feat_dim=10, n_classes=3,
                                     **GAT)).layers[0].to(torch.bfloat16)
    h = torch.randn(s, 10, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        out = layer(h, blk)
        z = (h @ layer.w).unflatten(1, (2, 8))[blk.self_pos.long()]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out[:3], z[:3])
    assert not torch.equal(out[3:], z[3:])


def test_gat_bf16_grads_within_bf16_rounding_of_jax(small_ds):
    jcfg, tcfg = model_cfgs("gat", n_layers=2, **GAT)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, "host")
    check_bf16_grads(jgat.apply, jcfg, tcfg, jgat.init_params(jax.random.PRNGKey(5), jcfg),
                     jmb, tmb, feats)


def test_gat_convert_round_trip():
    jcfg, tcfg = model_cfgs("gat", n_layers=2, **GAT)
    check_convert_round_trip(jgat.init_params(jax.random.PRNGKey(1), jcfg), tcfg)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_gat_host_step_calls(datasets, monkeypatch, compute):
    """3 blocks: 1 assembly, 3 gather_rows, 3 scatter_add_rows, at either
    compute dtype (scatter_add_rows rounds its bf16 table itself)."""
    calls = count_step_calls(datasets, dict(arch="gat", n_layers=2, **GAT), monkeypatch,
                             compute)
    assert calls == {"assemble": 1, "gather_rows": 3, "scatter_add_rows": 3}


@pytest.mark.parametrize("device,compute,tol", [(False, "float32", 1e-4),
                                                (True, "float32", 1e-4),
                                                (False, "bfloat16", 3e-2),
                                                (True, "bfloat16", 3e-2)])
def test_gat_trainer_lockstep_with_jax(datasets, device, compute, tol):
    lockstep(datasets, dict(arch="gat", **GAT), device, compute, tol)


@pytest.mark.parametrize("n_layers", [1, 2])
def test_gat_full_graph_logits_match_jax(hub_graph, monkeypatch, n_layers):
    g, x = hub_graph
    # edge chunks smaller than the graph, so each scan runs several
    real = tinf._DeviceEdges.__init__
    monkeypatch.setattr(tinf._DeviceEdges, "__init__",
                        lambda self, graph, device, edge_chunk=4096: real(self, graph, device,
                                                                          edge_chunk))
    kw = dict(arch="gat", n_layers=n_layers, feat_dim=12, n_classes=5, dropout=0.0, **GAT)
    check_full_graph(jgat.init_params, pg.ModelConfig(**kw), pt.ModelConfig(**kw), g, x)


@pytest.mark.parametrize("device", [False, True])
def test_gat_resume_equals_uninterrupted(datasets, tmp_path, device):
    check_resume(datasets, dict(arch="gat", **GAT), device, tmp_path)
