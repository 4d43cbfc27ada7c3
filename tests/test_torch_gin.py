"""The port's GIN against ``pagraph_tpu.models.gin``.

* Forward and parameter gradients (the 0-d ``eps`` included) on one
  ``MiniBatch``, host and prefix layout, with and without the skip, against
  the JAX ``apply`` and ``jax.grad``: logits within 1e-5, gradients within
  1e-4.
* One host train step calls the assembly, one fused ``block_gather_fwd``
  (sum) a block and one ``block_gather_bwd`` for each block whose source
  needs a gradient: both halves from one call, where the JAX package calls
  ``block_aggregate`` and ``block_self`` apart.
* At bf16 compute, one step's gradients against JAX's: no farther apart
  than bf16 rounding moves either from the f32 gradient.
* Lockstep ``Trainer`` epochs against JAX's on the host path (native
  sampler, K = 8) and the on-device path (JAX's random integers injected):
  losses and parameters within 1e-4 at f32, losses within 3e-2 at bf16
  compute (``tests/test_torch_gcn.py`` ``lockstep``).
* ``full_graph_logits`` on both backends against the JAX package's host
  and device backends within 1e-4 of each row's largest logit.
* Checkpoint resume equal to the uninterrupted run bit for bit on both
  paths (the 0-d ``eps`` and its Adam moments through ``torch.save``).
* ``convert.py`` round trips of the GIN tree (``updates[i].{eps, w1, w2}``).
"""
import jax
import pytest

import pagraph_tpu as pg
import pagraph_tpu_torch as pt
from pagraph_tpu.models import gin as jgin
from tests.test_torch_gcn import (check_bf16_grads, check_convert_round_trip,
                                  check_forward_and_grads,
                                  check_full_graph, check_resume, count_step_calls, lockstep,
                                  model_cfgs, sample_pair)
from tests.test_torch_gcn import datasets, hub_graph  # noqa: F401  (fixtures)


@pytest.mark.parametrize("layout", ["host", "prefix"])
@pytest.mark.parametrize("n_layers,skip", [(1, True), (2, False), (2, True)])
def test_gin_forward_and_grads_match_jax(small_ds, layout, n_layers, skip):
    jcfg, tcfg = model_cfgs("gin", n_layers=n_layers, skip_connection=skip)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, layout)
    jp = jgin.init_params(jax.random.PRNGKey(5), jcfg)
    # a nonzero eps, so the (1 + eps) self term is held too
    for i, u in enumerate(jp["updates"]):
        u["eps"] = u["eps"] + 0.25 * (i + 1)
    check_forward_and_grads(jgin.apply, jcfg, tcfg, jp, jmb, tmb, feats)


def test_gin_bf16_grads_within_bf16_rounding_of_jax(small_ds):
    jcfg, tcfg = model_cfgs("gin", n_layers=2)
    jmb, tmb, feats = sample_pair(small_ds, jcfg, "host")
    check_bf16_grads(jgin.apply, jcfg, tcfg, jgin.init_params(jax.random.PRNGKey(5), jcfg),
                     jmb, tmb, feats)


def test_gin_convert_round_trip():
    jcfg, tcfg = model_cfgs("gin", n_layers=2)
    check_convert_round_trip(jgin.init_params(jax.random.PRNGKey(1), jcfg), tcfg)


def test_gin_host_step_calls(datasets, monkeypatch):
    """3 blocks: 1 assembly, 3 block_gather_fwd (sum), 2 block_gather_bwd."""
    calls = count_step_calls(datasets, dict(arch="gin", n_layers=2), monkeypatch)
    assert calls == {"assemble": 1, "block_gather_fwd": 3, "block_gather_bwd": 2}


@pytest.mark.parametrize("device,compute,tol", [(False, "float32", 1e-4),
                                                (True, "float32", 1e-4),
                                                (False, "bfloat16", 3e-2),
                                                (True, "bfloat16", 3e-2)])
def test_gin_trainer_lockstep_with_jax(datasets, device, compute, tol):
    lockstep(datasets, dict(arch="gin"), device, compute, tol)


@pytest.mark.parametrize("skip", [True, False])
def test_gin_full_graph_logits_match_jax(hub_graph, skip):
    g, x = hub_graph
    kw = dict(arch="gin", n_layers=2, hidden=8, feat_dim=12, n_classes=5, dropout=0.0,
              skip_connection=skip)
    check_full_graph(jgin.init_params, pg.ModelConfig(**kw), pt.ModelConfig(**kw), g, x)


@pytest.mark.parametrize("device", [False, True])
def test_gin_resume_equals_uninterrupted(datasets, tmp_path, device):
    check_resume(datasets, dict(arch="gin"), device, tmp_path)
