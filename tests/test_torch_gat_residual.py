"""The residual GAT form (PyG's ``examples/ogbn_products_gat.py``:
``model.residual``, ``model.feature_dropout``) and GAT's attention op on
prefix-layout blocks, against plain-PyTorch references
(``tests/reference_gat.py``, ``gnnbench/reference/gat.py``).

* The residual form's logits and every parameter's gradient on one
  MiniBatch, host and prefix layout, dropout off and on (the same generator
  seed: the same draws in the same order), layer 0's input dropped or not,
  against the reference computed in float64 from the same float32 leaves:
  logits within 1e-5 and each gradient within 1e-4 of its largest value
  (the program's float32 arithmetic against float64).  Every block has
  masked slots and a destination with no valid slot.
* ``ops.aggregate.gat_attention`` (``GatAttention``), which the CPU runs
  in its plain versions: its forward equal bit for bit to the chain that
  ``models/gat.py`` ran before it (the same ops), its backward (the
  kernel's formulas, written out) within 1e-12 of autograd through that
  chain in float64 and 1e-5 in float32 (of each gradient's largest: the
  order of the sums differs), with masked slots, a row with none and rows
  past ``n x (1 + F)``.
* The benchmark's reference against the repo's on the same sampled layers,
  leaves and draws: within 1e-12 in float64 (two formulations of one sum).
* ``full_graph_logits`` of the residual form on both backends against the
  reference over every vertex's whole in-neighborhood, within 1e-5 of each
  row's largest logit (float32 against float64), zero in-degrees included.
* The config refuses the two fields at non-default values on every other
  architecture; the parameters are the reference's leaves by name.
"""
import dataclasses

import numpy as np
import pytest
import torch

import pagraph_tpu_torch as pt
from gnnbench.reference import gat as bench_gat
from gnnbench.reference import sampler as bench_sampler
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.models.inference import full_graph_logits
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.ops.aggregate import gat_attention
from pagraph_tpu_torch.sampling.block import Block, MiniBatch
from tests import reference_gat as ref

FEAT, CLASSES = 12, 5


def model_cfg(**kw):
    return pt.ModelConfig(**{**dict(arch="gat", n_layers=2, hidden=8, num_heads=2,
                                    feat_dim=FEAT, n_classes=CLASSES, dropout=0.0,
                                    residual=True, feature_dropout=False), **kw})


def minibatch(layout: str, hops: int, batch: int = 10, fanout: int = 3,
              seed: int = 0) -> MiniBatch:
    """A padded MiniBatch of ``hops`` blocks: the prefix layout of the
    on-device sampler, or host blocks with random positions; 70% of the
    slots valid, destination 0 of each block with none, a seed padded."""
    rng = np.random.default_rng(seed)
    caps = [batch]
    for _ in range(hops):
        caps.insert(0, caps[0] * (1 + fanout))
    blocks = []
    for s, n in zip(caps[:-1], caps[1:]):
        mask = rng.random((n, fanout)) < 0.7
        mask[0] = False
        if layout == "prefix":
            pos, self_pos = (n + np.arange(n * fanout)).reshape(n, fanout), np.arange(n)
        else:
            pos, self_pos = rng.integers(0, s, (n, fanout)), rng.integers(0, s, n)
        blocks.append(Block(pos.astype(np.int32), mask, self_pos.astype(np.int32),
                            prefix_layout=layout == "prefix"))
    lmask = [np.ones(c, dtype=bool) for c in caps]
    lmask[-1][-1] = False
    return MiniBatch(layer_nids=tuple(rng.integers(0, 1000, c).astype(np.int32) for c in caps),
                     layer_mask=tuple(lmask), blocks=tuple(blocks),
                     labels=rng.integers(0, CLASSES, batch).astype(np.int32)).to("cpu")


def xent(logits, labels, mask):
    ll = torch.log_softmax(logits, -1).gather(1, labels.long()[:, None])[:, 0]
    return -(ll * mask.to(ll.dtype)).sum() / mask.sum()


def close(got, want, rel, what):
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    assert err <= rel * max(scale, 1e-30), f"{what}: {err} against {rel} x {scale}"


@pytest.mark.parametrize("feature_dropout", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("layout", ["host", "prefix"])
def test_residual_matches_reference(layout, rate, feature_dropout):
    cfg = model_cfg(dropout=rate, feature_dropout=feature_dropout)
    mb = minibatch(layout, cfg.num_gnn_layers)
    model = get_model(cfg)
    leaves = ref.init_params(dataclasses.asdict(cfg), torch.Generator().manual_seed(3))
    model.load_state_dict(leaves)
    feats = torch.randn(mb.layer_nids[0].shape[0], FEAT,
                        generator=torch.Generator().manual_seed(4))
    logits = model(mb, feats, generator=torch.Generator().manual_seed(9))
    xent(logits, mb.labels, mb.seed_mask).backward()
    p64 = {k: v.double().requires_grad_(True) for k, v in leaves.items()}
    blocks = [(b.self_pos, b.neigh_pos, b.neigh_mask) for b in mb.blocks]
    want = ref.forward(p64, blocks, feats.double(), dataclasses.asdict(cfg),
                       torch.Generator().manual_seed(9) if rate else None)
    grads = torch.autograd.grad(xent(want, mb.labels, mb.seed_mask), list(p64.values()))
    close(logits.detach(), want.detach(), 1e-5, "logits")
    for (name, p), g in zip(model.named_parameters(), grads):
        close(p.grad, g, 1e-4, name)


def chain(z, a_s, a_n, mask):
    """The attention chain of ``models/gat.py`` before the op, verbatim."""
    heads, hd = a_s.shape
    n, f = mask.shape
    z3 = z.unflatten(1, (heads, hd))
    att_s = torch.einsum("nkh,kh->nk", z3, a_s)
    att_n = torch.einsum("nkh,kh->nk", z3, a_n)
    z_self, as_dst, an_dst = z3[:n], att_s[:n], att_n[:n]
    z_neigh = z3[n:n + n * f].unflatten(0, (n, f))
    an_nbr = att_n[n:n + n * f].unflatten(0, (n, f))
    e_n = torch.nn.functional.leaky_relu(as_dst[:, None, :] + an_nbr, 0.2)
    e_s = torch.nn.functional.leaky_relu(as_dst + an_dst, 0.2)
    e_n = torch.where(mask[..., None], e_n, -1e30)
    m = torch.maximum(e_n.amax(dim=1), e_s)
    w_n = torch.exp(e_n - m[:, None, :])
    w_s = torch.exp(e_s - m)
    denom = w_n.sum(dim=1) + w_s
    alpha_n = w_n / denom[:, None, :]
    alpha_s = w_s / denom
    return torch.einsum("nfk,nfkh->nkh", alpha_n, z_neigh) + alpha_s[..., None] * z_self


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("heads,hd,n,fanout,extra", [(2, 8, 30, 3, 0), (1, 16, 20, 10, 4),
                                                      (4, 5, 12, 1, 0), (3, 47, 9, 70, 2)])
def test_attention_op_matches_chain(heads, hd, n, fanout, extra, dtype, tol):
    gen = torch.Generator().manual_seed(heads * 100 + fanout)
    rows = n * (1 + fanout) + extra
    z = torch.randn(rows, heads * hd, generator=gen, dtype=dtype)
    a_s, a_n = (torch.rand(heads, hd, generator=gen, dtype=dtype) - 0.5 for _ in range(2))
    mask = torch.rand(n, fanout, generator=gen) < 0.8
    mask[0] = False
    g = torch.randn(n, heads, hd, generator=gen, dtype=dtype)
    blk = Block(np.zeros((n, fanout), np.int32), mask.numpy(), np.arange(n, dtype=np.int32),
                prefix_layout=True).to("cpu")
    leaves = [t.clone().requires_grad_(True) for t in (z, a_s, a_n)]
    out = gat_attention(*leaves, blk)
    assert torch.equal(out, chain(z, a_s, a_n, mask))
    got = torch.autograd.grad(out, leaves, g)
    want = torch.autograd.grad(chain(*leaves, mask), leaves, g)
    for name, a, b in zip(("z", "a_self", "a_neigh"), got, want):
        close(a, b, tol, name)
    dz = got[0]
    assert (dz[n:n * (1 + fanout)].view(n, fanout, -1)[~mask] == 0).all()
    assert (dz[n * (1 + fanout):] == 0).all()


def test_attention_op_refuses_host_blocks_and_bad_shapes():
    blk = Block(np.zeros((2, 2), np.int32), np.ones((2, 2), bool), np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="prefix-layout"):
        gat_attention(torch.zeros(6, 4), torch.zeros(2, 2), torch.zeros(2, 2), blk.to("cpu"))
    mask = torch.ones(2, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="z"):
        gk.gat_attention_fwd(torch.zeros(5, 4), torch.zeros(2, 2), torch.zeros(2, 2), mask)
    with pytest.raises(ValueError, match="a_s"):
        gk.gat_attention_fwd(torch.zeros(6, 4), torch.zeros(2, 2), torch.zeros(4), mask)
    # the kernels' widest heads: 128 units of 4 floats, or of one
    row = torch.zeros(4, 4)
    assert gk._gat_unit(512, row) == 4 and gk._gat_unit(47, row) == 1
    for hd in (516, 129):
        with pytest.raises(ValueError, match="more than the kernels'"):
            gk._gat_unit(hd, row)


@pytest.mark.parametrize("rate,residual,feature_dropout",
                         [(0.0, True, False), (0.5, True, False), (0.5, False, True)])
def test_bench_reference_matches_tests_reference(rate, residual, feature_dropout):
    rng = np.random.default_rng(5)
    n_nodes = 200
    deg = rng.integers(0, 12, n_nodes)
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]))
    indices = torch.from_numpy(rng.integers(0, n_nodes, int(deg.sum())))
    fanouts = [4, 3, 2]                     # layer by layer, outermost first
    hop = fanouts[::-1]
    seeds = torch.from_numpy(rng.integers(0, n_nodes, 8))
    seed_mask = torch.ones(8, dtype=torch.bool)
    seed_mask[-1] = False
    draws, n = [], 8
    for f in hop:
        draws.append(torch.from_numpy(rng.integers(0, 2**31 - 1, (n, f))))
        n *= f + 1
    layers = bench_sampler.sample_layers(indptr, indices, seeds, seed_mask, hop, draws)
    model = dataclasses.asdict(model_cfg(dropout=rate, residual=residual,
                                         feature_dropout=feature_dropout))
    leaves = {k: v.double() for k, v in
              ref.init_params(model, torch.Generator().manual_seed(2)).items()}
    assert [(k, tuple(s)) for k, s, _ in bench_gat.param_specs(model)] == \
        [(k, tuple(v.shape)) for k, v in leaves.items()]
    x0 = torch.randn(layers[0][0].shape[0], FEAT, generator=torch.Generator().manual_seed(6),
                     dtype=torch.float64)
    blocks = []
    for i, f in enumerate(fanouts):
        nd = layers[i + 1][0].shape[0]
        blocks.append((torch.arange(nd), nd + torch.arange(nd * f).view(nd, f),
                       layers[i][1][nd:nd * (1 + f)].view(nd, f)))
    p1 = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    p2 = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    a = bench_gat.forward(p1, layers, x0, model, fanouts, torch.Generator().manual_seed(8))
    b = ref.forward(p2, blocks, x0, model, torch.Generator().manual_seed(8) if rate else None)
    close(a.detach(), b.detach(), 1e-12, "logits")
    ga = torch.autograd.grad(a.square().sum(), list(p1.values()))
    gb = torch.autograd.grad(b.square().sum(), list(p2.values()))
    for name, x, y in zip(p1, ga, gb):
        close(x, y, 1e-12, name)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_residual_full_graph_logits(backend):
    rng = np.random.default_rng(11)
    n = 60
    deg = rng.integers(0, 6, n)
    deg[:3] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = rng.integers(0, n, int(deg.sum()))
    graph = pt.CSRGraph(indptr=indptr, indices=indices,
                        out_degrees=np.bincount(indices, minlength=n))
    cfg = model_cfg()
    leaves = ref.init_params(dataclasses.asdict(cfg), torch.Generator().manual_seed(12))
    model = get_model(cfg)
    model.load_state_dict(leaves)
    x = rng.normal(size=(n, FEAT)).astype(np.float32)
    got = full_graph_logits(model, cfg, graph, x, backend=backend)
    want = ref.forward({k: v.double() for k, v in leaves.items()},
                       ref.full_graph_blocks(indptr, indices, cfg.num_gnn_layers),
                       torch.from_numpy(x).double(), dataclasses.asdict(cfg)).numpy()
    scale = 1.0 + np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) / scale).max() <= 1e-5


@pytest.mark.parametrize("arch", ["gcn", "graphsage", "gin"])
@pytest.mark.parametrize("field", [dict(residual=True), dict(feature_dropout=False)])
def test_config_refuses_gat_fields_elsewhere(arch, field):
    with pytest.raises(ValueError, match="only applies to arch 'gat'"):
        pt.Config(model=pt.ModelConfig(arch=arch, **field), sampler=pt.SamplerConfig())
    pt.Config(model=pt.ModelConfig(arch="gat", **field), sampler=pt.SamplerConfig())


def test_gcn_cv_refuses_residual():
    with pytest.raises(ValueError, match="only applies to arch 'gat'"):
        pt.Config(model=pt.ModelConfig(arch="gcn_cv", preprocess=True, residual=True),
                  sampler=pt.SamplerConfig(num_hops=1))


@pytest.mark.parametrize("residual", [False, True])
def test_parameters_are_the_reference_leaves(residual):
    cfg = model_cfg(residual=residual)
    names = [k for k, _ in get_model(cfg).named_parameters()]
    specs = bench_gat.param_specs(dataclasses.asdict(cfg))
    assert names == [k for k, _, _ in specs]
    shapes = {k: tuple(v.shape) for k, v in get_model(cfg).named_parameters()}
    assert shapes == {k: tuple(s) for k, s, _ in specs}
