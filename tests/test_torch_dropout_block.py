"""The fused dropout and prefix-layout block op (``ops.aggregate.
dropout_block_gather``, ``gather_kernels.DropoutBlock``) on the CPU, where
its plain version runs, against the chain it replaces: ``models.common.
dropout`` followed by ``block_gather`` / ``block_aggregate``.

* The same units dropped and the generator advanced as far: the op's int16
  draw is the chain's int32 draw moved down by 32768.
* Outputs, the input's gradient and the generator's state afterwards equal
  to the bit, over the kinds ``mean`` and ``sum``, with and without the self
  half, rates 0.5, 0.2 and 0, f32 and bf16, at a width that is no multiple of
  4 and on a block with masked slots, rows with no valid slot and source
  rows past the block's.
* The dispatch (``models.common.dropout_gather``): a prefix-layout ``mean``
  or ``sum`` block takes the op; ``max``, the lstm aggregator and
  host-sampled blocks take the chain; the models' logits and gradients are
  the chain's.
"""
import numpy as np
import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.models import common, get_model
from pagraph_tpu_torch.ops import aggregate as agg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.sampling.block import Block, MiniBatch

# (n, fanout, D, extra source rows, share of masked slots, rows with no slot)
SHAPES = {"d10": (7, 3, 10, 0, 0.3, 0), "masked": (9, 4, 8, 5, 0.5, 3)}


def _prefix_block(n, f, masked, empty, rng):
    mask = rng.random((n, f)) >= masked
    mask[:empty] = False
    return Block(neigh_pos=torch.arange(n, n + n * f, dtype=torch.int32).reshape(n, f),
                 neigh_mask=torch.from_numpy(mask),
                 self_pos=torch.arange(n, dtype=torch.int32), prefix_layout=True)


def _host_block(n, f, s, rng):
    return Block(neigh_pos=torch.from_numpy(rng.integers(0, s, (n, f)).astype(np.int32)),
                 neigh_mask=torch.from_numpy(rng.random((n, f)) < 0.7),
                 self_pos=torch.from_numpy(rng.integers(0, s, n).astype(np.int32)))


def _chain(h, block, kind, rate, gen, with_self):
    d = common.dropout(h, rate, gen, True)
    if with_self:
        return agg.block_gather(d, block, kind)
    return None, agg.block_aggregate(d, block, kind)


def _run(fn, h0, weights):
    """``fn(h)``'s outputs and ``h``'s gradient of ``sum(out * w)``."""
    h = h0.clone().requires_grad_(True)
    outs = fn(h)
    loss = sum((o.float() * w).sum() for o, w in zip(outs, weights) if o is not None)
    loss.backward()
    return [None if o is None else o.detach() for o in outs], h.grad


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_int16_draw_is_the_int32_draw_moved_down(shape):
    n, f, d, extra, _, _ = SHAPES[shape]
    size = (n * (1 + f) + extra, d)
    g32, g16 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    b32 = torch.randint(0, 1 << 16, size, generator=g32, dtype=torch.int32)
    b16 = torch.randint(-(1 << 15), 1 << 15, size, generator=g16, dtype=torch.int16)
    assert torch.equal(b32 - (1 << 15), b16.int())
    assert torch.equal(g32.get_state(), g16.get_state())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.5, 0.2, 0.0])
@pytest.mark.parametrize("with_self", [True, False], ids=["self", "no_self"])
@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_op_equals_dropout_then_gather(kind, with_self, rate, dtype, shape):
    n, f, d, extra, masked, empty = SHAPES[shape]
    rng = np.random.default_rng(5)
    block = _prefix_block(n, f, masked, empty, rng)
    h0 = torch.from_numpy(rng.normal(size=(n * (1 + f) + extra, d)).astype(np.float32)).to(dtype)
    weights = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) for _ in range(2)]
    g_chain, g_op = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    out_c, grad_c = _run(lambda h: _chain(h, block, kind, rate, g_chain, with_self), h0, weights)
    out_o, grad_o = _run(lambda h: agg.dropout_block_gather(h, block, kind, rate, g_op,
                                                            with_self=with_self), h0, weights)
    for a, b in zip(out_c, out_o):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype == dtype
            assert torch.equal(a, b)
    assert grad_o.dtype == dtype
    assert torch.equal(grad_c, grad_o)
    assert torch.equal(g_chain.get_state(), g_op.get_state())
    if rate and not with_self:      # no gradient reaches the self rows
        assert not grad_o[:n].any()


def test_op_refuses_what_it_does_not_take():
    rng = np.random.default_rng(0)
    block = _prefix_block(4, 2, 0.0, 0, rng)
    h = torch.zeros(12, 4)
    with pytest.raises(ValueError, match="prefix-layout"):
        agg.dropout_block_gather(h, _host_block(4, 2, 12, rng), "mean", 0.5, None)
    with pytest.raises(ValueError, match="kind"):
        agg.dropout_block_gather(h, block, "max", 0.5, None)
    with pytest.raises(ValueError, match="rows"):
        agg.dropout_block_gather(h[:11], block, "mean", 0.0, None)
    with pytest.raises(ValueError, match="keeps nothing"):
        agg.dropout_block_gather(h, block, "mean", 1.0, torch.Generator())


@pytest.fixture
def op_calls(monkeypatch):
    """The kinds the fused op was called with, in order."""
    calls = []
    real = common.dropout_block_gather

    def record(h, block, kind, *a, **kw):
        calls.append(kind)
        return real(h, block, kind, *a, **kw)

    monkeypatch.setattr(common, "dropout_block_gather", record)
    return calls


@pytest.mark.parametrize("layout,kind,fused", [
    ("prefix", "mean", True), ("prefix", "sum", True), ("prefix", "max", False),
    ("host", "mean", False), ("host", "sum", False), ("host", "max", False)])
def test_dispatch_by_block_and_kind(op_calls, layout, kind, fused):
    """The op where the block is prefix-layout and the kind mean or sum;
    the chain, with its int32 draw, elsewhere: the same outputs either
    way."""
    rng = np.random.default_rng(2)
    n, f, s = 6, 3, 24
    block = _prefix_block(n, f, 0.3, 1, rng) if layout == "prefix" else _host_block(n, f, s, rng)
    h = torch.from_numpy(rng.normal(size=(s, 8)).astype(np.float32))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    got = common.dropout_gather(h, block, kind, 0.5, g1, True)
    want = _chain(h, block, kind, 0.5, g2, True)
    assert op_calls == ([kind] if fused else [])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())


def _prefix_minibatch(caps, fanouts, feat_dim, n_classes, rng):
    blocks = tuple(_prefix_block(n, f, 0.3, 1, rng) for n, f in zip(caps[1:], fanouts))
    nids = tuple(torch.from_numpy(rng.integers(0, 1000, c).astype(np.int32)) for c in caps)
    lmask = tuple(torch.ones(c, dtype=torch.bool) for c in caps)
    labels = torch.from_numpy(rng.integers(0, n_classes, caps[-1]).astype(np.int32))
    feats = torch.from_numpy(rng.normal(size=(caps[0], feat_dim)).astype(np.float32))
    return MiniBatch(layer_nids=nids, layer_mask=lmask, blocks=blocks, labels=labels), feats


# arch, aggregator -> the kinds the fused op runs with, block by block
MODELS = {("graphsage", "mean"): ["mean"] * 3, ("graphsage", "gcn"): ["sum"] * 3,
          ("graphsage", "pool"): [], ("graphsage", "lstm"): [], ("gcn", "mean"): ["mean"] * 3,
          ("gin", "mean"): ["sum"] * 3}


@pytest.mark.parametrize("arch,aggregator", sorted(MODELS))
def test_models_on_prefix_blocks_equal_the_chain(op_calls, monkeypatch, arch, aggregator):
    """A model's logits and every gradient through the op equal those of the
    same model whose blocks take the chain, and the generator ends alike;
    the op runs once a block for mean and sum, never for pool and lstm."""
    rng = np.random.default_rng(4)
    fanouts = (3, 2, 2)
    caps = [4]
    for f in reversed(fanouts):
        caps.insert(0, caps[0] * (1 + f))
    mb, feats = _prefix_minibatch(caps, fanouts, 12, 5, rng)
    cfg = pt.ModelConfig(arch=arch, n_layers=2, hidden=8, feat_dim=12, n_classes=5,
                         aggregator=aggregator, dropout=0.5)

    def run():
        model = get_model(cfg, generator=torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        logits = model(mb, feats, generator=gen)
        logits.square().sum().backward()
        return logits.detach(), [p.grad for p in model.parameters()], gen.get_state()

    logits, grads, state = run()
    assert op_calls == MODELS[(arch, aggregator)]

    def chain(h, block, kind, rate, generator, train, *, with_self=True, kernel_draw=True):
        d = common.dropout(h, rate, generator, train)
        return agg.block_gather(d, block, kind) if with_self else (
            None, agg.block_aggregate(d, block, kind))

    monkeypatch.setattr(common, "dropout_gather", chain)
    for mod in ("sage", "gcn", "gin"):
        monkeypatch.setattr(f"pagraph_tpu_torch.models.{mod}.dropout_gather", chain)
    logits_c, grads_c, state_c = run()
    assert torch.equal(logits, logits_c)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_c))
    assert torch.equal(state, state_c)


def test_unit_is_the_widest_that_fits():
    """4 elements where D and every base allow, else 2, else 1."""
    t = torch.zeros(64)
    assert gk._unit(8, t) == 4
    assert gk._unit(6, t) == 2
    assert gk._unit(8, t[2:]) == 2
    assert gk._unit(8, t[1:]) == 1
    assert gk._unit(7, t) == 1
    assert gk._unit(602, torch.zeros(8, dtype=torch.int16), t) == 2
