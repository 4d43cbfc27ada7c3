"""The dropout keep-mask (``gather_kernels.dropout_bits``) on the CPU.

* The plain version's packed mask is ``torch.randint``'s int16 draw below
  ``thresh - 32768``, unit by unit, and advances the generator as that draw
  does; the fused block's forward and backward from the packed mask equal
  the arithmetic on the int16 units.
* A numpy model of ATen's mapping from a unit to its Philox output (the
  grid, the thread, the counter, the component, the offset's increment),
  the kernel's own mapping, reproduces ``torch.randint``'s draws recorded on
  an H100 (``tests/philox_int16_draws.json``, by
  ``tests/record_philox_draws.py``).
* ``GraphDraws``' bookkeeping for a captured graph (each draw's offset
  within the graph, the state written before a replay, the generator
  advanced after it) equals the eager draws' increments at the benchmark
  cells' blocks, and refuses a graph whose replay torch's own draws moved.
* The models pick the keep-mask kernel unless ``preprocess`` makes them
  draw through ``torch.randint`` too.
"""
import hashlib
import json
import os

import numpy as np
import pytest
import torch

import pagraph_tpu_torch as pt
from pagraph_tpu_torch.models import get_model
from pagraph_tpu_torch.ops import aggregate as agg
from pagraph_tpu_torch.ops import gather_kernels as gk
from pagraph_tpu_torch.ops.gather_kernels import reduce_msgs_plain
from pagraph_tpu_torch.sampling.block import Block

FIXTURE = os.path.join(os.path.dirname(__file__), "philox_int16_draws.json")

# curand's Philox4x32-10 constants
M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85
MASK32 = np.uint64(0xFFFFFFFF)

# the benchmark cells' dropout blocks: the source [rows, D] of each, in a
# step's order (sage-ogbn-products blocks 0-2, gcn-pagraph-reddit blocks 0-1)
CELL_BLOCKS = {"sage": ((1_081_344, 100), (180_224, 256), (16_384, 256)),
               "gcn": ((54_000, 602), (18_000, 64))}


def philox4x32_10(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (uint64 ``[N, 4]``, 32-bit words
    x, y, z, w) under ``key`` (two 32-bit words), curand's rounds."""
    c = [ctr[:, i].astype(np.uint64) for i in range(4)]
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for _ in range(10):
        p0 = np.uint64(M0) * c[0]
        p1 = np.uint64(M1) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k0, p1 & MASK32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k1, p0 & MASK32]
        k0 = (k0 + np.uint64(W0)) & MASK32
        k1 = (k1 + np.uint64(W1)) & MASK32
    return np.stack(c, axis=1)


def aten_int16_draw(seed: int, offset: int, n: int, sms: int = 132, threads: int = 2048):
    """``(units int16 [n], increment)``: ``torch.randint(-32768, 32768,
    (n,), dtype=int16)`` on a card of ``sms`` SMs from a generator at
    ``(seed, offset)``, by ATen's recipe: ``grid`` blocks of 256, thread
    ``t = li mod 256 grid``, its k-th ``curand4`` (counter ``t * 2^64 +
    offset / 4 + k``) giving units ``t + 256 grid (4k + ii)``, the unit the
    output's low 16 bits moved down by 32768."""
    grid = gk.draw_grid(n, sms, threads)
    stride = 256 * grid
    inc = gk.draw_increment(n, grid)
    iters = inc // 4
    lo = np.uint64(offset // 4) + np.arange(iters, dtype=np.uint64)
    t = np.arange(stride, dtype=np.uint64)
    ctr = np.empty((iters, stride, 4), dtype=np.uint64)
    ctr[..., 0] = (lo & MASK32)[:, None]
    ctr[..., 1] = (lo >> np.uint64(32))[:, None]
    ctr[..., 2] = (t & MASK32)[None, :]
    ctr[..., 3] = (t >> np.uint64(32))[None, :]
    out = philox4x32_10(ctr.reshape(-1, 4), (seed & 0xFFFFFFFF, seed >> 32))
    # [k, t, ii] -> unit t + stride (4k + ii): order k, ii, t
    units = out.reshape(iters, stride, 4).transpose(0, 2, 1).reshape(-1)[:n]
    return ((units & np.uint64(0xFFFF)).astype(np.int64) - 32768).astype(np.int16), inc


def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("case", range(5))
def test_model_of_atens_mapping_reproduces_the_cards_draws(case):
    """The numpy model against ``torch.randint`` on the card: every unit
    (the sha256 of the draw), its first and last 64, and the offset's
    increment; cases of fewer units than a block, a count no multiple of
    32, 64-bit seeds and a large offset, and one and two passes more than
    the grid's 1,081,344 units on 132 SMs."""
    fx = _fixture()
    c = fx["cases"][case]
    units, inc = aten_int16_draw(c["seed"], c["offset"], c["n"], fx["sms"],
                                 fx["max_threads_per_sm"])
    assert units[:64].tolist() == c["head"]
    assert units[-64:].tolist() == c["tail"]
    assert hashlib.sha256(units.astype("<i2").tobytes()).hexdigest() == c["sha256"]
    assert c["offset"] + inc == c["offset_after"]


def test_fixture_covers_the_grid_and_its_edges():
    fx = _fixture()
    assert (fx["sms"], fx["max_threads_per_sm"]) == (132, 2048)
    ns = [c["n"] for c in fx["cases"]]
    one_pass = 256 * gk.draw_grid(1 << 30, 132, 2048) * 4
    assert min(ns) < 256 and any(n % 32 for n in ns) and max(ns) > 2 * one_pass
    assert any(c["seed"] >= 1 << 63 for c in fx["cases"])


@pytest.mark.parametrize("rate", [0.2, 0.5])
@pytest.mark.parametrize("n", [7, 31, 32, 100, 1000, 4099])
def test_plain_mask_is_the_int16_draw_below_thresh(n, rate):
    """Bit ``li % 32`` of word ``li // 32`` is ``unit li < thresh - 32768``
    for every unit, the bits past ``n`` are clear, and the generator stands
    where the int16 draw leaves it."""
    thresh, _ = agg.dropout_threshold(rate)
    g_mask, g_draw = torch.Generator().manual_seed(n), torch.Generator().manual_seed(n)
    words = gk.dropout_bits_plain((n,), thresh, g_mask, "cpu")
    units = torch.randint(-(1 << 15), 1 << 15, (n,), generator=g_draw, dtype=torch.int16)
    assert words.dtype == torch.int32 and words.shape == (-(-n // 32),)
    w = words.numpy().view(np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    want = (units.numpy().astype(np.int64) < thresh - (1 << 15))
    assert np.array_equal(bits.reshape(-1)[:n].astype(bool), want)
    assert not bits.reshape(-1)[n:].any()
    assert torch.equal(g_mask.get_state(), g_draw.get_state())


def test_dropout_bits_on_the_cpu_is_the_plain_draw():
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    a = gk.dropout_bits((37, 11), 40000, g1, "cpu")
    b = gk.dropout_bits_plain((37, 11), 40000, g2, "cpu")
    assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert gk.launch_counts()["dropout_bits"] == 0


@pytest.mark.parametrize("shape", [(5,), (33,), (7, 9), (64, 3)])
def test_pack_and_unpack_round_trip(shape):
    kept = torch.rand(shape, generator=torch.Generator().manual_seed(1)) < 0.4
    assert torch.equal(gk.unpack_bits(gk.pack_bits(kept), shape), kept)


def _prefix_block(n, f, rng):
    mask = rng.random((n, f)) >= 0.3
    mask[:2] = False
    return Block(neigh_pos=torch.arange(n, n + n * f, dtype=torch.int32).reshape(n, f),
                 neigh_mask=torch.from_numpy(mask),
                 self_pos=torch.arange(n, dtype=torch.int32), prefix_layout=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_self", [True, False], ids=["self", "no_self"])
@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_block_from_the_packed_mask_equals_the_int16_arithmetic(kind, with_self, dtype):
    """``DropoutBlock`` over the packed mask against the arithmetic on the
    int16 units themselves (``where(units < thresh - 32768, x * inv_keep,
    0)``, the self slice, the masked reduction), forward and the input's
    gradient, to the bit, at a width that is no multiple of 4 and with
    source rows past the block's."""
    rng = np.random.default_rng(8)
    n, f, d, extra = 6, 3, 10, 5
    block = _prefix_block(n, f, rng)
    rows = n * (1 + f) + extra
    h0 = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(dtype)
    weights = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) for _ in range(2)]
    thresh, inv_keep = agg.dropout_threshold(0.5)
    units = torch.randint(-(1 << 15), 1 << 15, (rows, d), generator=torch.Generator().manual_seed(2),
                          dtype=torch.int16)
    keep = gk.pack_bits(units < thresh - (1 << 15))

    def loss_of(outs):
        return sum((o.float() * w).sum() for o, w in zip(outs, weights) if o is not None)

    h_k = h0.clone().requires_grad_(True)
    out = gk.DropoutBlock.apply(h_k, keep, block.neigh_mask, inv_keep, kind, with_self)
    outs_k = out if with_self else (None, out)
    loss_of(outs_k).backward()

    h_r = h0.clone().requires_grad_(True)
    xd = torch.where(units < thresh - (1 << 15), h_r * inv_keep, 0.0)
    neigh = reduce_msgs_plain(xd[n:n + n * f].reshape(n, f, d), block.neigh_mask, kind)
    outs_r = (xd[:n] if with_self else None, neigh)
    loss_of(outs_r).backward()
    for a, b in zip(outs_k, outs_r):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == dtype and torch.equal(a.detach(), b.detach())
    assert torch.equal(h_k.grad, h_r.grad)


def test_block_refuses_a_mask_of_another_size():
    rng = np.random.default_rng(0)
    block = _prefix_block(4, 2, rng)
    x = torch.zeros(12, 5)
    with pytest.raises(ValueError, match="words"):
        gk.dropout_block_fwd(x, torch.zeros(1, dtype=torch.int32), 2.0, block.neigh_mask)
    with pytest.raises(TypeError, match="int32"):
        gk.dropout_block_fwd(x, torch.zeros(2, dtype=torch.int16), 2.0, block.neigh_mask)


class _FakeGenerator:
    """A CUDA generator's host state: a seed and a Philox offset."""

    def __init__(self, seed: int, offset: int):
        self.device = torch.device("cpu")
        self.seed, self.offset = seed, offset

    def initial_seed(self):
        return self.seed

    def get_offset(self):
        return self.offset

    def set_offset(self, offset):
        assert offset % 4 == 0
        self.offset = offset


class _FakeLib:
    def __init__(self):
        self.states = []

    def pg_dropout_bits_state(self, ptr, seed, offset, stream):
        self.states.append((seed, offset))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gk, "_lib", lambda: lib)
    monkeypatch.setattr(gk, "_stream", lambda device: None)
    return lib


def _eager_increments(shapes):
    """Each draw's increment of the generator's offset, as torch.randint on
    132 SMs makes it (the model above, checked against the card)."""
    return [gk.draw_increment(r * d, gk.draw_grid(r * d, 132, 2048)) for r, d in shapes]


@pytest.mark.parametrize("cell", sorted(CELL_BLOCKS))
def test_graph_draws_follow_the_eager_increments(cell, fake_lib):
    """A graph of 3 steps of the cell's draws: each draw's offset within the
    graph is the sum of the increments before it, a replay reads the
    generator's seed and offset then, and the generator ends where the
    eager draws would leave it; a second replay starts there."""
    shapes = CELL_BLOCKS[cell] * 3
    incs = _eager_increments(shapes)
    gen = _FakeGenerator(0xFEDCBA9876543210, 4 * 12_345)
    draws = gk.GraphDraws(gen)
    offsets = [draws.add(r * d, inc) for (r, d), inc in zip(shapes, incs)]
    assert offsets == [sum(incs[:i]) for i in range(len(incs))]
    assert draws.increment == sum(incs)
    assert draws.units == sum(r * d for r, d in shapes)
    start = gen.get_offset()
    for rep in range(2):
        at = draws.before_replay()
        assert at == start + rep * sum(incs)
        draws.after_replay(at)
        assert gen.get_offset() == start + (rep + 1) * sum(incs)
    assert fake_lib.states == [(gen.seed, start), (gen.seed, start + sum(incs))]


def test_graph_draws_increments_at_the_cells_blocks():
    """torch's increments at the cells' blocks, from the grid of 1,056 blocks:
    SAGE 400 + 172 + 16 a step, GCN 124 + 8."""
    assert _eager_increments(CELL_BLOCKS["sage"]) == [400, 172, 16]
    assert _eager_increments(CELL_BLOCKS["gcn"]) == [124, 8]
    assert gk.draw_increment(0, 1) == 0


def test_graph_draws_without_a_draw_leave_the_generator(fake_lib):
    gen = _FakeGenerator(3, 8)
    draws = gk.GraphDraws(gen)
    at = draws.before_replay()
    draws.after_replay(at)
    assert at is None and gen.get_offset() == 8 and fake_lib.states == []


def test_graph_draws_refuse_a_graph_that_torch_also_drew_in(fake_lib):
    gen = _FakeGenerator(3, 8)
    draws = gk.GraphDraws(gen)
    draws.add(1000, 4)
    at = draws.before_replay()
    gen.set_offset(at + 4)              # torch's replay prologue advanced it
    with pytest.raises(RuntimeError, match="overlap"):
        draws.after_replay(at)


def test_capturing_draws_sets_and_resets_the_graphs_draws():
    draws = gk.GraphDraws(_FakeGenerator(1, 0))
    assert gk._GRAPH_DRAWS.get() is None
    with gk.capturing_draws(draws):
        assert gk._GRAPH_DRAWS.get() is draws
    assert gk._GRAPH_DRAWS.get() is None


@pytest.mark.parametrize("arch,preprocess,kernel", [
    ("graphsage", False, True), ("graphsage", True, False), ("gcn", False, True),
    ("gcn", True, False), ("gin", False, True)])
def test_models_pick_the_kernel_draw_unless_preprocess(monkeypatch, arch, preprocess, kernel):
    """A model whose layer 0 draws through ``torch.randint`` (preprocess)
    keeps its blocks on the plain draw, so one CUDA graph never holds both
    kinds; the others draw through ``dropout_bits``."""
    cfg = pt.ModelConfig(arch=arch, n_layers=2, hidden=8, feat_dim=12, n_classes=5,
                         dropout=0.5, preprocess=preprocess)
    model = get_model(cfg, generator=torch.Generator().manual_seed(0))
    assert getattr(model, "kernel_draws", True) is kernel
    calls = []
    monkeypatch.setattr(agg, "dropout_bits",
                        lambda *a: calls.append("kernel") or gk.dropout_bits_plain(*a))
    monkeypatch.setattr(agg, "dropout_bits_plain",
                        lambda *a: calls.append("plain") or gk.dropout_bits_plain(*a))
    h = torch.zeros(4 * 4, 6)
    block = _prefix_block(4, 3, np.random.default_rng(1))
    agg.dropout_block_gather(h, block, "mean", 0.5, torch.Generator().manual_seed(1),
                             kernel_draw=getattr(model, "kernel_draws", True))
    assert calls == ["kernel" if kernel else "plain"]
