"""The comparison that decides ``correct`` for a training cell, in two
stages against the plain reference (``reference/``) run from the same
inputs: the program's first steps from the benchmark's weights, as
:class:`probe.StepProbe` read them in the eager epoch 0; and the window's
first epoch, a replay of the captured graph, which the reference follows
from the program's state before it (:class:`probe.EpochSnapshot`); with
the sampled edge and vertex counts of those epochs, and of the window's
last, against the reference sampler's.

Numbers compared, each held to its cell's limit (``workloads/<cell>.json``
``limits``):

* ``sample_mismatch``: sampled ids, masks or seed labels that differ from
  the reference sampler's, over every layer of the compared steps (exact).
* ``fetch_mismatch``: layer-0 values that differ from the features at the
  reference's ids (exact).
* ``count_mismatch``: the absolute differences of the valid edges and
  vertices of the checked epochs, summed, plus any window epoch's steps off
  the epoch's batch count (exact).
* ``loss1_gap``: ``|loss - ref| / |ref|`` of the first step.
* ``grad_gap``: the first gradient as Adam got it, leaf by leaf ``|norm -
  ref norm| / max(ref norm of the leaf, median leaf's ref norm)``; the
  worst leaf.
* ``update_gap``: the parameters' change over the compared steps, the same
  measure and worst leaf, over the leaves whose first reference gradient
  is at least a thousandth of the median leaf's (the others move by
  round-off alone).
* ``leaf_moves``: those leaves whose change norm is not within half of the
  reference's (a leaf left unmoved or moved twice; exact).
* ``replay_loss_gap``: the replayed epoch's mean loss, ``|loss - ref| /
  |ref|``.
* ``replay_update_gap``, ``replay_leaf_moves``: ``update_gap`` and
  ``leaf_moves`` of the parameters' change over the replayed epoch, the
  leaves chosen by the reference's first gradient of that epoch.
* ``replay_update_gap_whole``: the gap of the norm of that change over all
  those leaves together.

A cell compares those of them that separate its sound runs from the
control or a fault (PERF.md gives the readings): over a long epoch the
rounding of any float32 arithmetic, the program's or a float32
reference's, grows until one leaf's change or the epoch's loss reads as
far from the float64 reference as a fault's does.
* ``replica_gap`` (data parallel): ranks whose parameters differ from
  another's after the window, bit for bit (exact).

The reference computes in float64 (``REFERENCE_DTYPE``), from the same
float32 inputs and weights (the replayed epoch: from the program's
parameters and Adam moments before it, at the step count the reference
works out itself).  ``loss_gap_max``, the largest loss gap over the first
steps, is reported beside the numbers and not compared.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from .reference import partition as ref_partition
from .reference import sampler as ref_sampler
from .reference import streams
from .reference.train import Adam, masked_cross_entropy

EXCLUDE_BELOW = 1e-3     # of the median leaf's first gradient norm
# The reference computes in float64: a float32 reference's own rounding flips
# the odd ReLU and the Adam update of the odd near-zero gradient, and reads
# gaps on some seeds that are its own (PERF.md, the look behind the limits).
REFERENCE_DTYPE = torch.float64
MOVE_RATIO = 0.5         # a leaf's change norm off the reference's by more: moved wrong


def hop_fanouts(config: dict) -> List[int]:
    """Fan-outs seeds outward (the configuration lists them layer by layer,
    outermost first)."""
    return list(reversed(config["sampler"]["fanouts"]))


def num_batches(n_train: int, batch_size: int) -> int:
    return -(-n_train // batch_size)


def layer_rows(config: dict) -> List[int]:
    """Rows of each sampled layer, outermost first."""
    return list(reversed(streams.hop_sizes(config["sampler"]["batch_size"],
                                           hop_fanouts(config) + [0])))


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              leaves: Sequence[str]) -> List[float]:
    """Each leaf's ``|norm - ref norm| / max(ref norm, median ref norm)``."""
    rn = {k: float(ref[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values()))) if rn else 0.0
    return [abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
            for k in leaves]


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least ``EXCLUDE_BELOW`` of
    the median leaf's."""
    gnorm = {k: float(v.double().norm()) for k, v in grads.items()}
    med = float(np.median(list(gnorm.values())))
    return [k for k, v in gnorm.items() if v >= EXCLUDE_BELOW * med]


def update_numbers(prog_delta: Dict[str, torch.Tensor], ref_delta: Dict[str, torch.Tensor],
                   leaves: Sequence[str]) -> tuple:
    """``(worst leaf gap, leaves moved wrong)`` of two parameter changes."""
    ug = leaf_gaps(prog_delta, ref_delta, leaves)
    ratios = [float(prog_delta[k].double().norm()) /
              max(float(ref_delta[k].double().norm()), 1e-30) for k in leaves]
    return max(ug, default=0.0), sum(abs(r - 1.0) > MOVE_RATIO for r in ratios)


def rel_gap(value: float, ref: float) -> float:
    return abs(value - ref) / max(abs(ref), 1e-30)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of two trajectories (``losses``, ``grads1`` and ``delta``
    by leaf), ``ref`` the reference."""
    moving = moving_leaves(ref["grads1"])
    update_gap, moved_wrong = update_numbers(prog["delta"], ref["delta"], moving)
    lp, lr = prog["losses"], ref["losses"]
    return {
        "loss1_gap": rel_gap(lp[0], lr[0]),
        "grad_gap": max(leaf_gaps(prog["grads1"], ref["grads1"], list(ref["grads1"]))),
        "update_gap": update_gap,
        "leaf_moves": moved_wrong,
        "loss_gap_max": max(rel_gap(p, r) for p, r in zip(lp, lr)),
        "excluded_leaves": len(ref["grads1"]) - len(moving),
    }


def program_trajectory(probe) -> dict:
    return {"losses": [b["loss"] for b in probe.batches],
            "grads1": {k: v.double() for k, v in probe.grads1.items()},
            "delta": {k: probe.params_last[k].double() - probe.params0[k].double()
                      for k in probe.params0}}


def _arch(config: dict):
    return importlib.import_module(f"{__package__}.reference.{config['model']['arch']}")


def initial_state(config: dict, seed: int, device) -> dict:
    """The benchmark's initial weights, Adam at step 0."""
    specs = _arch(config).param_specs(config["model"])
    return {"params": streams.uniform_leaves(specs, seed, device), "m": None, "v": None, "t": 0}


def reference_trajectory(config: dict, start: dict, batches: Iterable, gen: torch.Generator,
                         device, *, dtype=REFERENCE_DTYPE, probe=None,
                         mean_grads: Optional[Callable] = None) -> tuple:
    """The reference's steps over ``batches``, each ``(ids, layers, x0,
    labels, mask)`` (``ids``: the layers as the program sees them, to hold
    its sampler to; ``layers``: full-graph ids and masks; ``x0``: the
    features of layer 0), from ``start`` (``params``, Adam's ``m``, ``v``
    and ``t``), dropout from ``gen``; ``mean_grads`` averages a step's flat
    gradient over data-parallel ranks.  With ``probe``, the program's
    batches are held to them.  ``(trajectory, sample_mismatch,
    fetch_mismatch)``."""
    model = config["model"]
    arch = _arch(config)
    params = {k: v.to(device, dtype).requires_grad_(True) for k, v in start["params"].items()}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(params, config["train"]["lr"], m=start["m"], v=start["v"], t=start["t"])
    sample_bad = fetch_bad = 0
    losses, grads1 = [], None
    for s, (ids, layers, x0, labels, mask) in enumerate(batches):
        if probe is not None:
            got = probe.batches[s]
            for (i, m), pid, pm in zip(ids, got["ids"], got["masks"]):
                sample_bad += int((i.cpu() != pid.long()).sum()) + int((m.cpu() != pm).sum())
            sample_bad += int((labels.cpu() != got["labels"].long()).sum())
            fetch_bad += int((got["feats"][:x0.shape[0]].to(device, torch.float32) != x0).sum())
        logits = arch.forward(params, layers, x0.to(dtype), model, config["sampler"]["fanouts"],
                              gen)
        loss = masked_cross_entropy(logits, labels, mask)
        g = torch.autograd.grad(loss, list(params.values()))
        if mean_grads is not None:
            flat = mean_grads(torch.cat([x.reshape(-1) for x in g]))
            g, at = [], 0
            for p in params.values():
                g.append(flat[at:at + p.numel()].view(p.shape).to(dtype))
                at += p.numel()
        g = dict(zip(params, g))
        if s == 0:
            grads1 = {k: v.detach().cpu().double() for k, v in g.items()}
        opt.step(params, g)
        losses.append(float(loss.detach()))
    traj = {"losses": losses, "grads1": grads1,
            "delta": {k: (params[k].detach() - p0[k]).cpu().double() for k in params}}
    return traj, sample_bad, fetch_bad


class Inputs:
    """The run's inputs on the reference's device: the graph the program
    samples, the features, labels and train vertices of the configuration's
    dataset.  :meth:`part` makes a data-parallel rank's: its part's closure
    (``reference/partition.py``), its own randomness, and the lockstep step
    count."""

    def __init__(self, arrays: dict, device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.device = device
        self.indptr, self.indices = put(arrays["indptr"]), put(arrays["indices"])
        self.features, self.labels = put(arrays["features"]), put(arrays["labels"])
        self.train = put(arrays["train"])
        self.local2full: Optional[torch.Tensor] = None
        self.rank: Optional[int] = None
        self.steps: Optional[int] = None

    @classmethod
    def part(cls, arrays: dict, belongs: np.ndarray, rank: int, hops: int, steps: int,
             device) -> "Inputs":
        inp = cls({**arrays, "train": arrays["train"][belongs == rank]}, device)
        inp.local2full, inp.indptr, inp.indices, inp.train = ref_partition.closure(
            inp.indptr, inp.indices, inp.train, hops)
        inp.rank, inp.steps = rank, steps
        return inp

    def num_batches(self, config: dict) -> int:
        return self.steps or num_batches(self.train.shape[0], config["sampler"]["batch_size"])

    def epoch(self, config: dict, seed: int, epoch: int):
        """Seeds, mask and draws of every step of an epoch."""
        b = config["sampler"]["batch_size"]
        nb = self.num_batches(config)
        perm, draws = streams.epoch_randomness(seed, epoch, self.train.shape[0], nb, b,
                                               hop_fanouts(config), self.device, self.rank)
        seeds, mask = streams.epoch_schedule(perm, self.train, nb, b,
                                             wrapped_valid=self.rank is not None)
        return seeds, mask, draws

    def layers(self, config: dict, seeds, mask, draws, step: int):
        return ref_sampler.sample_layers(self.indptr, self.indices, seeds[step], mask[step],
                                         hop_fanouts(config), [d[step] for d in draws])

    def batches(self, config: dict, seed: int, epoch: int, steps: Optional[int] = None,
                counts: Optional[List[int]] = None):
        """The first ``steps`` (all) batches of an epoch, as
        :func:`reference_trajectory` takes them; the valid edges and
        vertices added to ``counts``."""
        seeds, mask, draws = self.epoch(config, seed, epoch)
        for s in range(self.num_batches(config) if steps is None else steps):
            layers = self.layers(config, seeds, mask, draws, s)
            if counts is not None:
                counts[0] += ref_sampler.valid_edge_count(layers)
                counts[1] += ref_sampler.valid_vertex_count(layers)
            full = (layers if self.local2full is None
                    else [(self.local2full[i], m) for i, m in layers])
            yield layers, full, self.features[full[0][0]], self.labels[full[-1][0]], mask[s]

    def dropout_generator(self, config: dict, seed: int, epoch: int) -> torch.Generator:
        """The dropout generator as the program's stands when ``epoch``
        starts: on one device seeded once and run on through the epochs
        before it, on a data-parallel rank reseeded for the epoch."""
        gen = torch.Generator(device=self.device)
        if self.rank is not None:
            return gen.manual_seed(streams.epoch_seed(seed, epoch, self.rank, 1))
        gen.manual_seed(streams.dropout_seed(seed))
        if epoch == 0:
            return gen
        _, layers, x0, _, _ = next(self.batches(config, seed, epoch, 1))
        params = {k: v.to(REFERENCE_DTYPE) for k, v in
                  initial_state(config, seed, self.device)["params"].items()}

        def draw_step(g):
            with torch.no_grad():
                _arch(config).forward(params, layers, x0.to(REFERENCE_DTYPE), config["model"],
                                      config["sampler"]["fanouts"], g)

        return streams.advance(gen, epoch * self.num_batches(config), draw_step)


def fetch_bytes(ids: torch.Tensor, feat_dim: int) -> float:
    """Least bytes of one layer-0 fetch of f32 rows: 4 an id, each output row
    and each distinct source row once (``chip_smoke.py``'s count)."""
    n = ids.shape[0]
    return 4.0 * n + 4.0 * n * feat_dim + 4.0 * feat_dim * int(torch.unique(ids).numel())


def take_rows_bytes(inp: Inputs, config: dict, seed: int, epochs) -> float:
    """Least bytes of the layer-0 fetches of every step of ``epochs``."""
    return sum(fetch_bytes(batch[0][0][0], config["data"]["feat_dim"])
               for e in epochs for batch in inp.batches(config, seed, e))


def epoch_counts(inp: Inputs, config: dict, seed: int, epoch: int) -> List[int]:
    """Valid sampled edges and vertices of a whole epoch, by the reference
    sampler (this rank's, on a data-parallel rank)."""
    counts = [0, 0]
    for _ in inp.batches(config, seed, epoch, counts=counts):
        pass
    return counts


def first_steps(inp: Inputs, config: dict, seed: int, probe, steps: int,
                dtype=REFERENCE_DTYPE, mean_grads: Optional[Callable] = None
                ) -> Dict[str, float]:
    """The reference's first ``steps`` steps of epoch 0, from the inputs and
    the seed, against what the probe read from the program."""
    ref, sample_bad, fetch_bad = reference_trajectory(
        config, initial_state(config, seed, inp.device), inp.batches(config, seed, 0, steps),
        inp.dropout_generator(config, seed, 0), inp.device, dtype=dtype, probe=probe,
        mean_grads=mean_grads)
    numbers = compare(program_trajectory(probe), ref)
    numbers.update(sample_mismatch=sample_bad, fetch_mismatch=fetch_bad)
    return numbers


def replay(inp: Inputs, config: dict, seed: int, snap: dict, prog_loss: float,
           mean_grads: Optional[Callable] = None,
           mean_loss: Callable[[float], float] = float) -> tuple:
    """The reference over the whole of the epoch that ``snap``
    (:meth:`probe.EpochSnapshot.read`) holds, from the program's state
    before it, against the state after it and the epoch's mean loss
    ``prog_loss``; ``mean_loss`` turns this rank's mean into the ranks'.
    ``(numbers, [edges, vertices] of the epoch)``."""
    counts = [0, 0]
    ref = replay_reference(inp, config, seed, snap, mean_grads=mean_grads, counts=counts)
    before, after = snap["before"]["params"], snap["after"]["params"]
    prog = {"losses": [prog_loss],
            "delta": {k: after[k].double() - p.double() for k, p in before.items()}}
    return replay_compare(prog, ref, mean_loss), counts


def replay_reference(inp: Inputs, config: dict, seed: int, snap: dict, *,
                     dtype=REFERENCE_DTYPE, mean_grads: Optional[Callable] = None,
                     counts: Optional[List[int]] = None) -> dict:
    """The reference's trajectory over the epoch ``snap`` holds, from the
    program's state before it, at the step count it works out itself."""
    epoch = snap["epoch"]
    start = {**snap["before"], "t": epoch * inp.num_batches(config)}
    return reference_trajectory(config, start, inp.batches(config, seed, epoch, counts=counts),
                                inp.dropout_generator(config, seed, epoch), inp.device,
                                dtype=dtype, mean_grads=mean_grads)[0]


def _whole_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Sequence[str]) -> float:
    """The gap of the norms of all ``leaves`` together."""
    p, r = (float(torch.cat([d[k].reshape(-1) for k in leaves]).norm()) for d in (prog, ref))
    return rel_gap(p, r)


def replay_compare(prog: dict, ref: dict, mean_loss: Callable[[float], float] = float
                   ) -> Dict[str, float]:
    """The replayed epoch's numbers of ``prog`` (its mean loss the one entry
    of ``losses``, its ``delta``) against the reference ``ref``."""
    moving = moving_leaves(ref["grads1"])
    update_gap, moved_wrong = update_numbers(prog["delta"], ref["delta"], moving)
    whole = [float(torch.cat([d[k].reshape(-1) for k in moving]).norm())
             for d in (prog["delta"], ref["delta"])]
    return {"replay_loss_gap": rel_gap(mean_loss(float(np.mean(prog["losses"]))),
                                       mean_loss(float(np.mean(ref["losses"])))),
            "replay_update_gap": update_gap, "replay_leaf_moves": moved_wrong,
            "replay_update_gap_whole": rel_gap(*whole)}


def witness(inp: Inputs, config: dict, seed: int, probe, steps: int) -> Dict[str, dict]:
    """The look behind a seed's gaps: the program against the float32 and the
    float64 reference, and the float32 reference against the float64 one."""
    trajs = {}
    for name, dtype in (("ref32", torch.float32), ("ref64", torch.float64)):
        trajs[name] = reference_trajectory(config, initial_state(config, seed, inp.device),
                                           inp.batches(config, seed, 0, steps),
                                           inp.dropout_generator(config, seed, 0), inp.device,
                                           dtype=dtype)[0]
    prog = program_trajectory(probe)
    return {"prog_vs_ref32": compare(prog, trajs["ref32"]),
            "prog_vs_ref64": compare(prog, trajs["ref64"]),
            "ref32_vs_ref64": compare(trajs["ref32"], trajs["ref64"])}


def replay_witness(inp: Inputs, config: dict, seed: int, snap: dict) -> Dict[str, float]:
    """The look behind the replayed epoch's gaps: the float32 reference from
    the same state against the float64 one."""
    ref32, ref64 = (replay_reference(inp, config, seed, snap, dtype=d)
                    for d in (torch.float32, torch.float64))
    ref32["losses"] = [float(np.mean(ref32["losses"]))]
    return replay_compare(ref32, ref64)
