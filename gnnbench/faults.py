"""Faults planted in the program underneath a run, for the tests that see
``correct`` come out false and for the readings that set the limits
(``calibrate.py``).  Each patches the program's modules, or the Trainer the
run builds (through the run's hook), for as long as its context lasts.

A fault is planted before the first step, or with the prefix ``replay_``
(``replay_frozen``, ``replay_half_batch``, ...) once epoch 0 has run, before
the graphs are captured: then only the replayed epochs carry it, and the
eager epoch that the first-step check reads is sound."""
from __future__ import annotations

import contextlib
import sys
import types
from typing import Iterator

REPLAY = "replay_"


class _Patches:
    """Attributes and dictionary items set for a while, and put back."""

    def __init__(self):
        self._undo = []

    def attr(self, obj, name: str, value) -> None:
        old = getattr(obj, name)
        self._undo.append(lambda: setattr(obj, name, old))
        setattr(obj, name, value)

    def item(self, d: dict, key, value) -> None:
        had, old = key in d, d.get(key)
        self._undo.append(lambda: d.__setitem__(key, old) if had else d.pop(key, None))
        d[key] = value

    def restore(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def _frozen(p: _Patches, trainer) -> None:
    """A step that returns its state unchanged: Adam's update never runs."""
    p.attr(trainer.state.optimizer, "step", lambda *a, **k: None)


def _half_batch(p: _Patches, trainer) -> None:
    """Half of the batch left out, the loss the mean over the rest."""
    from pagraph_tpu_torch.train import state

    orig = state.masked_cross_entropy

    def half(logits, labels, mask):
        m = mask.clone()
        m[m.shape[0] // 2:] = False
        return orig(logits, labels, m)

    p.attr(state, "masked_cross_entropy", half)


def _altered_fetch(p: _Patches, trainer) -> None:
    """One layer-0 value altered where the fetch produces it."""
    from pagraph_tpu_torch.train import device_epoch

    orig = device_epoch.take_rows

    def take(*a, **k):
        out = orig(*a, **k)
        out[0, 0] += 1.0
        return out

    p.attr(device_epoch, "take_rows", take)


def _altered_sample(p: _Patches, trainer) -> None:
    """One sampled id altered where the sampler produces it."""
    from pagraph_tpu_torch.train import device_epoch

    orig = device_epoch.sample_minibatch_device

    def sample(csr, *a, **k):
        mb = orig(csr, *a, **k)
        ids = mb.layer_nids[0]
        ids[-1:] = (ids[-1:] + 1) % csr.num_nodes
        return mb

    p.attr(device_epoch, "sample_minibatch_device", sample)


def _no_exchange(p: _Patches, trainer) -> None:
    """The gradient exchange between ranks left out: each rank trains on its
    own gradients."""
    from pagraph_tpu_torch.parallel import train_step

    p.attr(train_step.GradSync, "sync", lambda self: None)


def _jax_loaded(p: _Patches, trainer) -> None:
    """A module named ``jax`` in the process: not a fault of the program's
    arithmetic, but one that the harness's look at ``sys.modules`` has to
    find."""
    p.item(sys.modules, "jax", types.ModuleType("jax"))


FAULTS = {"frozen": _frozen, "half_batch": _half_batch, "altered_fetch": _altered_fetch,
          "altered_sample": _altered_sample, "no_exchange": _no_exchange,
          "jax_loaded": _jax_loaded}
_ON_TRAINER = {"frozen"}        # planted on the Trainer the run builds


@contextlib.contextmanager
def planted(name: str, run) -> Iterator[None]:
    base = name[len(REPLAY):] if name.startswith(REPLAY) else name
    fault = FAULTS[base]
    phase = "replay" if base != name else "trainer" if base in _ON_TRAINER else None
    patches = _Patches()
    hook = run.hook

    def at(ph, objs):
        if hook is not None:
            hook(ph, objs)
        if ph == phase:
            fault(patches, objs["trainer"])

    if phase is None:
        fault(patches, None)
    else:
        run.hook = at
    try:
        yield
    finally:
        patches.restore()
        run.hook = hook
