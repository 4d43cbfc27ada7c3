"""What the program produced: in its first steps, read as the steps run,
and over a whole replayed epoch, read from its state before and after.

:class:`StepProbe` wraps ``pagraph_tpu_torch.train.device_epoch``'s
``train_on_features``, the call every on-device step (single device and
data parallel, eager or captured) makes after it has sampled its batch and
fetched layer 0.  For each of the first ``steps`` calls it keeps, on the
host: the sampled layers' ids and masks, the fetched layer-0 rows, the
step's loss, the parameters before the first step, Adam's first moment
after the first step (``(1 - beta1) g``, the gradient as the optimizer got
it), and the parameters after the last kept step.  It changes nothing the
step computes; the copies wait for the step's stream, which is why it is
only used while the first epoch runs eagerly, before any measurement.

:class:`EpochSnapshot` copies the program's parameters and Adam's moments
before the window's first epoch and after it, on the device into buffers
of its own (one ``_foreach_copy_`` each, no wait), to be read once the
window has closed.  A captured epoch cannot be looked into step by step;
the reference follows it from the state before it.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

BETA1 = 0.9


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy that no later step can write (on the CPU too, where
    ``.cpu()`` would return the program's own buffer)."""
    return t.detach().to("cpu", copy=True)


class StepProbe:
    def __init__(self, steps: int):
        self.steps = steps
        self.count = 0
        self.batches: List[dict] = []
        self.params0: Dict[str, torch.Tensor] = {}
        self.grads1: Dict[str, torch.Tensor] = {}
        self.params_last: Dict[str, torch.Tensor] = {}

    def __enter__(self) -> "StepProbe":
        from pagraph_tpu_torch.train import device_epoch

        self._module = device_epoch
        self._orig = device_epoch.train_on_features
        device_epoch.train_on_features = self._wrapped
        return self

    def __exit__(self, *exc) -> None:
        self._module.train_on_features = self._orig

    @staticmethod
    def _named(state) -> Dict[str, torch.Tensor]:
        return dict(state.model.named_parameters())

    def _wrapped(self, state, mb, feats, hists=None):
        i = self.count
        self.count += 1
        if i >= self.steps:
            return self._orig(state, mb, feats, hists)
        if i == 0:
            self.params0 = {k: _host(p) for k, p in self._named(state).items()}
        batch = {"ids": [_host(t) for t in mb.layer_nids],
                 "masks": [_host(t) for t in mb.layer_mask],
                 "labels": _host(mb.labels),
                 "feats": _host(feats)}
        out = self._orig(state, mb, feats, hists)
        batch["loss"] = float(out["loss"].item())
        self.batches.append(batch)
        named = self._named(state)
        if i == 0:
            # no moment where the optimizer never ran: the gradient it got is 0
            st = state.optimizer.state
            self.grads1 = {k: _host(st[p]["exp_avg"] / (1.0 - BETA1)) if "exp_avg" in st[p]
                           else torch.zeros(p.shape) for k, p in named.items()}
        if i == self.steps - 1:
            self.params_last = {k: _host(p) for k, p in named.items()}
        return out


class EpochSnapshot:
    """The program's state (parameters, Adam's ``m`` and ``v``) before and
    after one epoch, copied on the device into buffers of its own."""

    def __init__(self, state, epoch: int):
        src = self._sources(state)
        self.epoch = epoch
        self._before = [t.clone() for t in src]
        # the buffers, and the copy's kernels loaded, before the epoch runs
        self._after = [t.clone() for t in src]
        torch._foreach_copy_(self._after, src)

    @staticmethod
    def _sources(state) -> List[torch.Tensor]:
        st = state.optimizer.state
        out = []
        for p in state.model.parameters():
            # no moment where the optimizer never ran: it is 0
            out += [p.detach()] + [st[p][k] if k in st[p] else torch.zeros_like(p)
                                   for k in ("exp_avg", "exp_avg_sq")]
        return out

    def end(self, state) -> None:
        """The state after the epoch (one ``_foreach_copy_``, no wait)."""
        torch._foreach_copy_(self._after, self._sources(state))

    def read(self, state) -> dict:
        """On the host: ``before`` and ``after``, each the parameters,
        ``m`` and ``v`` by name."""
        names = [k for k, _ in state.model.named_parameters()]

        def by_name(tensors) -> dict:
            ts = [_host(t) for t in tensors]
            return {f: dict(zip(names, ts[i::3])) for i, f in enumerate(("params", "m", "v"))}

        return {"epoch": self.epoch, "before": by_name(self._before),
                "after": by_name(self._after)}
