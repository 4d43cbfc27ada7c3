"""Checkpoint save and restore, and checkpoint-replay evaluation (the port of
``pagraph_tpu/train/checkpoint.py``).

A checkpoint is one ``torch.save`` file at ``<ckpt_dir>/<arch>_<epoch>``,
the JAX package's naming (the reference's ``eval.py`` reads
``checkpoint/{arch}_{epoch}``), so :func:`list_checkpoints` parses names as
the JAX package does; the port neither reads nor writes the JAX package's
orbax checkpoints.  It holds the whole :class:`TrainState`: the parameters,
Adam's moments and step counts, the learning-rate tensor, the update counts
(``step`` and ``step_t``) and the dropout generator's state, and, on the
host path, the sampler's random state, so that a run resumed from it
continues as the uninterrupted run would (the JAX package's checkpoint does
not hold its sampler's state, so its host path resumes with a fresh batch
order).

:func:`restore_checkpoint` copies into the state's own tensors, in place:
CUDA graphs captured over a train state read its tensors at their
addresses, and replay the restored values.  A tensor that does not exist
yet (Adam's moments before the first step) is created, unless
``in_place_only`` says graphs hold the state, and then it raises.

CV-GCN's histories live outside the train state and go into a sidecar,
``<arch>_<epoch>.aux`` (the JAX package's name; :func:`list_checkpoints`
does not list it): one ``torch.save`` file of ``{"hist": [...], "agg":
[...]}``, f32 CPU tensors ``[N, w_b]`` a block (the JAX package writes an
orbax directory there; neither package reads the other's).
:func:`restore_aux` returns ``None`` for a checkpoint without one.  The
multi-process aux shards wait for multi-device CV-GCN (ROADMAP queue 1
item 7c).

Data-parallel training (``parallel/dp_trainer.py``) saves through
:func:`save_checkpoint` from rank 0 alone, without sampler state (the JAX
package's data-parallel checkpoint has none), and every rank restores the
same file with :func:`restore_checkpoint`, in place.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from .state import TrainState


def _ckpt_path(ckpt_dir: str, arch: str, epoch: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"{arch}_{epoch}"))


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _save(obj, path: str) -> None:
    """``torch.save`` to a temporary name moved into place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, arch: str, epoch: int, state: TrainState, *,
                    sampler=None, aux: Optional[Dict[str, list]] = None) -> str:
    """Write ``<ckpt_dir>/<arch>_<epoch>`` (to a temporary name moved into
    place) and return its path.  ``sampler``: a host-path
    ``NeighborSampler``, whose random state is saved too.  ``aux``:
    CV-GCN's ``{"hist": [...], "agg": [...]}`` (numpy arrays or tensors),
    written to the ``.aux`` sidecar."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, arch, epoch)
    opt = state.optimizer
    ckpt = {
        "arch": arch,
        "epoch": epoch,
        "model": {k: _cpu(v) for k, v in state.model.state_dict().items()},
        "optimizer": {name: {k: _cpu(v) for k, v in opt.state[p].items()}
                      for name, p in state.model.named_parameters() if p in opt.state},
        "lr": _cpu(torch.as_tensor(opt.param_groups[0]["lr"])),
        "step": state.step,
        "step_t": _cpu(state.step_t),
        "generator": state.generator.get_state(),
        "sampler": None if sampler is None else sampler.rng.bit_generator.state,
    }
    _save(ckpt, path)
    if aux is not None:
        _save({k: [_cpu(torch.as_tensor(t)) for t in v] for k, v in aux.items()},
              path + ".aux")
    return path


def restore_aux(ckpt_dir: str, arch: str, epoch: int) -> Optional[Dict[str, list]]:
    """The ``.aux`` sidecar of checkpoint ``<arch>_<epoch>`` (CPU tensors),
    or ``None`` when it has none."""
    path = _ckpt_path(ckpt_dir, arch, epoch) + ".aux"
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(ckpt_dir: str, arch: str, epoch: int, state: TrainState, *,
                       sampler=None, in_place_only: bool = False) -> TrainState:
    """Copy checkpoint ``<arch>_<epoch>`` into ``state`` (and ``sampler``'s
    random state, where the checkpoint has one), tensor by tensor in place;
    returns ``state``.  ``in_place_only``: raise rather than create a tensor
    that the state lacks (CUDA graphs hold the state)."""
    # weights_only=False: the sampler's state is a dict of Python ints
    ckpt = torch.load(_ckpt_path(ckpt_dir, arch, epoch), map_location="cpu",
                      weights_only=False)
    opt = state.optimizer
    capturable = opt.defaults.get("capturable", False)
    with torch.no_grad():
        for name, t in state.model.state_dict(keep_vars=True).items():
            t.copy_(ckpt["model"][name])
        for name, p in state.model.named_parameters():
            saved = ckpt["optimizer"].get(name)
            have = opt.state.get(p)
            if saved is None:
                if have:
                    raise ValueError(f"checkpoint {arch}_{epoch} has no optimizer "
                                     f"state for {name}")
                continue
            if have and set(have) == set(saved):
                for k, v in saved.items():
                    have[k].copy_(v)
            elif in_place_only:
                raise RuntimeError(
                    f"cannot restore the optimizer state of {name} in place: CUDA "
                    "graphs hold the train state and it has no such tensors yet")
            else:
                opt.state[p] = {k: v.to(p.device if k != "step" or capturable else "cpu")
                                for k, v in saved.items()}
        lr = opt.param_groups[0]["lr"]
        if isinstance(lr, torch.Tensor):
            lr.copy_(ckpt["lr"])
        else:
            opt.param_groups[0]["lr"] = float(ckpt["lr"])
        state.step_t.copy_(ckpt["step_t"])
    state.step = int(ckpt["step"])
    state.generator.set_state(ckpt["generator"])
    if sampler is not None and ckpt.get("sampler") is not None:
        sampler.rng.bit_generator.state = ckpt["sampler"]
    return state


def list_checkpoints(ckpt_dir: str, arch: str) -> List[int]:
    """The epochs of the checkpoints of ``arch`` in ``ckpt_dir``, sorted."""
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(rf"^{re.escape(arch)}_(\d+)$")
    out = []
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def evaluate_checkpoints(
    cfg: Config,
    ckpt_dir: str,
    graph,
    features: np.ndarray,
    labels: np.ndarray,
    mask: np.ndarray,
    *,
    interval: int = 1,
    template: Optional[TrainState] = None,
    backend: str = "auto",
    device=None,
) -> Dict[int, float]:
    """Replay saved checkpoints (every ``interval``-th) on the masked
    vertices and report accuracy by epoch (the reference's ``eval.py`` main
    loop).  ``template``: the state to restore into (a fresh one on
    ``device`` when ``None``)."""
    from ..models.inference import evaluate
    from .state import create_state

    if template is None:
        template = create_state(cfg, device=device)
    results: Dict[int, float] = {}
    for epoch in list_checkpoints(ckpt_dir, cfg.model.arch)[::interval]:
        restore_checkpoint(ckpt_dir, cfg.model.arch, epoch, template)
        results[epoch] = evaluate(template.model, cfg.model, graph, features, labels,
                                  mask, backend=backend)
    return results
