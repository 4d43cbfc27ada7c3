"""Parameter conversion between the JAX package's pytree and the port's
``state_dict``.

The port keeps the JAX package's layouts (``w`` laid out ``[in, out]``), so
the conversion is a renaming of the pytree's paths, joined by dots, for
every architecture of ``models.get_model``:

* GraphSAGE: ``updates[i].{self|neigh}.{w|b}``, ``pre.{self|neigh}.{w|b}``
  under preprocess and ``lstm[i].{w_ih|w_hh|b}``;
* GCN: ``updates[i].{w|b}`` and ``dense.{w|b}`` under preprocess;
* CV-GCN: ``dense.{w|b}`` and ``updates[i].{w|b}``;
* GIN: ``updates[i].eps`` (0-d) and ``updates[i].{w1|w2}.{w|b}``;
* GAT: ``layers[i].{w|a_self|a_neigh}``.

Leaves are numpy arrays on the JAX side (pass ``jax.device_get(params)``)
and CPU tensors on this side.  The tree is told apart by its keys, so no
architecture argument is needed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = _tensor(tree)


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX pytree (numpy leaves) -> ``state_dict`` of the port's model of
    the same architecture."""
    sd: Dict[str, torch.Tensor] = {}
    _flatten(params, "", sd)
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The reverse of :func:`params_from_jax`: numpy leaves in the JAX
    package's pytree layout (an index level becomes a list; GraphSAGE's
    ``lstm`` list is present, empty, without the lstm aggregator, as the
    JAX package's ``init_params`` makes it)."""
    tree: dict = {}
    for key, value in state_dict.items():
        node, parts = tree, key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().cpu().numpy()

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    out = lists(tree)
    if "self" in (out.get("updates") or [{}])[0]:      # GraphSAGE
        out.setdefault("lstm", [])
    return out
