"""Parameter conversion between the JAX package's pytree and the port's
``state_dict``.

The JAX GraphSAGE pytree is ``{"updates": [{"self": {"w", "b"},
"neigh": {"w", "b"}}, ...], "lstm": []}`` with ``w`` laid out ``[in, out]``;
the port keeps that layout, so the conversion is a renaming:
``updates.{i}.{self|neigh}.{w|b}``.  Leaves are numpy arrays on the JAX side
(pass ``jax.device_get(params)``) and CPU tensors on this side.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LINEARS = ("self", "neigh")
_LEAVES = ("w", "b")


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX GraphSAGE pytree (numpy leaves) -> ``state_dict`` of
    :class:`pagraph_tpu_torch.models.sage.GraphSAGE`."""
    if params.get("lstm") or "pre" in params:
        raise NotImplementedError(
            "lstm and preprocess parameters are not ported yet")
    sd = {}
    for i, upd in enumerate(params["updates"]):
        for lin in _LINEARS:
            for leaf in _LEAVES:
                arr = np.array(upd[lin][leaf], dtype=np.float32)
                sd[f"updates.{i}.{lin}.{leaf}"] = torch.from_numpy(arr)
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The reverse of :func:`params_from_jax`: numpy leaves in the JAX
    package's pytree layout."""
    n = 1 + max(int(k.split(".")[1]) for k in state_dict if k.startswith("updates."))
    updates = [
        {lin: {leaf: state_dict[f"updates.{i}.{lin}.{leaf}"].detach().cpu().numpy()
               for leaf in _LEAVES}
         for lin in _LINEARS}
        for i in range(n)
    ]
    return {"updates": updates, "lstm": []}
