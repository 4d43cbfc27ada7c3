"""Parameter conversion between the JAX package's pytree and the port's
``state_dict``.

The JAX GraphSAGE pytree is ``{"updates": [{"self": {"w", "b"},
"neigh": {"w", "b"}}, ...], "lstm": [{"w_ih", "w_hh", "b"}, ...]}``, with
``"pre": {"self", "neigh"}`` under preprocess and ``w`` laid out
``[in, out]``; the port keeps those layouts, so the conversion is a
renaming: ``updates.{i}.{self|neigh}.{w|b}``, ``pre.{self|neigh}.{w|b}`` and
``lstm.{i}.{w_ih|w_hh|b}``.  Leaves are numpy arrays on the JAX side (pass
``jax.device_get(params)``) and CPU tensors on this side.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LINEARS = ("self", "neigh")
_LEAVES = ("w", "b")
_LSTM_LEAVES = ("w_ih", "w_hh", "b")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def params_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX GraphSAGE pytree (numpy leaves) -> ``state_dict`` of
    :class:`pagraph_tpu_torch.models.sage.GraphSAGE`."""
    sd = {}
    upds = [(f"updates.{i}", upd) for i, upd in enumerate(params["updates"])]
    if "pre" in params:
        upds.append(("pre", params["pre"]))
    for prefix, upd in upds:
        for lin in _LINEARS:
            for leaf in _LEAVES:
                sd[f"{prefix}.{lin}.{leaf}"] = _tensor(upd[lin][leaf])
    for i, lstm in enumerate(params.get("lstm") or ()):
        for leaf in _LSTM_LEAVES:
            sd[f"lstm.{i}.{leaf}"] = _tensor(lstm[leaf])
    return sd


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The reverse of :func:`params_from_jax`: numpy leaves in the JAX
    package's pytree layout."""
    def leaf(key):
        return state_dict[key].detach().cpu().numpy()

    def upd(prefix):
        return {lin: {lf: leaf(f"{prefix}.{lin}.{lf}") for lf in _LEAVES} for lin in _LINEARS}

    def count(prefix):
        idx = [int(k.split(".")[1]) for k in state_dict if k.startswith(prefix + ".")]
        return 1 + max(idx) if idx else 0

    out = {"updates": [upd(f"updates.{i}") for i in range(count("updates"))],
           "lstm": [{lf: leaf(f"lstm.{i}.{lf}") for lf in _LSTM_LEAVES}
                    for i in range(count("lstm"))]}
    if "pre.self.w" in state_dict:
        out["pre"] = upd("pre")
    return out
