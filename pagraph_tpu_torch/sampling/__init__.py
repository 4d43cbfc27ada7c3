"""Sampling: fixed-shape minibatch IR, host neighbor sampler, loader.

The names are loaded on first use, so that a module of the package can be
imported without torch: the sampling service's workers import only the
host modules (``service``, ``pack``, ``native``, ``block``)."""
import importlib

_EXPORTS = {"Block": "block", "MiniBatch": "block", "PrefetchLoader": "loader",
            "NeighborSampler": "sampler", "sample_minibatch": "sampler"}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
