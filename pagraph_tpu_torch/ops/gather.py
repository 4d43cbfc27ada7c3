"""Row fetch from a fully cached feature table (the port of
``pagraph_tpu/ops/gather.py`` ``chunked_take``).

The on-device epoch fetches layer 0 as ``cache_values[ids]`` widened to f32
(times the scale at the int8 tier): the JAX package's
``dequantize_fused(chunked_take(cache_values, ids), scale)``.  At bf16
compute (``train.dtype="bfloat16"``) it is written as bf16, which is that
result cast by ``cast_apply``.  That is the cache assembly with no miss
rows, so it runs on the same kernel, ``pg_assemble``
(:func:`gather_kernels.assemble`), at every cache tier.

``chunked_take`` splits a gather above 2 x 128k rows into sequential chunks
because XLA on the TPU pipelines the chunks where it serializes one large
gather.  That is a scheduling trick of XLA and is not carried over: one
launch covers every row.
"""
from __future__ import annotations

from typing import Optional

import torch

from .gather_kernels import assemble


def take_rows(cache_values: torch.Tensor, ids: torch.Tensor,
              dequant_scale: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[n, D]`` rows ``cache_values[ids]`` (int32 ``ids``, each a cache
    row) as f32, times ``dequant_scale`` at the int8 tier, written as
    ``out_dtype`` (f32 or bf16): one ``pg_assemble`` launch on the card,
    counted under ``assemble_<tier>`` (``assemble_<tier>_to_bf16``)."""
    return assemble(cache_values, ids, cache_values[:0], dequant_scale, out_dtype)
