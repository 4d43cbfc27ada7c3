"""The device an entry point runs on when the caller names none."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; without one that is an error, not the CPU.
    ``device="cpu"`` is the explicit way to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pagraph_tpu_torch runs on a GPU; pass "
                "device='cpu' explicitly to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
