"""PyTorch/CUDA port of the CHAI serving system.

Same subpackage layout as the JAX package; every module here has one
counterpart there. Entry points run on the GPU unless the caller passes
``device="cpu"`` explicitly (``resolve_device``).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. A missing GPU raises instead of falling back
    to the CPU; the CPU runs only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
