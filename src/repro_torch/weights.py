"""Weights from the reference package, through numpy.

The reference's ``init_params`` output (and its checkpoint format, one
``.npy`` per leaf) is a ``{group: {name: array}}`` tree with the layer
index first on every stacked leaf — the layout ``repro_torch`` keeps — so
the bridge is leaf by leaf with no reshaping.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                  # a writable copy torch may own
    if a.dtype.name == "bfloat16":   # ml_dtypes bf16: move the raw bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device=None, dtype=None):
    """``{group: {name: array-like}}`` -> the same tree of tensors on
    ``device`` (``None`` = CUDA), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    return {g: {n: _to_tensor(a).to(device=dev, dtype=dtype)
                for n, a in grp.items()}
            for g, grp in tree.items()}
