"""Head-score correlation analysis (paper Figs 2, 6, 7).

Pearson cross-correlation between per-head attention-score vectors: the
paper's evidence for head redundancy and the feature underlying
clustering.
"""
from __future__ import annotations

import torch


def head_correlation(scores):
    """scores: (H, F) per-head feature vectors -> (H, H) Pearson corr."""
    x = scores.float()
    x = x - x.mean(-1, keepdim=True)
    norm = torch.sqrt(torch.sum(x.square(), -1, keepdim=True))
    xh = x / torch.clamp(norm, min=1e-12)
    return xh @ xh.T


def mean_abs_offdiag(corr):
    """Scalar redundancy summary of a correlation matrix."""
    h = corr.shape[0]
    mask = 1.0 - torch.eye(h, dtype=corr.dtype, device=corr.device)
    return torch.sum(corr.abs() * mask) / torch.clamp(mask.sum(), min=1.0)
