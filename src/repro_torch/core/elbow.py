"""Offline cluster-count selection by elbow analysis (paper §3.2, Fig 8).

Run once per model on calibration activations: for each layer, sweep k,
record the K-Means error, and pick the smallest k where the marginal
error reduction plateaus. The result feeds
``ModelConfig.chai.cluster_counts``. K-Means is the port's
(``core.kmeans``, the reference's order of sums), batched over layers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kmeans import kmeans


def elbow_curve(features, k_values):
    """features: (..., H, F) tensor (a leading index per independent
    problem, e.g. one per layer). Returns the K-Means errors as a float64
    numpy array (..., len(k_values))."""
    errs = [kmeans(features, int(k))[2] for k in k_values]
    return torch.stack(errs, dim=-1).double().cpu().numpy()


def select_k(errors, k_values, plateau_tol=0.05):
    """Smallest k whose marginal improvement over the previous k drops
    below ``plateau_tol`` of the total error range (the paper's 'error
    plateaus')."""
    errors = np.asarray(errors, dtype=np.float64)
    k_values = list(k_values)
    total = max(errors[0] - errors[-1], 1e-12)
    for i in range(1, len(k_values)):
        gain = (errors[i - 1] - errors[i]) / total
        if gain < plateau_tol:
            return k_values[i - 1]
    return k_values[-1]


def offline_cluster_counts(per_layer_features, n_heads, plateau_tol=0.05,
                           min_k=1, group_floor=1):
    """Full offline phase: the elbow-selected k of each layer.

    per_layer_features: a sequence of (H, F) tensors (one per attention
    layer, all of one shape), or one (nA, H, F) tensor. Returns
    list[int]."""
    ks = [k for k in range(1, n_heads + 1)
          if k in (1, 2) or k % 2 == 0 or k == n_heads]
    feats = (per_layer_features if torch.is_tensor(per_layer_features)
             else torch.stack(list(per_layer_features)))
    curves = elbow_curve(feats, ks)
    return [int(max(min_k, group_floor, select_k(errs, ks, plateau_tol)))
            for errs in curves]
