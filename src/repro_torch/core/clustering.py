"""Online cluster-membership identification (paper §3.3, Fig 10b).

After ``warmup_tokens`` MHA decode steps, per-head attention-score
features are standardized (so squared distance is 2·(1 − Pearson r)) and
clustered with K-Means to decide which heads share a representative.
Membership is per request: ``h2c (nA, B, H)`` and ``reps (nA, B, k_max)``.
The continuous engine identifies one slot at a time
(``identify_membership_slot``) and scatters the result into its batched
buffer (``init_batched_ctx`` / ``update_ctx_slot``). Only the MHA branch
is ported; GQA's block-diagonal clustering comes with the model-level GQA
slice.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.kmeans import kmeans, representatives, xla_sum


def standardize(x, eps=1e-12):
    """Per-row standardize: zero mean, unit norm -> correlation geometry
    (sums in the reference's order, see ``core.kmeans``; the square root
    is taken in fp64 so that it is correctly rounded to fp32, which
    torch's vectorized fp32 sqrt on the CPU is not always)."""
    x = x.float()
    x = x - (xla_sum(x) / x.shape[-1])[..., None]
    n = torch.sqrt(xla_sum(x.square()).double()).float()[..., None]
    return x / torch.clamp(n, min=eps)


def chai_widths(cfg: ModelConfig):
    """(k_max, r_max): static cluster widths (r_max: per-KV-group budget
    for GQA archs)."""
    k_max = cfg.k_max
    if k_max == 0:
        return 0, 0
    if cfg.is_mha:
        return k_max, k_max
    return k_max, min(max(1, math.ceil(k_max / cfg.n_kv_heads)), cfg.q_per_kv)


def identify_membership(scores, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """scores: (nA, B, H, F) accumulated warmup attention scores.

    Returns {"h2c": (nA, B, H) int32, "reps": (nA, B, k_max) int32}, all
    (layer, request) problems solved in one batched K-Means."""
    if not cfg.is_mha:
        raise NotImplementedError(
            "GQA membership (block-diagonal clustering) is not ported yet")
    k_max, _ = chai_widths(cfg)
    f = standardize(scores)
    assign, centers, _ = kmeans(f, k_max, cfg.chai.kmeans_iters)
    reps, _ = representatives(f, assign, centers, k_max)
    return {"h2c": assign.to(torch.int32), "reps": reps}


def identify_membership_slot(scores, cfg: ModelConfig, identify_fn=None):
    """Membership for ONE request. scores: (nA, H, F).

    Returns a batch-free ctx (h2c (nA, H), reps (nA, k)).
    ``identify_fn``: the batched identification hook (scores with a batch
    dim -> batched ctx), ``identify_membership`` by default; the engine
    passes its own so that a replaced hook applies."""
    fn = identify_fn if identify_fn is not None else (
        lambda s: identify_membership(s, cfg))
    return {k: v[:, 0] for k, v in fn(scores[:, None]).items()}


def init_batched_ctx(cfg: ModelConfig, batch: int, device):
    """All-zero per-request membership buffers, h2c (nA, B, H) and reps
    (nA, B, k_max). Zeros are valid indices (every head in cluster 0,
    representative head 0), so a slot that is not STEADY yet can run
    through the clustered path harmlessly; its row is overwritten by
    ``update_ctx_slot`` before its first STEADY decode."""
    if not cfg.is_mha:
        raise NotImplementedError(
            "GQA membership (block-diagonal clustering) is not ported yet")
    k_max, _ = chai_widths(cfg)
    na = cfg.n_attn_layers
    return {k: torch.zeros((na, batch, width), dtype=torch.int32,
                           device=device)
            for k, width in (("h2c", cfg.n_heads), ("reps", k_max))}


def update_ctx_slot(ctx, slot_ctx, slot):
    """Scatter one request's batch-free ctx into batch slot ``slot`` (in
    place; returns ``ctx``)."""
    for k, v in slot_ctx.items():
        ctx[k][:, slot] = v.to(ctx[k].dtype)
    return ctx
