"""Online cluster-membership identification (paper §3.3, Fig 10b).

After ``warmup_tokens`` MHA decode steps, per-head attention-score
features are standardized (so squared distance is 2·(1 − Pearson r)) and
clustered with K-Means to decide which heads share a representative.
Two modes, as in the reference:

* MHA (n_kv == n_heads): global clustering across all H heads, ctx
  ``h2c (nA, B, H)`` and ``reps (nA, B, k_max)``; enables the clustered
  K cache.
* GQA: block-diagonal clustering within each KV group (a
  representative's scores are valid only for the heads that share its
  K): ``r_max`` clusters per group over the group's ``q_per_kv`` heads,
  ctx ``cluster_of (nA, B, KV, qpk)`` (cluster within the group) and
  ``reps (nA, B, KV, r_max)`` (head within the group). The K cache stays
  per group: the saving is compute only.

Membership is per request. The continuous engine identifies one slot at
a time (``identify_membership_slot``) and scatters the result into its
batched buffer (``init_batched_ctx`` / ``update_ctx_slot``).
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

    Returns a batched ctx, all (layer, request[, group]) problems solved
    in one batched K-Means:
      MHA: {"h2c": (nA, B, H) int32, "reps": (nA, B, k_max) int32}
      GQA: {"cluster_of": (nA, B, KV, qpk) int32,
            "reps": (nA, B, KV, r_max) int32}"""
    k_max, r_max = chai_widths(cfg)
    if not cfg.is_mha:
        na, b, h, f = scores.shape
        scores = scores.reshape(na, b, cfg.n_kv_heads, cfg.q_per_kv, f)
    k = k_max if cfg.is_mha else r_max
    f = standardize(scores)
    assign, centers, _ = kmeans(f, k, cfg.chai.kmeans_iters)
    reps, _ = representatives(f, assign, centers, k)
    return {("h2c" if cfg.is_mha else "cluster_of"): assign.to(torch.int32),
            "reps": reps}


def membership_churn(prev_ctx, new_ctx):
    """Fraction of heads whose cluster id changed between two ctxs (the
    paper's Fig. 9 metric): ``h2c`` (MHA) or ``cluster_of`` (GQA), as
    ``new_ctx`` holds it. Returns a 0-d fp32 tensor."""
    key = "h2c" if "h2c" in new_ctx else "cluster_of"
    return (prev_ctx[key] != new_ctx[key]).float().mean()


def identify_membership_slot(scores, cfg: ModelConfig, identify_fn=None):
    """Membership for ONE request. scores: (nA, H, F).

    Returns a batch-free ctx (MHA: h2c (nA, H), reps (nA, k); GQA:
    cluster_of (nA, KV, qpk), reps (nA, KV, r)).
    ``identify_fn``: the batched identification hook (scores with a batch
    dim -> batched ctx), ``identify_membership`` by default; the engine
    passes its own so that a replaced hook applies."""
    fn = identify_fn if identify_fn is not None else (
        lambda s: identify_membership(s, cfg))
    return {k: v[:, 0] for k, v in fn(scores[:, None]).items()}


def shared_ctx(cfg: ModelConfig, device=None):
    """A membership made without observing activations (the reference's
    ``shared_ctx``; the paper's round-robin baseline): heads go to
    clusters round-robin, every cluster non-empty, each cluster's first
    member its representative. Batch-free: MHA h2c (nA, H), reps (nA,
    k_max); GQA cluster_of (nA, KV, qpk), reps (nA, KV, r_max)."""
    k_max, r_max = chai_widths(cfg)
    na = cfg.n_attn_layers
    ar = lambda n: torch.arange(n, dtype=torch.int32,  # noqa: E731
                                device=device)
    if cfg.is_mha:
        return {"h2c": (ar(cfg.n_heads) % k_max).repeat(na, 1),
                "reps": ar(k_max).repeat(na, 1)}
    return {"cluster_of": (ar(cfg.q_per_kv) % r_max).repeat(
                na, cfg.n_kv_heads, 1),
            "reps": ar(r_max).repeat(na, cfg.n_kv_heads, 1)}


def ctx_structs(cfg: ModelConfig, batch: int = 0):
    """(tree of ``Struct``, tree of ``Ax``) of a chai ctx: the shared
    ctx (``shared_ctx``) with ``batch`` 0, else the batched one
    (``init_batched_ctx``), with the reference's logical names."""
    from repro_torch.sharding.rules import Ax, Struct
    k_max, r_max = chai_widths(cfg)
    na = cfg.n_attn_layers
    bdims = (batch,) if batch else ()
    bax = ("batch",) if batch else ()
    i32 = torch.int32
    if cfg.is_mha:
        return ({"h2c": Struct((na, *bdims, cfg.n_heads), i32),
                 "reps": Struct((na, *bdims, k_max), i32)},
                {"h2c": Ax("layers", *bax, None),
                 "reps": Ax("layers", *bax, "clusters")})
    qpk = cfg.q_per_kv
    return ({"cluster_of": Struct((na, *bdims, cfg.n_kv_heads, qpk), i32),
             "reps": Struct((na, *bdims, cfg.n_kv_heads, r_max), i32)},
            {"cluster_of": Ax("layers", *bax, "kv_heads", None),
             "reps": Ax("layers", *bax, "kv_heads", None)})


def init_batched_ctx(cfg: ModelConfig, batch: int, device):
    """All-zero per-request membership buffers (MHA: h2c (nA, B, H), reps
    (nA, B, k_max); GQA: cluster_of (nA, B, KV, qpk), reps (nA, B, KV,
    r_max)). Zeros are valid indices (every head in cluster 0,
    representative head 0), so a slot that is not STEADY yet can run
    through the clustered path harmlessly; its row is overwritten by
    ``update_ctx_slot`` before its first STEADY decode."""
    k_max, r_max = chai_widths(cfg)
    lead = (cfg.n_attn_layers, batch)
    if cfg.is_mha:
        shapes = {"h2c": lead + (cfg.n_heads,), "reps": lead + (k_max,)}
    else:
        kv = (cfg.n_kv_heads,)
        shapes = {"cluster_of": lead + kv + (cfg.q_per_kv,),
                  "reps": lead + kv + (r_max,)}
    return {k: torch.zeros(shape, dtype=torch.int32, device=device)
            for k, shape in shapes.items()}


def update_ctx_slot(ctx, slot_ctx, slot):
    """Scatter one request's batch-free ctx into batch slot ``slot`` (in
    place; returns ``ctx``)."""
    for k, v in slot_ctx.items():
        ctx[k][:, slot] = v.to(ctx[k].dtype)
    return ctx
