"""Attention policies: the MHA baseline, the CHAI variants, and the paper's
comparison baselines (DejaVu head sparsity, SpAtten cascade pruning,
random clustering from Figs 1 and 14).

Full-sequence versions for the accuracy and FLOPs comparisons (paper
Tables 1-4, Figs 1, 14). The serving decode path lives in
``repro_torch.core.chai_attention``; both cluster heads with the same code
(``core.clustering.standardize``, ``core.kmeans``), so a comparison
measures the algorithm the engine runs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.clustering import standardize
from repro_torch.core.kmeans import kmeans, representatives

POLICIES = ("mha", "chai", "chai-static", "chai-qkv", "dejavu", "spatten",
            "random")


class PolicyOut(NamedTuple):
    out: torch.Tensor          # (B, T, H, hd)
    score_flops: torch.Tensor  # fp32 scalar: QK^T flops actually done
    info: dict


def _full_scores(q, k):
    """q: (B,T,H,hd), k: (B,T,H,hd) -> causal softmax scores (B,H,T,T)."""
    t, hd = q.shape[1], q.shape[3]
    sc = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(hd)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=q.device))
    sc = torch.where(mask[None, None], sc, -2e38)
    return torch.softmax(sc, dim=-1)


def _score_flops(b, t, h_eff, hd, device):
    return torch.tensor(2.0 * b * t * t * h_eff * hd, dtype=torch.float32,
                        device=device)


def _cluster_heads(a, n_clusters, warmup_tokens, iters=12):
    """Cluster heads from warmup-prefix scores. a: (B,H,T,T) probs.
    Features per head: its scores of the first ``warmup_tokens`` query
    rows. Returns (h2c (B,H) int32, reps (B,k) int32)."""
    b, h, t, _ = a.shape
    w = min(warmup_tokens, t)
    fz = standardize(a[:, :, :w, :].reshape(b, h, -1))
    assign, centers, _ = kmeans(fz, n_clusters, iters)
    reps, _ = representatives(fz, assign, centers, n_clusters)
    return assign.to(torch.int32), reps


def _take_heads(x, idx):
    """x: (B,T,H,hd); idx: (B,k) -> (B,T,k,hd), heads ``idx[b]`` of row b."""
    b, t, _, hd = x.shape
    return torch.gather(x, 2, idx.long()[:, None, :, None].expand(
        b, t, idx.shape[1], hd))


def apply_policy(policy, q, k, v, *, n_clusters=None, warmup_tokens=5,
                 sparsity=0.5, h2c_static=None, reps_static=None,
                 token_keep=0.7, generator=None):
    """Run attention under ``policy``. q, k, v: (B,T,H,hd) (MHA layout).

    CHAI policies compute scores only for the representative heads (plus
    the warmup rows for clustering); DejaVu zeroes the most uniform heads;
    SpAtten drops low-importance tokens, then heads. ``generator``: the
    ``random`` policy's ``torch.Generator`` (default: a CPU generator
    seeded 0; the reference draws from ``jax.random``)."""
    b, t, h, hd = q.shape
    dev = q.device

    if policy == "mha":
        a = _full_scores(q, k)
        out = torch.einsum("bhts,bshd->bthd", a, v.float())
        return PolicyOut(out.to(q.dtype), _score_flops(b, t, h, hd, dev),
                         {"probs": a})

    if policy in ("chai", "chai-qkv", "chai-static", "random"):
        kk = n_clusters or max(1, h // 2)
        if policy == "chai-static":
            assert h2c_static is not None and reps_static is not None
            h2c = torch.as_tensor(h2c_static, device=dev).expand(b, h)
            reps = torch.as_tensor(reps_static, device=dev).expand(b, kk)
        elif policy == "random":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            h2c1 = torch.randint(0, kk, (h,), generator=generator,
                                 device=generator.device,
                                 dtype=torch.int32).to(dev)
            # every cluster has a member: the first kk heads are pinned
            h2c1[:kk] = torch.arange(kk, dtype=torch.int32, device=dev)
            h2c = h2c1.expand(b, h)
            reps = torch.arange(kk, dtype=torch.int32, device=dev).expand(
                b, kk)
        else:
            # the warmup observation: MHA cost on the first warmup_tokens
            # rows, charged below
            h2c, reps = _cluster_heads(_full_scores(q, k), kk, warmup_tokens)
        # clustered scores: representative heads only
        a_rep = _full_scores(_take_heads(q, reps), _take_heads(k, reps))
        if policy == "chai-qkv":
            o_rep = torch.einsum("bhts,bshd->bthd", a_rep,
                                 _take_heads(v, reps).float())
            out = _take_heads(o_rep, h2c)
        else:
            a_full = torch.gather(a_rep, 1, h2c.long()[:, :, None, None]
                                  .expand(b, h, t, t))
            out = torch.einsum("bhts,bshd->bthd", a_full, v.float())
        flops = _score_flops(b, t, kk, hd, dev)
        if policy in ("chai", "chai-qkv"):
            flops = flops + _score_flops(b, warmup_tokens, h, hd, dev)
        return PolicyOut(out.to(q.dtype), flops, {"h2c": h2c, "reps": reps})

    if policy == "dejavu":
        a = _full_scores(q, k)
        # uniformity: the rows' entropy against a uniform row's; the heads
        # whose score rows are closest to uniform are pruned (DejaVu).
        ent = -torch.sum(torch.where(a > 0, a * torch.log(a + 1e-20), 0.0),
                         -1)
        row_cnt = torch.log(torch.arange(1, t + 1, dtype=torch.float32,
                                         device=dev))
        uniformity = (ent / torch.clamp(row_cnt, min=1e-6)).mean(-1)
        n_prune = int(sparsity * h)
        order = torch.argsort(-uniformity, dim=-1, stable=True)
        pruned = torch.zeros((b, h), dtype=torch.bool, device=dev)
        pruned.scatter_(1, order[:, :n_prune], True)
        out = torch.einsum("bhts,bshd->bthd", a, v.float())
        out = torch.where(pruned[:, None, :, None], 0.0, out)
        return PolicyOut(out.to(q.dtype),
                         _score_flops(b, t, h - n_prune, hd, dev),
                         {"pruned": pruned})

    if policy == "spatten":
        a = _full_scores(q, k)
        # cascade token pruning by cumulative attention importance
        imp = a.sum(dim=(1, 2))                          # (B, S)
        n_keep = max(1, int(token_keep * t))
        kept = torch.argsort(-imp, dim=-1, stable=True)[:, :n_keep]
        keep_mask = torch.zeros((b, t), dtype=torch.bool, device=dev)
        keep_mask.scatter_(1, kept, True)
        a_mask = torch.where(keep_mask[:, None, None, :], a, 0.0)
        a_mask = a_mask / torch.clamp(a_mask.sum(-1, keepdim=True), min=1e-9)
        # head pruning by accumulated head importance
        head_imp = a_mask.amax(-1).mean(-1)              # (B, H)
        n_prune = int(sparsity * h)
        order = torch.argsort(head_imp, dim=-1, stable=True)
        pruned = torch.zeros((b, h), dtype=torch.bool, device=dev)
        pruned.scatter_(1, order[:, :n_prune], True)
        out = torch.einsum("bhts,bshd->bthd", a_mask, v.float())
        out = torch.where(pruned[:, None, :, None], 0.0, out)
        return PolicyOut(out.to(q.dtype),
                         _score_flops(b, n_keep, h - n_prune, hd, dev),
                         {"pruned": pruned, "kept_tokens": keep_mask})

    raise ValueError(f"unknown policy {policy!r}")
