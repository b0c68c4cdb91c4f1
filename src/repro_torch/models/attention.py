"""Attention primitives of the global and local (sliding-window) layers.

Full-sequence attention streams K/V in chunks with a running-softmax
carry, the same arithmetic as the reference's ``attention_fullseq``
(with the window of a local layer and the gemma2 logit softcap). The
prefill path writes every row of the bucket (padding included); decode
masks by ``pos``, so ``valid_len`` never reaches this module.
``ring_positions`` names the absolute position each slot of a local
layer's ring cache holds. CHAI's clustered decode lives in
``repro_torch.core.chai_attention``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, rms_norm, softcap

NEG_INF = -2.0e38


def attention_fullseq(q, k, v, q_positions, kv_positions, *,
                      window=0, attn_softcap=0.0, chunk=1024):
    """Causal (optionally windowed) attention over a full K/V sequence.

    q: (B, Tq, H, hd); k, v: (B, S, KV, hd); q_positions (Tq,),
    kv_positions (S,) absolute positions. Returns (B, Tq, H, hd) in q's
    dtype; scores, softmax and the AV sum run in fp32.
    """
    b, tq, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    qs = q.reshape(b, tq, n_kv, h // n_kv, hd).float()
    scale = 1.0 / math.sqrt(hd)
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)

    # the carries shaped (and, on DTensors, placed) like the queries
    m = torch.full_like(qs[..., 0], NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qs)
    for c0 in range(0, s, chunk):
        k_i = k[:, c0:c0 + chunk].float()
        v_i = v[:, c0:c0 + chunk].float()
        p_i = kv_positions[c0:c0 + chunk]
        sc = torch.einsum("btkgd,bckd->btkgc", qs, k_i) * scale
        sc = softcap(sc, attn_softcap)
        mask = p_i[None, :] <= q_positions[:, None]          # (Tq, C)
        if window and window > 0:
            mask &= (q_positions[:, None] - p_i[None, :]) < window
        sc = torch.where(mask[None, :, None, None, :], sc, NEG_INF)
        # keep m finite so fully-masked rows produce p=0, not p=1
        m_new = torch.clamp(torch.maximum(m, sc.amax(-1)), min=-1e30)
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("btkgc,bckd->btkgd",
                                                    p, v_i)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(b, tq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_positions, pos, *, window=0,
                     attn_softcap=0.0):
    """One-token decode against a cache (the reference's
    ``decode_attention``): q (B, H, hd); caches (B, KV, S, hd);
    kv_positions (S,) the absolute position of each cache slot (ring-aware,
    -1 for an empty one); pos a scalar, the query's position. Slots at
    positions 0..pos (inside the window when > 0) are visible; scores,
    softmax and the AV sum run in fp32. Returns (B, H, hd) in q's
    dtype."""
    b, h, hd = q.shape
    n_kv = k_cache.shape[1]
    qs = q.reshape(b, n_kv, h // n_kv, hd).float()
    sc = torch.einsum("bkgd,bksd->bkgs", qs, k_cache.float()) / math.sqrt(hd)
    sc = softcap(sc, attn_softcap)
    valid = (kv_positions >= 0) & (kv_positions <= pos)
    if window and window > 0:
        valid &= (pos - kv_positions) < window
    sc = torch.where(valid[None, None, None, :], sc, NEG_INF)
    out = torch.einsum("bkgs,bksd->bkgd", torch.softmax(sc, dim=-1),
                       v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def ring_positions(pos, size):
    """Absolute position stored in each slot of a ring buffer of ``size``
    (the reference's ``ring_positions``, batched): slot s holds the latest
    t < pos with t % size == s, or -1 if there is none yet. pos: int
    tensor (...,) -> (..., size) int32."""
    slots = torch.arange(size, dtype=torch.int32, device=pos.device)
    p = pos.to(torch.int32)[..., None]
    last = p - 1 - torch.remainder(p - 1 - slots, size)
    return torch.where(last >= 0, last, -1).to(torch.int32)


def project_qkv(x, p, cfg, positions):
    """x: (B, T, d) -> rotary-encoded q (B, T, H, hd), k/v (B, T, KV, hd).
    ``p`` is one layer's attention parameters. With ``cfg.qk_norm``
    (gemma3, qwen3) q and k are RMS-normed over head_dim by ``q_norm`` /
    ``k_norm`` after the projection and before RoPE, as the reference
    does."""
    q = torch.einsum("btd,dhe->bthe", x, p["wq"])
    k = torch.einsum("btd,dke->btke", x, p["wk"])
    v = torch.einsum("btd,dke->btke", x, p["wv"])
    q, k = qk_norm(q, k, p, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def qk_norm(q, k, p, cfg):
    """The per-head RMSNorm of q and k (``q_norm`` / ``k_norm`` over the
    last axis, head_dim) under ``cfg.qk_norm``; else q and k as they are.
    Either may be None. Per head, so it commutes with any gather of
    heads."""
    if not cfg.qk_norm:
        return q, k
    if q is not None:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if k is not None:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def output_proj(attn_out, p):
    """(B, T, H, hd) @ (H, hd, d) -> (B, T, d)."""
    return torch.einsum("bthe,hed->btd", attn_out, p["wo"])
