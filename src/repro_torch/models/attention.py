"""Attention primitives for the dense global-attention path.

Full-sequence attention streams K/V in chunks with a running-softmax
carry, the same arithmetic as the reference's ``attention_fullseq``. The
prefill path writes every row of the bucket (padding included); decode
masks by ``pos``, so ``valid_len`` never reaches this module.
CHAI's clustered decode lives in ``repro_torch.core.chai_attention``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, softcap

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

    qpk = h // n_kv
    m = torch.full((b, tq, n_kv, qpk), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, tq, n_kv, qpk, hd), dtype=torch.float32,
                      device=q.device)
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


def project_qkv(x, p, cfg, positions):
    """x: (B, T, d) -> rotary-encoded q (B, T, H, hd), k/v (B, T, KV, hd).
    ``p`` is one layer's attention parameters."""
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm is not ported yet")
    q = torch.einsum("btd,dhe->bthe", x, p["wq"])
    k = torch.einsum("btd,dke->btke", x, p["wk"])
    v = torch.einsum("btd,dke->btke", x, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def output_proj(attn_out, p):
    """(B, T, H, hd) @ (H, hd, d) -> (B, T, d)."""
    return torch.einsum("bthe,hed->btd", attn_out, p["wo"])
