"""Decoder stack for dense global-attention models (the port's first slice).

Parameters keep the reference's layer-stacked layout (``param_table``):
one tensor per leaf with the layer index first, so weights cross between
the packages leaf by leaf (``repro_torch.weights``). A Python loop over
layers replaces the reference's ``lax.scan``/``lax.switch``; only the
global-attention mixer and the dense FFN are ported, and any other layer
kind raises ``NotImplementedError``.

Two entry points: ``forward_fullseq`` (prefill) and ``decode_step`` (one
token against the decode state). Unlike the reference, whose arrays are
immutable, the decode state's caches are updated IN PLACE (the state dict
passed in is the state returned), which saves a cache copy per layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, FFN_DENSE, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp
from repro_torch.models.layers import embed_lookup, rms_norm, softcap, unembed

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig):
    """Raise on what this slice of the port does not carry."""
    if any(t != ATTN_GLOBAL for t in cfg.layer_types):
        raise NotImplementedError(
            f"{cfg.name}: only global-attention layers are ported "
            "(local, RG-LRU and RWKV layers come with a later slice)")
    if any(t != FFN_DENSE for t in cfg.ffn_types):
        raise NotImplementedError(f"{cfg.name}: MoE FFN is not ported yet")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: frontends are not ported yet")
    if cfg.kv_cache_dtype:
        raise NotImplementedError("int8 KV cache is not ported yet")
    if cfg.attn_logit_softcap:
        raise NotImplementedError("attention logit softcap is not ported yet")
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm is not ported yet")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_table(cfg: ModelConfig):
    """{group: {name: (shape, init_scale)}} — the reference's table for the
    embed / unembed / final_norm / attn / ffn groups."""
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, n = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    t: Dict[str, Dict[str, tuple]] = {}
    t["embed"] = {"tok": ((cfg.vocab_size, d), 0.02)}
    if not cfg.tie_embeddings:
        t["unembed"] = {"w": ((d, cfg.vocab_size), d ** -0.5)}
    t["final_norm"] = {"scale": ((d,), 0.0)}
    t["attn"] = {
        "ln": ((n, d), 0.0),
        "wq": ((n, d, h, hd), d ** -0.5),
        "wk": ((n, d, kv, hd), d ** -0.5),
        "wv": ((n, d, kv, hd), d ** -0.5),
        "wo": ((n, h, hd, d), (h * hd) ** -0.5),
    }
    g = {
        "ln": ((n, d), 0.0),
        "w_up": ((n, d, cfg.d_ff), d ** -0.5),
        "w_down": ((n, cfg.d_ff, d), cfg.d_ff ** -0.5),
    }
    if cfg.gated_mlp:
        g["w_gate"] = ((n, d, cfg.d_ff), d ** -0.5)
    t["ffn"] = g
    return t


def init_params(cfg: ModelConfig, generator=None, device=None):
    """Random weights with the reference's shapes and init scales:
    N(0, 1) in fp32 times the leaf's scale, cast to the model dtype
    (zero-scale leaves are zeros). The bits are torch's, not jax's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = model_dtype(cfg)
    params: Dict[str, Any] = {}
    for g, grp in param_table(cfg).items():
        params[g] = {}
        for n, (shape, scale) in grp.items():
            if scale == 0.0:
                params[g][n] = torch.zeros(shape, dtype=dt, device=dev)
            else:
                w = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=dev)
                params[g][n] = w.mul_(scale).to(dt)
                del w
    return params


def layer_plan(cfg: ModelConfig):
    """Per-layer routing for the all-global dense models this slice
    serves: layer i is attention layer i, global layer i and dense FFN i."""
    check_supported(cfg)
    ids = list(range(cfg.n_layers))
    return {"attn": ids, "global": ids, "dense": ids}


def _layer(group, i):
    return {n: t[i] for n, t in group.items()}


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """{"pos": (B,) int32, "kg"/"vg": (nG, B, KV, S, hd) model dtype}."""
    check_supported(cfg)
    dt = model_dtype(cfg)
    shape = (cfg.n_global_layers, batch, cfg.n_kv_heads, max_seq,
             cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "kg": torch.zeros(shape, dtype=dt, device=device),
            "vg": torch.zeros(shape, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _unembed_w(params, cfg):
    return (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["unembed"]["w"])


def forward_fullseq(params, cfg: ModelConfig, tokens, *, state=None,
                    positions=None, logits_slice=None, valid_len=None):
    """tokens: (B, T) int. ``state``: decode state to fill (prefill) or None.

    Returns (logits, state). ``logits_slice="last"`` computes only the last
    position's logits; with ``valid_len`` ((B,) or scalar: bucketed
    prefill, tokens at index >= valid_len are right-padding) that is the
    last REAL token's, and ``pos`` starts at ``valid_len``. Padding rows
    are written to the cache too: decode masks them by ``pos`` and
    overwrites them as the sequence advances.
    """
    plan = layer_plan(cfg)
    dt = model_dtype(cfg)
    h = embed_lookup(params["embed"]["tok"], tokens).to(dt)
    b, t = h.shape[0], h.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
    pos_idx = positions.long()

    for i in range(cfg.n_layers):
        p = _layer(params["attn"], plan["attn"][i])
        xn = rms_norm(h, p["ln"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(xn, p, cfg, positions)
        y = attn_mod.attention_fullseq(q, k, v, positions, positions)
        h = h + attn_mod.output_proj(y, p)
        if state is not None:
            gi = plan["global"][i]
            state["kg"][gi].index_copy_(
                2, pos_idx, k.transpose(1, 2).to(state["kg"].dtype))
            state["vg"][gi].index_copy_(
                2, pos_idx, v.transpose(1, 2).to(state["vg"].dtype))
        pf = _layer(params["ffn"], plan["dense"][i])
        h = h + mlp.dense_ffn(rms_norm(h, pf["ln"], cfg.norm_eps), pf, cfg)

    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    vl = None
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, dtype=torch.int64, device=h.device)
        vl = vl.expand(b) if vl.ndim == 0 else vl
    if logits_slice == "last":
        if vl is None:
            h = h[:, -1:]
        else:   # bucketed prefill: each row's last REAL token
            h = h[torch.arange(b, device=h.device), vl - 1][:, None]
    logits = unembed(h, _unembed_w(params, cfg), cfg.final_logit_softcap)
    if state is not None:
        fill = (torch.full((b,), t, device=h.device) if vl is None else vl)
        state["pos"] = fill.to(torch.int32)
    return logits, state


# ---------------------------------------------------------------------------
# Decode step (one token). CHAI hooks: repro_torch/core/chai_attention.py
# ---------------------------------------------------------------------------

def _decode_attention_batched(q, kc, vc, kv_pos, pos, window, cap):
    """Per-example-position decode attention. q: (B,H,hd); kc/vc:
    (B,KV,S,hd); kv_pos: (B,S); pos: (B,). Returns (out in q's dtype,
    probs (B,KV,qpk,S) fp32)."""
    b, h, hd = q.shape
    n_kv = kc.shape[1]
    qs = q.reshape(b, n_kv, h // n_kv, hd).float()
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bkgd,bksd->bkgs", qs, kc.float()) * scale
    sc = softcap(sc, cap)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window:
        valid &= (pos[:, None] - kv_pos) < window
    sc = torch.where(valid[:, None, None, :], sc, attn_mod.NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, vc.float())
    return out.reshape(b, h, hd).to(q.dtype), p


def _plain_decode_attention(xn, p, cfg, state, gi, ai):
    """MHA/GQA decode for one token. xn: (B, d). Returns (B, H, hd).

    Writes the token's K/V rows at ``pos`` and, during CHAI WARMUP (a
    ``chai_scores`` buffer in the state), adds this step's attention
    probabilities over the first ``feature_window`` positions to the
    layer's clustering features (paper §3.3)."""
    b = xn.shape[0]
    pos = state["pos"]
    ar = torch.arange(b, device=xn.device)
    pl = pos.long()
    q, k, v = attn_mod.project_qkv(xn[:, None], p, cfg, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    kc, vc = state["kg"][gi], state["vg"][gi]
    kc[ar, :, pl, :] = k.to(kc.dtype)
    vc[ar, :, pl, :] = v.to(vc.dtype)
    s = kc.shape[2]
    kv_pos = torch.arange(s, dtype=torch.int32, device=xn.device).expand(b, s)
    y, probs = _decode_attention_batched(q, kc, vc, kv_pos, pos, 0,
                                         cfg.attn_logit_softcap)
    if "chai_scores" in state:
        wf = state["chai_scores"].shape[-1]
        state["chai_scores"][ai] += probs.reshape(b, -1, s)[:, :, :wf]
    return y


def decode_step(params, cfg: ModelConfig, tokens, state, *, chai_ctx=None,
                decode_ts=0):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) fp32,
    state) with ``pos`` advanced by one.

    ``chai_ctx`` (membership, see ``repro_torch.core.clustering``) routes
    every attention layer through Clustered Head Attention over the
    compacted ``kg_chai`` cache; ``decode_ts`` is the S-tile size of the
    fused CHAI decode kernel (the engine passes its page size)."""
    from repro_torch.core import chai_attention as chai_mod
    plan = layer_plan(cfg)
    h = embed_lookup(params["embed"]["tok"], tokens).to(model_dtype(cfg))
    for i in range(cfg.n_layers):
        ai, gi = plan["attn"][i], plan["global"][i]
        p = _layer(params["attn"], ai)
        xn = rms_norm(h, p["ln"], cfg.norm_eps)
        if chai_ctx is not None:
            y = chai_mod.chai_decode_attention(xn, p, cfg, state, gi, ai,
                                               chai_ctx, decode_ts=decode_ts)
        else:
            y = _plain_decode_attention(xn, p, cfg, state, gi, ai)
        h = h + torch.einsum("bhe,hed->bd", y, p["wo"])
        pf = _layer(params["ffn"], plan["dense"][i])
        xf = rms_norm(h, pf["ln"], cfg.norm_eps)
        h = h + mlp.dense_ffn(xf[:, None], pf, cfg)[:, 0]
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(h, _unembed_w(params, cfg), cfg.final_logit_softcap)
    state["pos"] = state["pos"] + 1
    return logits, state
