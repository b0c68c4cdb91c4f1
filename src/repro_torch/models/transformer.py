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
from repro_torch.kernels import ops as kops
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

def decode_state_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """{name: (shape, dtype)} of the decode state: ``pos`` (B,) int32 and
    the global caches ``kg``/``vg`` (nG, B, KV, S, hd) in the model dtype
    (the reference's ``decode_state_structs``, global-attention subset)."""
    check_supported(cfg)
    shape = (cfg.n_global_layers, batch, cfg.n_kv_heads, max_seq,
             cfg.head_dim)
    dt = model_dtype(cfg)
    return {"pos": ((batch,), torch.int32), "kg": (shape, dt),
            "vg": (shape, dt)}


def zeros_state(shapes, device):
    """Zero tensors for a ``{name: (shape, dtype)}`` table."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """{"pos": (B,) int32, "kg"/"vg": (nG, B, KV, S, hd) model dtype}."""
    return zeros_state(decode_state_shapes(cfg, batch, max_seq), device)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _unembed_w(params, cfg):
    return (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["unembed"]["w"])


def _prefix_attention(q, k, v, prefix_kv, gi, plen):
    """A chunk's attention over the cached prefix and itself, two passes
    merged by online-softmax state: the non-causal paged pass over the
    positions < plen that earlier chunks wrote (``prefix_kv``'s pool,
    layer ``gi``, read through its block tables) and the causal pass over
    the chunk's own K/V at relative offset 0. plen == 0 (a first chunk)
    leaves the paged state at the exact merge identity."""
    st_p = kops.paged_prefix_attention(q, prefix_kv["pool"][gi],
                                       prefix_kv["bt_k"], prefix_kv["bt_v"],
                                       plen)
    st_s = kops.flash_prefill_attention(q, k, v, emit_state=True)
    return kops.finalize_prefill_state(kops.merge_prefill_states(st_s, st_p),
                                       dtype=q.dtype)


def forward_fullseq(params, cfg: ModelConfig, tokens, *, state=None,
                    positions=None, logits_slice=None, valid_len=None,
                    prefix_len=None, prefix_kv=None):
    """tokens: (B, T) int. ``state``: decode state to fill (prefill) or None.

    Returns (logits, state). ``logits_slice="last"`` computes only the last
    position's logits; with ``valid_len`` ((B,) or scalar: bucketed
    prefill, tokens at index >= valid_len are right-padding) that is the
    last REAL token's, and ``pos`` starts at ``valid_len``. Padding rows
    are written to the cache too: decode masks them by ``pos`` and
    overwrites them as the sequence advances.

    ``prefix_len`` (int or (B,)) and ``prefix_kv`` ({"pool": (nG, nP, KV,
    page, hd) paged KV pool, "bt_k"/"bt_v": (B, P) block tables} holding
    positions [0, prefix_len)): the chunked prefill. This call's tokens
    sit at absolute positions ``prefix_len + arange(T)``, attend over the
    cached pages and themselves (``_prefix_attention``), write the cache
    at those positions, and ``pos`` starts at ``prefix_len + valid_len``.
    """
    plan = layer_plan(cfg)
    dt = model_dtype(cfg)
    h = embed_lookup(params["embed"]["tok"], tokens).to(dt)
    b, t = h.shape[0], h.shape[1]
    plen = None
    if prefix_len is not None:
        plen = torch.as_tensor(prefix_len, dtype=torch.int32,
                               device=h.device).expand(b)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
        if plen is not None:
            positions = positions + plen[0]
    pos_idx = positions.long()

    for i in range(cfg.n_layers):
        p = _layer(params["attn"], plan["attn"][i])
        gi = plan["global"][i]
        xn = rms_norm(h, p["ln"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(xn, p, cfg, positions)
        if prefix_kv is not None:
            y = _prefix_attention(q, k, v, prefix_kv, gi, plen)
        else:
            y = attn_mod.attention_fullseq(q, k, v, positions, positions)
        h = h + attn_mod.output_proj(y, p)
        if state is not None:
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
        if plen is not None:
            fill = fill + plen
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


def _masked_rows(write_mask, new, old):
    """Commit ``new`` only for slots in ``write_mask`` (mixed-phase step);
    identity when no mask. new/old: (B, ...)."""
    if write_mask is None:
        return new
    m = write_mask.reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def write_positions(pos, s):
    """Cache row each slot writes this step. A FREE slot's ``pos`` keeps
    advancing with every batched step until the slot is refilled; the
    reference's scatter drops such out-of-range writes, and here they are
    clamped onto the FREE slot's own last row, which is rewritten before
    it is read again."""
    return pos.long().clamp(max=s - 1)


def paged_token_coords(bt, pos, page):
    """(physical page, in-page row) for each slot's current write
    position. bt: (B, P) block table; pos: (B,). Unallocated logical
    pages map to the null sink page 0, where writes are harmless (a FREE
    slot past its table's end is clamped onto its last entry, also the
    null page)."""
    b = pos.shape[0]
    logical = (pos.long() // page).clamp(max=bt.shape[1] - 1)
    ar = torch.arange(b, device=pos.device)
    return bt[ar, logical].long(), pos.long() % page


def _paged_write_rows(pool, page_idx, row, new, write_mask):
    """Commit one token's rows into pool pages, in place. pool: (nP, rows,
    page, hd); page_idx/row: (B,); new: (B, rows, hd). Slots whose
    current page is the null page 0 (FREE slots, a STEADY slot's nulled
    dense K table) may collide there; whichever write wins, page 0 is
    never read as valid."""
    old = pool[page_idx, :, row, :]
    pool[page_idx, :, row, :] = _masked_rows(write_mask, new.to(pool.dtype),
                                             old)


def _paged_global_write(state, gi, k, v, pos, write_mask):
    """Paged-layout global-cache decode write: commit one token's K/V rows
    into each slot's current page of the shared dense pool. Returns the
    layer's pool (a view, updated in place)."""
    pool = state["kvp"][gi]                              # (nP, KV, page, hd)
    page = pool.shape[2]
    pk, row = paged_token_coords(state["bt_kg"], pos, page)
    pv, _ = paged_token_coords(state["bt_vg"], pos, page)
    _paged_write_rows(pool, pk, row, k, write_mask)
    _paged_write_rows(pool, pv, row, v, write_mask)
    return pool


def _paged_global_update(state, gi, k, v, pos, write_mask):
    """``_paged_global_write`` + dense logical views (B, KV, S, hd)
    gathered through the block tables (the attention math downstream is
    the dense layout's)."""
    from repro_torch.core.cache import gather_pages
    pool = _paged_global_write(state, gi, k, v, pos, write_mask)
    return gather_pages(pool, state["bt_kg"]), gather_pages(pool,
                                                            state["bt_vg"])


def _plain_decode_attention(xn, p, cfg, state, gi, ai, write_mask=None):
    """MHA/GQA decode for one token. xn: (B, d). Returns (B, H, hd).

    Writes the token's K/V rows at ``pos`` (dense ``kg``/``vg``, or the
    paged pool ``kvp`` through ``bt_kg``/``bt_vg``) and, during CHAI
    WARMUP (a ``chai_scores`` buffer in the state), adds this step's
    attention probabilities over the first ``feature_window`` positions
    to the layer's clustering features (paper §3.3). ``write_mask`` (B,)
    bool: rows and features are committed only for masked slots (the
    mixed-phase step runs this path alongside the CHAI path)."""
    b = xn.shape[0]
    pos = state["pos"]
    q, k, v = attn_mod.project_qkv(xn[:, None], p, cfg, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    if "kvp" in state:
        kc, vc = _paged_global_update(state, gi, k, v, pos, write_mask)
    else:
        kc, vc = state["kg"][gi], state["vg"][gi]
        ar = torch.arange(b, device=xn.device)
        pl = write_positions(pos, kc.shape[2])
        kc[ar, :, pl, :] = _masked_rows(write_mask, k.to(kc.dtype),
                                        kc[ar, :, pl, :])
        vc[ar, :, pl, :] = _masked_rows(write_mask, v.to(vc.dtype),
                                        vc[ar, :, pl, :])
    s = kc.shape[2]
    kv_pos = torch.arange(s, dtype=torch.int32, device=xn.device).expand(b, s)
    y, probs = _decode_attention_batched(q, kc, vc, kv_pos, pos, 0,
                                         cfg.attn_logit_softcap)
    if "chai_scores" in state:
        wf = state["chai_scores"].shape[-1]
        pw = probs.reshape(b, -1, s)[:, :, :wf]
        if write_mask is not None:   # steady slots: features stay frozen
            pw = pw * write_mask[:, None, None]
        state["chai_scores"][ai] += pw
    return y


def decode_step(params, cfg: ModelConfig, tokens, state, *, chai_ctx=None,
                mixed_phase=False, decode_ts=0):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) fp32,
    state) with ``pos`` advanced by one.

    ``chai_ctx`` (membership, see ``repro_torch.core.clustering``) routes
    every attention layer through Clustered Head Attention over the
    clustered K cache (``kg_chai``, or the paged pool ``cp``);
    ``decode_ts`` is the S-tile size of the dense fused CHAI decode (the
    engine passes its page size, the paged kernel's tile).

    ``mixed_phase`` (continuous batching, with a ``chai_ctx``): WARMUP and
    STEADY slots share the batch. Both attention paths run for every
    slot, each committing its cache writes only for its own slots
    (``state["phase"]`` STEADY -> CHAI path, else the MHA path), and the
    output is selected per slot."""
    from repro_torch.core import chai_attention as chai_mod
    plan = layer_plan(cfg)
    h = embed_lookup(params["embed"]["tok"], tokens).to(model_dtype(cfg))
    steady = None
    if chai_ctx is not None and mixed_phase:
        from repro_torch.core.cache import PHASE_STEADY
        steady = state["phase"] >= PHASE_STEADY                # (B,)
    for i in range(cfg.n_layers):
        ai, gi = plan["attn"][i], plan["global"][i]
        p = _layer(params["attn"], ai)
        xn = rms_norm(h, p["ln"], cfg.norm_eps)
        if steady is not None:
            y_m = _plain_decode_attention(xn, p, cfg, state, gi, ai,
                                          write_mask=~steady)
            y_c = chai_mod.chai_decode_attention(
                xn, p, cfg, state, gi, ai, chai_ctx, write_mask=steady,
                decode_ts=decode_ts)
            y = torch.where(steady[:, None, None], y_c, y_m)
        elif chai_ctx is not None:
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
