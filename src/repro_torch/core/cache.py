"""CHAI KV-cache layout for the cohort (dense -> clustered) flow.

PREFILL fills dense ``kg``/``vg``; WARMUP accumulates clustering features
in ``chai_scores``; ``compact_kv`` is §3.5's "remove the Key tokens
associated [with pruned heads]": after membership identification the
dense K cache is gathered down to the representative rows (``kg_chai``,
``k_max`` rows instead of H) and the dense K cache is dropped, which frees
its memory once no other reference holds it. Only bf16/fp32 caches are
ported (no int8, no ``share_values``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clustering import chai_widths
from repro_torch.models.transformer import init_decode_state, model_dtype


def _check(cfg: ModelConfig):
    if cfg.kv_cache_dtype:
        raise NotImplementedError("int8 KV cache is not ported yet")
    if cfg.chai.share_values:
        raise NotImplementedError("share_values (CHAI-QKV) is not ported yet")


def init_chai_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zero decode state in the clustered layout (MHA + CHAI archs):
    ``kg_chai`` (nG, B, k_max, S, hd) in place of ``kg``."""
    _check(cfg)
    state = init_decode_state(cfg, batch, max_seq, device)
    if not (cfg.is_mha and cfg.chai.enabled):
        return state
    k_max, _ = chai_widths(cfg)
    ng, b, _, s, hd = state.pop("kg").shape
    state["kg_chai"] = torch.zeros((ng, b, k_max, s, hd),
                                   dtype=state["vg"].dtype, device=device)
    return state


def add_score_buffer(state, cfg: ModelConfig, batch: int):
    """Attach the warmup score buffer (nA, B, H, Wf), Wf = min(feature
    window, S): probabilities of the first Wf positions, summed over the
    WARMUP steps (masked positions add exactly 0)."""
    wf = min(cfg.chai.feature_window, int(state["kg"].shape[3]))
    state = dict(state)
    state["chai_scores"] = torch.zeros(
        (cfg.n_attn_layers, batch, cfg.n_heads, wf), dtype=torch.float32,
        device=state["kg"].device)
    return state


def pop_score_buffer(state):
    state = dict(state)
    scores = state.pop("chai_scores")
    return state, scores


def compact_kv(state, chai_ctx, cfg: ModelConfig):
    """Dense MHA decode state -> clustered layout.

    state["kg"]: (nG, B, H, S, hd); ctx reps: (nA, B, k) or (nA, k).
    Returns a new state dict with ``kg_chai`` (nG, B, k, S, hd) and no
    ``kg``."""
    _check(cfg)
    if not (cfg.is_mha and cfg.chai.enabled):
        return state
    reps = chai_ctx["reps"].long()
    kg = state["kg"]
    ng, b = kg.shape[0], kg.shape[1]
    if reps.ndim == 2:
        reps = reps[:, None, :].expand(ng, b, reps.shape[-1])
    # All-global MHA archs: attention layer i == global layer i.
    li = torch.arange(ng, device=kg.device)[:, None, None]
    bi = torch.arange(b, device=kg.device)[None, :, None]
    new_state = {k: v for k, v in state.items() if k != "kg"}
    new_state["kg_chai"] = kg[li, bi, reps]
    return new_state


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                   chai: bool = False):
    """Analytic steady-state KV-cache size in bytes (paper Fig 11)."""
    _check(cfg)
    if cfg.n_attn_layers == 0:
        return 0
    esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
    k_max, _ = chai_widths(cfg)
    k_rows = (k_max if (chai and cfg.is_mha and cfg.chai.enabled)
              else cfg.n_kv_heads)
    per_layer = int(batch * (k_rows + cfg.n_kv_heads) * seq * cfg.head_dim
                    * esize)
    return per_layer * cfg.n_global_layers
