"""Step functions the cohort engine drives: prefill, decode, compact.

Plain callables (the reference wraps the same functions in ``jax.jit``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.models import transformer as tfm


def make_serve_prefill(cfg: ModelConfig, batch: int, max_seq: int):
    """Whole-cohort prefill into a fresh dense decode state.
    ``batch_inputs["true_lens"]`` ((B,) int), when given, marks each row's
    real prompt length in a right-padded bucket (last-real logits,
    per-example ``pos``)."""
    def serve_prefill(params, batch_inputs):
        tokens = batch_inputs["tokens"]
        state = tfm.init_decode_state(cfg, batch, max_seq, tokens.device)
        logits, state = tfm.forward_fullseq(
            params, cfg, tokens, state=state, logits_slice="last",
            valid_len=batch_inputs.get("true_lens"))
        return logits[:, 0], state

    return serve_prefill


def make_serve_step(cfg: ModelConfig, *, chai=False, decode_ts=0):
    """One decode step; with ``chai`` the attention is clustered.
    ``decode_ts``: S-tile size of the fused CHAI decode kernel (the engine
    passes its page size so every layout rounds the same)."""
    def serve_step(params, batch_inputs, state, chai_ctx=None):
        return tfm.decode_step(params, cfg, batch_inputs["tokens"], state,
                               chai_ctx=chai_ctx if chai else None,
                               decode_ts=decode_ts)

    return serve_step


def make_compact_step(cfg: ModelConfig):
    def compact(state, chai_ctx):
        return chai_cache.compact_kv(state, chai_ctx, cfg)
    return compact
