"""Step functions the engines drive.

Cohort: whole-cohort prefill, decode, compact. Continuous: the mixed-phase
decode step and the per-slot prefill / cluster / reset transitions, on
the unified (``kv_layout="dense"``) and the paged layout. Plain callables
(the reference wraps the same functions in ``jax.jit`` and donates the
state; here the state tensors are updated in place).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
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


# ---------------------------------------------------------------------------
# Continuous batching (slot-level) steps
# ---------------------------------------------------------------------------

def make_mixed_step(cfg: ModelConfig, *, decode_ts=0):
    """Mixed-phase decode step: each slot takes the MHA path (WARMUP) or
    the CHAI path (STEADY) by ``state["phase"]``; both paths run on the
    whole batch and the output is selected per slot."""
    def mixed_step(params, batch_inputs, state, chai_ctx):
        return tfm.decode_step(params, cfg, batch_inputs["tokens"], state,
                               chai_ctx=chai_ctx, mixed_phase=True,
                               decode_ts=decode_ts)

    return mixed_step


def _slot_forward(params, cfg, max_seq, tokens, true_len):
    """Batch=1 prefill of a right-padded prompt bucket into a fresh dense
    mini state; padding rows beyond ``true_len`` are masked out of the
    logits and the decode ``pos``."""
    mini = tfm.init_decode_state(cfg, 1, max_seq, tokens.device)
    logits, mini = tfm.forward_fullseq(params, cfg, tokens, state=mini,
                                       logits_slice="last",
                                       valid_len=true_len)
    return logits[:, 0], mini


def make_slot_prefill(cfg: ModelConfig, max_seq: int):
    """Prefill ONE request and insert it into batch slot ``slot`` of a
    unified decode state (the slot enters WARMUP)."""
    def slot_prefill(params, tokens, true_len, state, slot):
        logits, mini = _slot_forward(params, cfg, max_seq, tokens, true_len)
        return logits, chai_cache.insert_slot(state, mini, slot)

    return slot_prefill


def make_slot_cluster(cfg: ModelConfig, identify_fn):
    """CLUSTER transition for one slot (unified layout): membership from
    the slot's accumulated warmup scores (through ``identify_fn``, the
    engine's batched identification hook), scattered into the batched
    ctx, and the slot's dense K rows compacted into the clustered
    cache."""
    def cluster_slot(state, ctx, slot):
        slot_ctx = clustering.identify_membership_slot(
            state["chai_scores"][:, slot].clone(), cfg, identify_fn)
        ctx = clustering.update_ctx_slot(ctx, slot_ctx, slot)
        return chai_cache.compact_kv_slot(state, slot_ctx, cfg, slot), ctx

    return cluster_slot


def make_slot_reset(cfg: ModelConfig):
    def reset(state, slot):
        return chai_cache.reset_slot(state, slot)
    return reset


# ---------------------------------------------------------------------------
# Paged KV layout (continuous batching over block-table page pools)
# ---------------------------------------------------------------------------

def make_paged_slot_prefill(cfg: ModelConfig, max_seq: int):
    """Paged ``make_slot_prefill``: the batch=1 forward fills a dense mini
    state, which is then scattered into the slot's freshly allocated
    pages (``kg_pages``/``vg_pages``: (P,) int32, null-padded)."""
    def slot_prefill(params, tokens, true_len, state, slot, kg_pages,
                     vg_pages):
        logits, mini = _slot_forward(params, cfg, max_seq, tokens, true_len)
        return logits, chai_cache.insert_slot_paged(state, mini, slot,
                                                    kg_pages, vg_pages)

    return slot_prefill


def _paged_prefix_kv(state, bt_kg_row, bt_vg_row):
    """``prefix_kv`` of a chunk prefill: the engine's pool and the slot's
    block tables as they are; the paged prefix pass reads only the real
    pages through the tables, with no densifying gather."""
    return {"pool": state["kvp"], "bt_k": bt_kg_row[None],
            "bt_v": bt_vg_row[None]}


def make_paged_chunk_prefill(cfg: ModelConfig, max_seq: int):
    """Chunked prefill: forward ONE page-aligned chunk of a long prompt,
    treating every position the slot has already prefilled (earlier
    chunks) as the cached prefix. ``prefix_len`` is the chunk's start;
    ``kg_scatter``/``vg_scatter`` null every page outside the chunk's
    range, so the mini state touches only the pages this chunk fills;
    ``bt_kg_row``/``bt_vg_row`` are the slot's full page mapping.

    ``phase`` marks the final chunk (``PHASE_WARMUP``: the slot joins the
    decode batch next) or an intermediate one (``PHASE_FREE``: the
    interleaved batched decode treats the slot as empty; its stray write
    at ``pos`` lands in the first page of the next chunk, which that
    chunk's whole-page scatter overwrites, and ``insert_slot_paged``
    re-anchors ``pos`` and zeroes the clustering features every chunk)."""
    def chunk_prefill(params, tokens, true_len, prefix_len, state, slot,
                      kg_scatter, vg_scatter, bt_kg_row, bt_vg_row, phase):
        mini = tfm.init_decode_state(cfg, 1, max_seq, tokens.device)
        logits, mini = tfm.forward_fullseq(
            params, cfg, tokens, state=mini, logits_slice="last",
            valid_len=true_len, prefix_len=prefix_len,
            prefix_kv=_paged_prefix_kv(state, bt_kg_row, bt_vg_row))
        state = chai_cache.insert_slot_paged(
            state, mini, slot, kg_scatter, vg_scatter, bt_kg_row=bt_kg_row,
            bt_vg_row=bt_vg_row)
        state["phase"][slot] = phase
        return logits[:, 0], state

    return chunk_prefill


def make_paged_slot_cluster(cfg: ModelConfig, identify_fn):
    """Paged CLUSTER transition: membership, the ctx scatter, and the
    slot's representative K rows gathered from its dense pages into the
    clustered pages ``kc_pages`` with the dense K table row nulled; the
    engine frees those dense pages right after."""
    def cluster_slot(state, ctx, slot, kc_pages):
        slot_ctx = clustering.identify_membership_slot(
            state["chai_scores"][:, slot].clone(), cfg, identify_fn)
        ctx = clustering.update_ctx_slot(ctx, slot_ctx, slot)
        return chai_cache.compact_kv_slot_paged(state, slot_ctx, cfg, slot,
                                                kc_pages), ctx

    return cluster_slot


def make_paged_slot_reset(cfg: ModelConfig):
    def reset(state, slot):
        return chai_cache.reset_slot_paged(state, slot)
    return reset
