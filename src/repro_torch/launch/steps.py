"""Step functions the engines and the trainer drive.

Training: ``cross_entropy``, ``make_loss_fn`` (the CE plus the MoE
auxiliary losses at ``LB_COEF`` / ``Z_COEF``) and ``make_train_step``
(autograd over the training forward, then ``optim.adamw.update``).

Cohort: whole-cohort prefill, decode, compact. Continuous: the mixed-phase
decode step and the per-slot prefill / cluster / reset transitions, on
the unified (``kv_layout="dense"``) and the paged layout; on the paged
layout also the prefix cache's suffix prefill, snapshot restore and page
copy, the KV tiers' page fetch and put, the preemption slot swap, and the
relay decode step. Both schedulers: the seeded top-k / top-p sampler.
Plain callables (the reference wraps the same functions in ``jax.jit`` and
donates the state; here the state tensors are updated in place).

Each maker that forwards the model takes ``moe_impl`` with the
reference's default for its kind: "capacity" for the prefills and the
batched decode step (``make_serve_step``), "ragged" for the mixed and
relay steps. Under capacity drops the two give different tokens, so the
engines stay in lockstep with the reference only on the same choice per
step kind. The decode makers pass ``batch_inputs["embeddings"]`` (a
frontend stub's (B, d) rows) on where given, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding.local import is_dtensor

LB_COEF = 0.01
Z_COEF = 1e-3


def cross_entropy(logits, labels):
    """logits (B, T, V) fp32; labels (B, T) int -> mean loss. On a
    DTensor the gold logit is picked by a mask against the vocab ids
    (where the vocab is split, each rank its own columns, then a sum over
    ranks): DTensor's ``gather`` over a split dim leaves a masked partial
    value its redistribution cannot reduce on 3-D logits, and gathering
    the whole vocab first would move every logit."""
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        ids = torch.arange(logits.shape[-1], device=labels.device)
        hit = labels[..., None].long() == ids
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, *, remat=True, moe_impl="capacity"):
    """loss_fn(params, batch) -> (loss, {"ce", "load_balance",
    "router_z"}); ``batch["tokens"]`` (B, T) int or, on a frontend arch,
    ``batch["embeddings"]`` (B, T, d) float, and ``batch["labels"]``."""
    def loss_fn(params, batch):
        inputs = batch.get("tokens", batch.get("embeddings"))
        logits, _, aux = tfm.forward_fullseq(params, cfg, inputs,
                                             remat=remat, moe_impl=moe_impl,
                                             return_aux=True)
        ce = cross_entropy(logits, batch["labels"])
        loss = ce + LB_COEF * aux["load_balance"] + Z_COEF * aux["router_z"]
        return loss, {"ce": ce, **aux}
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, metrics) detached, grads): autograd of ``loss_fn`` at
    ``params`` (nested dicts of tensors, left untouched). A leaf the loss
    does not reach (the token table under float embeddings) gets zeros,
    as ``jax.grad`` gives it; every gradient has its parameter's dtype."""
    leaves = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = adamw.tree_leaves(leaves)
    loss, metrics = loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    grads = adamw.tree_map(lambda _: next(it), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(cfg: ModelConfig, *, remat=True, moe_impl="capacity",
                    lr_kw=None, grad_dtype=None, grad_shardings=None):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    metrics): the loss and its gradients, cast to ``grad_dtype`` (e.g.
    "bfloat16") when given, then one AdamW step at ``cosine_lr(step,
    **lr_kw)`` (the update's default schedule without ``lr_kw``).

    On DTensor parameters (a mesh) the step is the sharded one: the
    gradients take their parameters' placements from autograd, and
    ``grad_shardings`` (a tree of ``sharding.rules.Sharding``, e.g.
    ``zero_shardings``) redistributes them before the update, the
    reference's ZeRO constraint: the gradient sum over the data axes
    becomes a reduce-scatter onto the moments' shards. The new
    parameters and moments are redistributed back to the placements
    they came in with (the reference's jit out_shardings)."""
    loss_fn = make_loss_fn(cfg, remat=remat, moe_impl=moe_impl)
    lr_kw = lr_kw or {}

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        if grad_dtype is not None:
            dt = getattr(torch, str(grad_dtype))
            grads = adamw.tree_map(lambda g: g.to(dt), grads)
        if grad_shardings is not None:
            grads = adamw.tree_map(_redistribute, grads, grad_shardings)
        lr = adamw.cosine_lr(opt_state.step, **lr_kw) if lr_kw else None
        new_p, new_s, om = adamw.update(grads, opt_state, params, lr=lr)
        new_p = adamw.tree_map(_like, new_p, params)
        new_s = adamw.AdamWState(step=new_s.step,
                                 m=adamw.tree_map(_like, new_s.m,
                                                  opt_state.m),
                                 v=adamw.tree_map(_like, new_s.v,
                                                  opt_state.v))
        return new_p, new_s, {"loss": loss, **metrics, **om}

    return train_step


def _redistribute(t, sharding):
    """A DTensor moved to a ``sharding.rules.Sharding``'s placements; a
    plain tensor as it is (no mesh)."""
    from repro_torch.sharding.local import is_dtensor
    if not is_dtensor(t):
        return t
    return t.redistribute(sharding.mesh, sharding.placements)


def _like(new, old):
    """``new`` with ``old``'s placements (DTensors), else as it is."""
    from repro_torch.sharding.local import is_dtensor
    if is_dtensor(new) and is_dtensor(old) and (
            new.placements != old.placements):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def make_serve_prefill(cfg: ModelConfig, batch: int, max_seq: int, *,
                       moe_impl="capacity", state_shardings=None):
    """Whole-cohort prefill into a fresh dense decode state.
    ``batch_inputs["true_lens"]`` ((B,) int), when given, marks each row's
    real prompt length in a right-padded bucket (last-real logits,
    per-example ``pos``). ``batch_inputs["embeddings"]`` ((B, T, d)
    float) stands for the tokens on a frontend arch.
    ``state_shardings`` (a mesh): the fresh state is made as DTensors
    placed by them (the tree of ``decode_state_structs``' shardings)."""
    def serve_prefill(params, batch_inputs):
        tokens = batch_inputs.get("tokens", batch_inputs.get("embeddings"))
        if state_shardings is None:
            state = tfm.init_decode_state(cfg, batch, max_seq,
                                          tokens.device)
        else:
            from repro_torch.sharding.rules import zeros_tree
            structs, _ = tfm.decode_state_structs(cfg, batch, max_seq)
            state = zeros_tree(structs, state_shardings,
                               device=tokens.device)
        logits, state = tfm.forward_fullseq(
            params, cfg, tokens, state=state, logits_slice="last",
            valid_len=batch_inputs.get("true_lens"), moe_impl=moe_impl)
        return logits[:, 0], state

    return serve_prefill


def _decode_inputs(batch_inputs):
    """(tokens, embeddings) of a decode step's inputs: the embeddings
    (B, d) of a frontend stub where given (tokens then None)."""
    emb = batch_inputs.get("embeddings")
    return (None if emb is not None else batch_inputs["tokens"]), emb


def make_serve_step(cfg: ModelConfig, *, chai=False, decode_ts=0,
                    plain=False, moe_impl="capacity"):
    """One decode step; with ``chai`` the attention is clustered.
    ``decode_ts``: S-tile size of the fused CHAI decode kernel (the engine
    passes its page size so every layout rounds the same). ``plain``: the
    engine's degraded decode, every decode attention on its kernel's
    plain version (``models.transformer.decode_step``)."""
    def serve_step(params, batch_inputs, state, chai_ctx=None):
        tokens, emb = _decode_inputs(batch_inputs)
        return tfm.decode_step(params, cfg, tokens, state,
                               chai_ctx=chai_ctx if chai else None,
                               decode_ts=decode_ts, plain=plain,
                               embeddings=emb, moe_impl=moe_impl)

    return serve_step


def _top_ids(x, cap):
    """ids (N, cap) of the ``cap`` largest entries of fp32 ``x`` (N, V) in
    descending order, an exact tie to the lower id (``lax.top_k``'s
    order), the same on every device: the top-k of one int64 key a
    token, its value's order-preserving int32 image over its id."""
    bits = x.contiguous().view(torch.int32)
    ordered = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()
    ids = torch.arange(x.shape[-1], device=x.device)
    key = (ordered << 32) | (x.shape[-1] - 1 - ids)
    return torch.topk(key, cap, dim=-1, sorted=True).indices


def sample_candidates(logits, temperature, top_k, top_p, top_k_cap=256):
    """The candidate set of sampling rows, the reference's order.

    ``logits`` (N, V); ``temperature``, ``top_k`` (0 = widest support) and
    ``top_p`` (N,) tensors on the logits' device. Returns (ids (N, cap)
    int64, masked (N, cap) fp32): the ``min(top_k_cap, V)`` largest scaled
    logits in descending order (ties to the lower id), and their
    log-probabilities normalized against the FULL row, -inf outside the
    top-k / nucleus keep (top-p after top-k, rank 0 always kept)."""
    lg = logits.float()
    cap = min(top_k_cap, lg.shape[-1])
    scaled = lg / temperature.float().clamp_min(1e-6)[:, None]
    ids = _top_ids(scaled, cap)
    logp = (torch.gather(scaled, -1, ids)
            - torch.logsumexp(scaled, dim=-1, keepdim=True))
    probs = torch.exp(logp)
    cum = torch.cumsum(probs, dim=-1)
    ranks = torch.arange(cap, device=lg.device)
    keep = ranks[None, :] < torch.where(top_k > 0, top_k, cap)[:, None]
    keep &= (cum - probs) < top_p.float()[:, None]
    keep[:, 0] = True
    return ids, torch.where(keep, logp, -torch.inf)


def gumbel_noise(seed, count, cap):
    """(N, cap) fp32 Gumbel noise made on the host: row n from a Philox
    generator keyed by ``seed[n] * 2**32 + count[n]`` (injective for a
    uint32 seed; torch's CPU generator keeps only 32 bits of its seed), so
    token ``count`` of a request depends only on (seed, count, logits),
    never on its slot, step or device."""
    u = np.empty((len(seed), cap), np.float64)
    for n, (s, c) in enumerate(zip(seed, count)):
        key = (int(s) << 32) | int(c)
        u[n] = np.random.Generator(np.random.Philox(key=key)).random(cap)
    u = np.maximum(u, np.finfo(np.float64).tiny)
    return torch.from_numpy(-np.log(-np.log(u))).float()


def host_knobs(temperature, top_k, top_p, seed, count, cap, pin=False):
    """The sampling rows and their one host buffer: (rows, (n, cap + 4)
    fp32), each row's ``gumbel_noise``, then its temperature, top_k, top_p
    and its row index; pinned when ``pin``, so the copy to the card is
    queued behind the step without waiting for it."""
    temps = np.asarray(temperature, np.float32)
    rows = np.flatnonzero(temps > 0.0)
    host = torch.empty((len(rows), cap + 4), dtype=torch.float32,
                       pin_memory=pin)
    if len(rows):
        host[:, :cap] = gumbel_noise(np.asarray(seed)[rows],
                                     np.asarray(count)[rows], cap)
        host[:, cap:] = torch.from_numpy(np.stack([
            temps[rows], np.asarray(top_k, np.float32)[rows],
            np.asarray(top_p, np.float32)[rows],
            rows.astype(np.float32)], axis=1))
    return rows, host


def make_sampler(top_k_cap: int = 256):
    """Batched per-slot token sampler shared by both schedulers.

    ``sample(logits, temperature, top_k, top_p, seed, count)``: ``logits``
    (B, V) on the device; the per-row knobs are host sequences (numpy
    arrays): ``temperature`` (0 = greedy), ``top_k``, ``top_p``, ``seed``
    (uint32) and ``count``, the tokens the row's request has sampled so
    far. Returns (B,) int64 token ids on the logits' device.

    Rows with ``temperature == 0`` take ``argmax`` of the raw logits, bit
    for bit the engines' greedy pick. An all-greedy batch is that argmax
    alone; otherwise only the sampling rows run ``sample_candidates`` and
    a categorical draw (argmax of the masked log-probs plus
    ``gumbel_noise``, copied to the device with the rows' knobs in one
    transfer from ``host_knobs``), scattered over the batched argmax. The
    reference draws from ``jax.random``; seeded runs here are
    reproducible within the port, and on any device for the same logits:
    the candidates' order breaks exact ties by id (``_top_ids``), where
    ``torch.topk`` of the values would order them differently on the CPU
    and on CUDA."""
    def sample(logits, temperature, top_k, top_p, seed, count):
        tok = torch.argmax(logits, dim=-1)
        if not np.any(np.asarray(temperature, np.float32) > 0.0):
            return tok
        cap = min(top_k_cap, logits.shape[-1])
        _, host = host_knobs(temperature, top_k, top_p, seed, count, cap,
                             pin=logits.is_cuda)
        buf = host.to(logits.device, non_blocking=True)
        idx = buf[:, cap + 3].long()
        ids, masked = sample_candidates(logits[idx], buf[:, cap],
                                        buf[:, cap + 1].long(),
                                        buf[:, cap + 2], cap)
        pick = torch.argmax(masked + buf[:, :cap], dim=-1, keepdim=True)
        tok[idx] = torch.gather(ids, -1, pick)[:, 0]
        return tok

    return sample


def make_compact_step(cfg: ModelConfig):
    def compact(state, chai_ctx):
        return chai_cache.compact_kv(state, chai_ctx, cfg)
    return compact


# ---------------------------------------------------------------------------
# Continuous batching (slot-level) steps
# ---------------------------------------------------------------------------

def make_mixed_step(cfg: ModelConfig, *, decode_ts=0, plain=False,
                    moe_impl="ragged"):
    """Mixed-phase decode step: each slot takes the MHA path (WARMUP) or
    the CHAI path (STEADY) by ``state["phase"]``; both paths run on the
    whole batch and the output is selected per slot. ``plain``: as for
    ``make_serve_step``."""
    def mixed_step(params, batch_inputs, state, chai_ctx):
        tokens, emb = _decode_inputs(batch_inputs)
        return tfm.decode_step(params, cfg, tokens, state,
                               chai_ctx=chai_ctx, mixed_phase=True,
                               decode_ts=decode_ts, plain=plain,
                               embeddings=emb, moe_impl=moe_impl)

    return mixed_step


def _slot_forward(params, cfg, max_seq, tokens, true_len, moe_impl):
    """Batch=1 prefill of a right-padded prompt bucket into a fresh dense
    mini state; padding rows beyond ``true_len`` are masked out of the
    logits and the decode ``pos``."""
    mini = tfm.init_decode_state(cfg, 1, max_seq, tokens.device)
    logits, mini = tfm.forward_fullseq(params, cfg, tokens, state=mini,
                                       logits_slice="last",
                                       valid_len=true_len, moe_impl=moe_impl)
    return logits[:, 0], mini


def make_slot_prefill(cfg: ModelConfig, max_seq: int, *,
                      moe_impl="capacity"):
    """Prefill ONE request and insert it into batch slot ``slot`` of a
    unified decode state (the slot enters WARMUP)."""
    def slot_prefill(params, tokens, true_len, state, slot):
        logits, mini = _slot_forward(params, cfg, max_seq, tokens, true_len,
                                     moe_impl)
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

def make_paged_slot_prefill(cfg: ModelConfig, max_seq: int, *,
                            moe_impl="capacity"):
    """Paged ``make_slot_prefill``: the batch=1 forward fills a dense mini
    state, which is then scattered into the slot's freshly allocated
    pages (``kg_pages``/``vg_pages``: (P,) int32, null-padded)."""
    def slot_prefill(params, tokens, true_len, state, slot, kg_pages,
                     vg_pages):
        logits, mini = _slot_forward(params, cfg, max_seq, tokens, true_len,
                                     moe_impl)
        return logits, chai_cache.insert_slot_paged(state, mini, slot,
                                                    kg_pages, vg_pages)

    return slot_prefill


def _paged_prefix_kv(state, bt_kg_row, bt_vg_row):
    """``prefix_kv`` of a chunk prefill: the engine's pool (and its int8
    scale pool) and the slot's block tables as they are; the paged prefix
    pass reads only the real pages through the tables, with no densifying
    gather."""
    return {"pool": state["kvp"], "scale": state.get("kvp_scale"),
            "bt_k": bt_kg_row[None], "bt_v": bt_vg_row[None]}


def make_paged_chunk_prefill(cfg: ModelConfig, max_seq: int, *,
                             moe_impl="capacity"):
    """Chunked prefill: forward ONE page-aligned chunk of a long prompt,
    treating every position the slot has already prefilled (earlier
    chunks, or pages the prefix cache aliased) as the cached prefix: the
    suffix prefill with the chunk's start as ``prefix_len``;
    ``kg_scatter``/``vg_scatter`` null every page outside the chunk's
    range, so the mini state touches only the pages this chunk fills;
    ``bt_kg_row``/``bt_vg_row`` are the slot's full page mapping.

    ``phase`` marks the final chunk (``PHASE_WARMUP``: the slot joins the
    decode batch next) or an intermediate one (``PHASE_FREE``: the
    interleaved batched decode treats the slot as empty; its stray write
    at ``pos`` lands in the first page of the next chunk, which that
    chunk's whole-page scatter overwrites, and ``insert_slot_paged``
    re-anchors ``pos`` and zeroes the clustering features every chunk)."""
    suffix_prefill = make_paged_suffix_prefill(cfg, max_seq,
                                               moe_impl=moe_impl)

    def chunk_prefill(params, tokens, true_len, prefix_len, state, slot,
                      kg_scatter, vg_scatter, bt_kg_row, bt_vg_row, phase):
        logits, state = suffix_prefill(params, tokens, true_len, prefix_len,
                                       state, slot, kg_scatter, vg_scatter,
                                       bt_kg_row, bt_vg_row)
        state["phase"][slot] = phase
        return logits, state

    return chunk_prefill


def make_paged_suffix_prefill(cfg: ModelConfig, max_seq: int, *,
                              moe_impl="capacity"):
    """Prefix-cache prefill: forward ONLY the uncached suffix of a prompt
    whose first ``prefix_len`` tokens (whole pages) already live in shared
    pages aliased into the slot's block tables. ``bt_kg_row``/
    ``bt_vg_row`` are the full logical mapping (aliased prefix + fresh
    suffix pages); ``kg_scatter``/``vg_scatter`` the same rows with the
    aliased entries nulled, so the suffix writes only into the slot's own
    pages (copy-on-write). The suffix attends the cached pages and itself
    in two passes merged by online-softmax state, as a chunk does."""
    def suffix_prefill(params, tokens, true_len, prefix_len, state, slot,
                       kg_scatter, vg_scatter, bt_kg_row, bt_vg_row):
        mini = tfm.init_decode_state(cfg, 1, max_seq, tokens.device)
        logits, mini = tfm.forward_fullseq(
            params, cfg, tokens, state=mini, logits_slice="last",
            valid_len=true_len, prefix_len=prefix_len,
            prefix_kv=_paged_prefix_kv(state, bt_kg_row, bt_vg_row),
            moe_impl=moe_impl)
        state = chai_cache.insert_slot_paged(
            state, mini, slot, kg_scatter, vg_scatter, bt_kg_row=bt_kg_row,
            bt_vg_row=bt_vg_row)
        return logits[:, 0], state

    return suffix_prefill


def make_slot_swap(cfg: ModelConfig):
    """Preemption KV swap (out, in): a preempted slot's per-slot state and
    page CONTENTS move out (to the host, by the engine) so its physical
    pages can be reclaimed, and move back verbatim into fresh pages at
    resume. A resume by recompute could not give the same tokens: CHAI
    decode approximates full attention, so a re-prefill writes other K/V
    rows for the generated tokens than the decode wrote (and a new
    identification could change the membership). Swapping the rows
    themselves makes the resume bitwise."""
    def swap_out(state, slot, kg_pages, vg_pages, kc_pages, vc_pages):
        return chai_cache.save_slot_paged(state, slot, kg_pages, vg_pages,
                                          kc_pages, vc_pages)

    def swap_in(state, slot, cols, pools, kg_pages, vg_pages, kc_pages,
                vc_pages, bt_kg_row, bt_vg_row, bt_kc_row, bt_vc_row):
        return chai_cache.load_slot_paged(
            state, slot, cols, pools, kg_pages, vg_pages, kc_pages,
            vc_pages, bt_kg_row, bt_vg_row, bt_kc_row, bt_vc_row)

    return swap_out, swap_in


def make_snapshot_restore(cfg: ModelConfig):
    """CHAI snapshot resume: alias the snapshot's clustered K and dense V
    pages (``share_values``: clustered V pages, ``bt_vc_row``) into the
    slot's block tables and enter STEADY directly."""
    def restore(state, slot, bt_kg_row, bt_vg_row, bt_kc_row, pos,
                bt_vc_row=None):
        return chai_cache.restore_slot_snapshot(state, slot, bt_kg_row,
                                                bt_vg_row, bt_kc_row, pos,
                                                bt_vc_row)

    return restore


def make_page_copy(cfg: ModelConfig, kind: str):
    """Copy-on-write page copy inside one pool (``kind``: dense|chai)."""
    def copy(state, src, dst):
        return chai_cache.copy_pool_page(state, src, dst, kind=kind)

    return copy


def _page_planes(kind: str):
    """(payload key, state key) of the planes of one pool page: the codes
    or values, and under int8 their scales."""
    return ((("data", "kvp"), ("scale", "kvp_scale")) if kind == "dense"
            else (("data", "cp"), ("scale", "cp_scale")))


def make_page_fetch(cfg: ModelConfig, kind: str):
    """Read ONE physical page of a pool (``kind``: dense|chai) across
    every global layer out to host memory: the KV tiers' demotion read.
    ``fetch(state, page, take)`` returns the payload ``{"data": (nG, rows,
    page, hd)[, "scale": (nG, rows, page)]}`` in host buffers from
    ``take(shape, dtype)``. Each plane is gathered from its strided pool
    slice into one contiguous device buffer and copied with ONE
    non-blocking copy; on CUDA the caller records an event after its last
    fetch and synchronizes it before reading the host bytes."""
    planes = _page_planes(kind)

    def fetch(state, page, take):
        out = {}
        for name, key in planes:
            if key not in state:
                continue
            staged = state[key][:, int(page)].contiguous()
            host = take(tuple(staged.shape), staged.dtype)
            host.copy_(staged, non_blocking=True)
            out[name] = host
        return out

    return fetch


def make_page_put(cfg: ModelConfig, kind: str):
    """Write a host payload back into ONE physical page: the tier
    promotion, the exact inverse of ``make_page_fetch``. Each plane goes
    to the device in one (non-blocking, from pinned memory) copy and then
    into the page's strided slice of the pool in one device copy, on the
    current stream, so it is ordered before the next step's reads."""
    planes = _page_planes(kind)

    def put(state, page, payload):
        for name, key in planes:
            if key not in state:
                continue
            pool = state[key]
            dev = payload[name].to(pool.device, non_blocking=True)
            pool[:, int(page)].copy_(dev.to(pool.dtype))
        return state

    return put


def make_relay_step(cfg: ModelConfig, *, decode_ts=0, moe_impl="ragged"):
    """Shared-prefix relay decode step: the mixed-phase step plus a
    ``relay`` dict of group-batched tensors (packed prefix K/V, routing
    maps, membership) the engine builds on the host. Grouped STEADY slots
    run ONE prefix pass per group and layer and a suffix-only fused
    decode, merged by online-softmax state; other slots ride through
    unchanged (their prefix state is the exact merge identity). Always
    mixed-phase: a relay batch may hold WARMUP slots, which never
    group."""
    def relay_step(params, batch_inputs, state, chai_ctx, relay):
        tokens, emb = _decode_inputs(batch_inputs)
        return tfm.decode_step(params, cfg, tokens, state,
                               chai_ctx=chai_ctx, mixed_phase=True,
                               decode_ts=decode_ts, relay=relay,
                               embeddings=emb, moe_impl=moe_impl)

    return relay_step


def make_paged_slot_cluster(cfg: ModelConfig, identify_fn):
    """Paged CLUSTER transition: membership, the ctx scatter, and the
    slot's representative K rows gathered from its dense pages into the
    clustered pages ``kc_pages`` with the dense K table row nulled
    (``share_values``: its V rows into ``vc_pages`` too, the dense V row
    nulled); the engine frees those dense pages right after."""
    def cluster_slot(state, ctx, slot, kc_pages, vc_pages=None):
        slot_ctx = clustering.identify_membership_slot(
            state["chai_scores"][:, slot].clone(), cfg, identify_fn)
        ctx = clustering.update_ctx_slot(ctx, slot_ctx, slot)
        return chai_cache.compact_kv_slot_paged(state, slot_ctx, cfg, slot,
                                                kc_pages, vc_pages), ctx

    return cluster_slot


def make_paged_slot_reset(cfg: ModelConfig):
    def reset(state, slot):
        return chai_cache.reset_slot_paged(state, slot)
    return reset
