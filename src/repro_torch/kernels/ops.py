"""Dispatch for the port's attention ops.

``chai_decode_attention`` (dense cache) and ``paged_chai_decode_attention``
(block-table page pools) are the paper's decode op;
``flash_prefill_attention`` and ``paged_prefix_attention`` are the two
passes of the chunked prefill, whose states ``merge_prefill_states`` and
``finalize_prefill_state`` combine (torch ops). A tensor on the CPU takes
the plain version (``kernels.ref``); any other device goes to the CUDA
kernel, which launches or raises. There is no fallback from a kernel to
its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chai_attention as ck
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref


def chai_decode_attention(q_rep, k_cache, v_cache, h2c, pos, *,
                          k_scale=None, v_scale=None, reps_per_group=1,
                          share_values=False, window=0, ts=512, softcap=0.0,
                          emit_state=False):
    """q_rep: (B, R, hd); k_cache: (B, KVk, S, hd) (clustered for MHA:
    KVk == R); v_cache: (B, KVv, S, hd); h2c: (B, H) or (H,); pos: (B,).
    Returns (B, H, hd) fp32."""
    if q_rep.device.type == "cpu":
        if emit_state:
            raise NotImplementedError("emit_state is not ported yet")
        return ref.chai_fused_decode_ref(
            q_rep, k_cache, v_cache, h2c, pos, k_scale=k_scale,
            v_scale=v_scale, reps_per_group=reps_per_group,
            share_values=share_values, window=window, softcap=softcap)
    return ck.chai_fused_decode(
        q_rep, k_cache, v_cache, h2c, pos, k_scale=k_scale, v_scale=v_scale,
        reps_per_group=reps_per_group, share_values=share_values,
        window=window, ts=ts, softcap=softcap, emit_state=emit_state)


def paged_chai_decode_attention(q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos,
                                *, k_scale_pool=None, v_scale_pool=None,
                                reps_per_group=1, share_values=False,
                                window=0, softcap=0.0, emit_state=False):
    """The decode op over the engine's paged layout. q_rep: (B, R, hd);
    k_pool: (nP, KVk, page, hd) clustered pages (MHA: KVk == k_max);
    v_pool: (nP, KVv, page, hd) per-head V pages; bt_k/bt_v: (B, P)
    block tables; h2c: (B, H) or (H,); pos: (B,). Returns (B, H, hd)
    fp32."""
    if q_rep.device.type == "cpu":
        if emit_state:
            raise NotImplementedError("emit_state is not ported yet")
        return ref.paged_chai_fused_decode_ref(
            q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
            reps_per_group=reps_per_group, share_values=share_values,
            window=window, softcap=softcap)
    return ck.paged_chai_fused_decode(
        q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos,
        k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
        reps_per_group=reps_per_group, share_values=share_values,
        window=window, softcap=softcap, emit_state=emit_state)


def flash_prefill_attention(q, k, v, offset=0, *, emit_state=False):
    """Causal attention of queries at ``offset + t`` over keys 0..S-1.
    q: (B, T, H, hd); k/v: (B, S, KV, hd). Returns (B, T, H, hd) in q's
    dtype, or with ``emit_state`` the head-major (m, l, acc) fp32 triple
    that ``merge_prefill_states`` combines."""
    if q.device.type == "cpu":
        if emit_state:
            return ref.flash_prefill_state_ref(q, k, v, offset=offset)
        return ref.flash_prefill_ref(q, k, v, offset=offset).to(q.dtype)
    return fk.flash_prefill(q, k, v, offset=offset, emit_state=emit_state)


def paged_prefix_attention(q, kv_pool, bt_k, bt_v, plen):
    """Queries (B, T, H, hd) over the cached positions < plen (B,) of one
    layer's page pool (nP, KV, page, hd), read through the block tables
    bt_k/bt_v (B, P), with no causal mask. Returns the head-major (m, l,
    acc) fp32 triple; a row with plen == 0 is the merge identity."""
    if q.device.type == "cpu":
        return ref.paged_prefix_attend_ref(q, kv_pool, bt_k, bt_v, plen)
    return fk.paged_prefix_attend(q, kv_pool, bt_k, bt_v, plen)


def merge_prefill_states(s1, s2):
    """Online-softmax combine of two head-major prefill-state triples
    (m (B, H, T), l (B, H, T), acc (B, H, T, hd)): the chunk's causal pass
    and its pass over the cached pages. An empty side (m = NEG_INF, l = 0,
    acc = 0; ``plen == 0``) merges as the exact identity: the other side's
    m is clamped >= -1e30, so its rescale is exp(0) == 1 and the empty
    side's is exp(-2e38 - m) == 0."""
    m1, l1, acc1 = s1
    m2, l2, acc2 = s2
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    return (m, l1 * c1 + l2 * c2,
            acc1 * c1[..., None] + acc2 * c2[..., None])


def finalize_prefill_state(state, dtype=torch.float32):
    """Normalize a head-major prefill-state triple to (B, T, H, hd)."""
    _, l, acc = state
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    return out.transpose(1, 2).to(dtype)
