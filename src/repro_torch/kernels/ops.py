"""Dispatch for the port's decode ops.

``chai_decode_attention`` (dense cache) and ``paged_chai_decode_attention``
(block-table page pools) are the paper's decode op: a tensor on the CPU
takes the plain version (``kernels.ref``); any other device goes to the
CUDA kernel, which launches or raises. There is no fallback from a
kernel to its plain version.
"""
from __future__ import annotations

from repro_torch.kernels import chai_attention as ck
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
