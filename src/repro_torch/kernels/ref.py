"""Plain PyTorch versions of the port's kernels (allclose targets).

``chai_fused_decode_ref`` is the dense CUDA kernel's plain version: the
CPU path of ``kernels.ops.chai_decode_attention`` and the yardstick the
kernel is held against on the card. It mirrors the reference package's
oracle (whole-row softmax, not the kernel's tiled online softmax).
``paged_chai_fused_decode_ref`` is the paged kernel's: it densifies the
pools through their block tables, then runs the dense plain version.

The prefill kernels' plain versions: ``flash_prefill_ref`` (finalized
causal attention, the reference's whole-row softmax oracle) and
``flash_prefill_state_ref`` (its ``emit_state`` form), and
``paged_prefix_attend_ref`` (the chunk's queries over cached pages). The
state forms return the head-major (m, l, acc) triple as the kernels
write it: ``m`` clamped at >= -1e30 on every computed row, and a row that
attends no position (``plen == 0``) left at the exact merge identity
(m = NEG_INF, l = 0, acc = 0).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def _softcap(sc, cap):
    """tanh logit softcap after QK-scale, before the mask (0 = off)."""
    if cap:
        return cap * torch.tanh(sc / cap)
    return sc


def chai_scores_ref(q_rep, k_cache, pos, *, reps_per_group=0, window=0,
                    softcap=0.0):
    """Clustered scores. q_rep: (B, R, hd); k_cache: (B, KV, S, hd); rep j
    reads K row j // reps_per_group. Returns normalized A (B, R, S) fp32."""
    b, r_total, hd = q_rep.shape
    s = k_cache.shape[2]
    r = reps_per_group or 1
    rows = torch.arange(r_total, device=k_cache.device) // r
    kg = k_cache[:, rows]                                    # (B, R, S, hd)
    sc = torch.einsum("bre,brse->brs", q_rep.float(),
                      kg.float()) / math.sqrt(hd)
    sc = _softcap(sc, softcap)
    kv_pos = torch.arange(s, dtype=torch.int32, device=k_cache.device)
    valid = kv_pos[None, :] <= pos[:, None]
    if window:
        valid &= (pos[:, None] - kv_pos[None, :]) < window
    sc = torch.where(valid[:, None, :], sc, NEG_INF)
    return torch.softmax(sc, dim=-1)


def chai_av_ref(a, v_cache, h2c):
    """a: (B, R, S); v_cache: (B, H, S, hd); h2c: (B, H) or (H,).
    Returns (B, H, hd) fp32."""
    b, h = v_cache.shape[0], v_cache.shape[1]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h)
    a_full = torch.gather(a, 1, h2c.long()[..., None].expand(
        b, h, a.shape[-1]))                                  # (B, H, S)
    return torch.einsum("bhs,bhsd->bhd", a_full.float(), v_cache.float())


def chai_fused_decode_ref(q_rep, k_cache, v_cache, h2c, pos, *,
                          k_scale=None, v_scale=None, reps_per_group=0,
                          share_values=False, window=0, softcap=0.0):
    """Plain version of ``chai_fused_decode`` across its dispatch matrix:
    {MHA, GQA} x {float, int8 scale rows} x {share_values} x {window}.

    v_cache rows: H (per-head), a divisor of H (GQA per-group) or R
    (share_values). Returns (B, H, hd) fp32."""
    b = q_rep.shape[0]
    kf = k_cache.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
    a = chai_scores_ref(q_rep, kf, pos, reps_per_group=reps_per_group,
                        window=window, softcap=softcap)      # (B, R, S)
    vf = v_cache.float()
    if v_scale is not None:
        vf = vf * v_scale.float()[..., None]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    h = h2c.shape[1]
    if share_values:
        out_rep = torch.einsum("brs,brsd->brd", a, vf)
        return torch.gather(out_rep, 1, h2c.long()[..., None].expand(
            b, h, out_rep.shape[-1]))
    if vf.shape[1] != h:         # GQA: head h reads V of group h // qpk
        vf = vf.repeat_interleave(h // vf.shape[1], dim=1)
    return chai_av_ref(a, vf, h2c)


def gather_pages_ref(pool, bt):
    """Densify a page pool through block tables. pool: (nP, rows, page,
    hd); bt: (B, P) -> (B, rows, P*page, hd). Null-page entries yield
    garbage rows that the ``pos`` masks of the decode hide (the contract
    the paged kernel relies on). The engine's own gather."""
    from repro_torch.core.cache import gather_pages
    return gather_pages(pool, bt)


def paged_chai_fused_decode_ref(q_rep, k_pool, bt_k, v_pool, bt_v, h2c,
                                pos, *, k_scale_pool=None,
                                v_scale_pool=None, reps_per_group=0,
                                share_values=False, window=0, softcap=0.0):
    """Plain version of ``paged_chai_fused_decode``: densify, then the
    dense plain version. Returns (B, H, hd) fp32."""
    return chai_fused_decode_ref(
        q_rep, gather_pages_ref(k_pool, bt_k), gather_pages_ref(v_pool, bt_v),
        h2c, pos,
        k_scale=(None if k_scale_pool is None
                 else gather_pages_ref(k_scale_pool, bt_k)),
        v_scale=(None if v_scale_pool is None
                 else gather_pages_ref(v_scale_pool, bt_v)),
        reps_per_group=reps_per_group, share_values=share_values,
        window=window, softcap=softcap)


def _causal_scores(q, k, offset):
    """Head-major scaled scores of causal attention, masked to NEG_INF:
    q (B, T, H, hd) at positions offset + t (an int or a one-element
    tensor); k (B, S, KV, hd) at 0..S-1. Returns (sc (B, H, T, S) fp32,
    k's GQA repeat factor)."""
    b, t, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    qpk = h // n_kv
    qh = q.float().transpose(1, 2)                          # (B, H, T, hd)
    kh = k.float().transpose(1, 2).repeat_interleave(qpk, 1)
    sc = torch.einsum("bhtd,bhsd->bhts", qh, kh) / math.sqrt(hd)
    off = torch.as_tensor(offset, device=q.device).reshape(()).long()
    qp = off + torch.arange(t, device=q.device)
    kp = torch.arange(s, device=q.device)
    return torch.where(kp[None, :] <= qp[:, None], sc, NEG_INF), qpk


def flash_prefill_ref(q, k, v, *, offset=0):
    """Causal attention, queries at offset..offset+T-1 over keys 0..S-1.
    q: (B, T, H, hd); k/v: (B, S, KV, hd). Returns (B, T, H, hd) fp32."""
    sc, qpk = _causal_scores(q, k, offset)
    vh = v.float().transpose(1, 2).repeat_interleave(qpk, 1)
    out = torch.einsum("bhts,bhsd->bhtd", torch.softmax(sc, dim=-1), vh)
    return out.transpose(1, 2)


def flash_prefill_state_ref(q, k, v, *, offset=0):
    """``flash_prefill_ref`` unfinalized: the head-major triple
    (m (B, H, T), l (B, H, T), acc (B, H, T, hd)) fp32. Every row is
    computed (key 0 is visible to every query), so m is clamped at
    >= -1e30 everywhere."""
    sc, qpk = _causal_scores(q, k, offset)
    vh = v.float().transpose(1, 2).repeat_interleave(qpk, 1)
    m = torch.clamp(sc.amax(-1), min=-1e30)
    p = torch.exp(sc - m[..., None])
    return m, p.sum(-1), torch.einsum("bhts,bhsd->bhtd", p, vh)


def paged_prefix_attend_ref(q, kv_pool, bt_k, bt_v, plen):
    """Plain version of ``paged_prefix_attend``: densify the pool through
    the block tables, then the non-causal softmax state over positions
    < plen. q: (B, T, H, hd); kv_pool: (nP, KV, page, hd); bt_k/bt_v:
    (B, P); plen: (B,). Returns the head-major (m, l, acc) fp32 triple;
    rows with plen == 0 hold the merge identity (NEG_INF, 0, 0)."""
    h, hd = q.shape[2:]
    kf = gather_pages_ref(kv_pool, bt_k).float()          # (B, KV, S, hd)
    vf = gather_pages_ref(kv_pool, bt_v).float()
    qpk = h // kf.shape[1]
    kf = kf.repeat_interleave(qpk, 1)                     # (B, H, S, hd)
    vf = vf.repeat_interleave(qpk, 1)
    qh = q.float().transpose(1, 2)                        # (B, H, T, hd)
    sc = torch.einsum("bhtd,bhsd->bhts", qh, kf) / math.sqrt(hd)
    idx = torch.arange(kf.shape[2], device=q.device)
    plen = plen.to(device=q.device).long()
    sc = torch.where(idx[None, None, None, :] < plen[:, None, None, None],
                     sc, NEG_INF)
    live = plen[:, None, None] > 0
    m = torch.where(live, torch.clamp(sc.amax(-1), min=-1e30),
                    torch.full_like(sc[..., 0], NEG_INF))  # (B, H, T)
    p = torch.where(live[..., None], torch.exp(sc - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhts,bhsd->bhtd", p, vf)
