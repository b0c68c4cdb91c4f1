"""Plain PyTorch versions of the port's kernels (allclose targets).

``chai_fused_decode_ref`` is the dense CUDA kernel's plain version: the
CPU path of ``kernels.ops.chai_decode_attention`` and the yardstick the
kernel is held against on the card. It mirrors the reference package's
oracle (whole-row softmax, not the kernel's tiled online softmax).
``paged_chai_fused_decode_ref`` is the paged kernel's: it densifies the
pools through their block tables, then runs the dense plain version.
Both take ``emit_state`` (the unnormalized (m, l, acc) triple the relay
decode merges), and ``relay_prefix_decode_ref`` is the relay kernel's:
the group-batched pass over a packed shared prefix.

The reference's two-step oracles, kept for its tests' use:
``chai_scores_i8_ref`` (K dequantized, then the normalized scores),
``chai_decode_ref`` (scores, then A.V) and their paged forms
``paged_chai_scores_ref`` / ``paged_chai_decode_ref``.

The three-kernel pipeline's plain versions, each the Pallas kernel's
function exactly: ``chai_qk_ref`` / ``paged_chai_qk_ref`` (raw scores
dot(q, k) * (1 / sqrt(hd)), exactly NEG_INF where masked),
``chai_qk_i8_ref`` (the scale applied after the dot, in the kernel's
order), ``row_softmax_ref`` (max clamped >= -1e30, sum >= 1e-37),
``chai_av_ref`` / ``paged_chai_av_ref`` (A row h2c[b, h] times V row h,
summed over every position).

The plain flash decode's: ``flash_decode_ref`` (one query token of every
head over a dense cache; head h reads KV row h // (H // KV)) and
``paged_decode_ref`` (the same over a page pool: densify, then
``flash_decode_ref``), masked as the Pallas body masks (scores exactly
NEG_INF outside idx <= pos and pos - idx < window) and normalized as it
does, acc / max(l, 1e-37), in one shot over the row;
``flash_decode_state_ref`` is its unfinalized per-head (m, l, acc) form,
from which the tests build the kernels' split-S algorithm.

The prefill kernels' plain versions: ``flash_prefill_ref`` (finalized
causal attention, the reference's whole-row softmax oracle) and
``flash_prefill_state_ref`` (its ``emit_state`` form), both with the
sliding ``window``, and ``paged_prefix_attend_ref`` (the chunk's queries
over cached pages). The ``softcap`` of every kernel caps the scaled
score, after an int8 K scale and before the mask, as the Pallas kernels
do. A prefill row that sees no key (a window past every key) is the
exact merge identity (m = NEG_INF, l = 0, acc = 0), finalized to zeros,
as the CUDA kernels write it. The
int8 modes (``k_scale``/``v_scale`` of the fused pair and the relay pass,
``k_scale_pool``/``v_scale_pool`` of the prefix pass) dequantize K and V
first, as the reference's oracles do; the kernels scale the score after
the dot and the V row before A.V, as the Pallas kernels do, which differs
in the last bits. The
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


def _chai_masked_scores(q_rep, k_cache, pos, *, reps_per_group=0,
                        window=0, softcap=0.0):
    """Scaled clustered scores, masked to NEG_INF past ``pos`` (and
    outside the window). Returns (B, R, S) fp32."""
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
    return torch.where(valid[:, None, :], sc, NEG_INF)


def chai_scores_ref(q_rep, k_cache, pos, *, reps_per_group=0, window=0,
                    softcap=0.0):
    """Clustered scores. q_rep: (B, R, hd); k_cache: (B, KV, S, hd); rep j
    reads K row j // reps_per_group. Returns normalized A (B, R, S) fp32."""
    return torch.softmax(_chai_masked_scores(
        q_rep, k_cache, pos, reps_per_group=reps_per_group, window=window,
        softcap=softcap), dim=-1)


def chai_av_ref(a, v_cache, h2c):
    """a: (B, R, S); v_cache: (B, H, S, hd); h2c: (B, H) or (H,).
    Returns (B, H, hd) fp32."""
    b, h = v_cache.shape[0], v_cache.shape[1]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h)
    a_full = torch.gather(a, 1, h2c.long()[..., None].expand(
        b, h, a.shape[-1]))                                  # (B, H, S)
    return torch.einsum("bhs,bhsd->bhd", a_full.float(), v_cache.float())


def chai_scores_i8_ref(q_rep, k_cache_i8, k_scale, pos, *,
                       reps_per_group=0):
    """The reference's int8 clustered-scores oracle: K dequantized first
    (codes times their row scales), then ``chai_scores_ref``."""
    return chai_scores_ref(q_rep, _dequant(k_cache_i8, k_scale), pos,
                           reps_per_group=reps_per_group)


def chai_decode_ref(q_rep, k_cache, v_cache, h2c, pos, *,
                    reps_per_group=0):
    """The reference's two-step clustered decode oracle: normalized
    clustered scores, then A row h2c[b, h] times V row h. Returns (B, H,
    hd) fp32."""
    return chai_av_ref(chai_scores_ref(q_rep, k_cache, pos,
                                       reps_per_group=reps_per_group),
                       v_cache, h2c)


def paged_chai_scores_ref(q_rep, k_pool, bt, pos, *, reps_per_group=0):
    """``chai_scores_ref`` over a page pool densified through ``bt``."""
    return chai_scores_ref(q_rep, gather_pages_ref(k_pool, bt), pos,
                           reps_per_group=reps_per_group)


def paged_chai_decode_ref(q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos, *,
                          reps_per_group=0):
    """``chai_decode_ref`` over page pools densified through their block
    tables."""
    return chai_av_ref(paged_chai_scores_ref(
        q_rep, k_pool, bt_k, pos, reps_per_group=reps_per_group),
        gather_pages_ref(v_pool, bt_v), h2c)


def chai_qk_ref(q_rep, k_cache, pos, *, reps_per_group=1, window=0,
                k_scale=None):
    """Plain version of ``chai_qk`` (and, with ``k_scale``, of
    ``chai_qk_i8``). q_rep: (B, R, hd); k_cache: (B, KV, S, hd), rep j
    reading K row j // reps_per_group; pos: (B,). Returns (B, R, S) fp32:
    dot(q, k) [* k_scale[row]] * (1 / sqrt(hd)), NEG_INF where s > pos or
    (window > 0 and pos - s >= window)."""
    hd, s = q_rep.shape[-1], k_cache.shape[2]
    rows = torch.arange(q_rep.shape[1], device=k_cache.device) // max(
        reps_per_group, 1)
    sc = torch.einsum("bre,brse->brs", q_rep.float(),
                      k_cache[:, rows].float())
    if k_scale is not None:
        sc = sc * k_scale[:, rows].float()
    sc = sc * (1.0 / math.sqrt(hd))
    idx = torch.arange(s, device=k_cache.device)
    p = pos.to(k_cache.device).long()[:, None]
    valid = idx[None, :] <= p
    if window:
        valid &= (p - idx[None, :]) < window
    return torch.where(valid[:, None, :], sc, NEG_INF)


def chai_qk_i8_ref(q_rep, k_cache_i8, k_scale, pos, *, reps_per_group=1,
                   window=0):
    """Plain version of ``chai_qk_i8``: the int8 codes' dot, then the row
    scale, then 1 / sqrt(hd) (not the dequantize-first order of
    ``chai_fused_decode_ref``)."""
    return chai_qk_ref(q_rep, k_cache_i8, pos, reps_per_group=reps_per_group,
                       window=window, k_scale=k_scale)


def row_softmax_ref(scores):
    """Plain version of ``row_softmax``: p = exp(x - max(max(x), -1e30))
    over each row of (B, R, S), p / max(sum(p), 1e-37); a row masked
    everywhere gives zeros."""
    x = scores.float()
    m = torch.clamp(x.amax(-1, keepdim=True), min=-1e30)
    p = torch.exp(x - m)
    return p / torch.clamp(p.sum(-1, keepdim=True), min=1e-37)


def paged_chai_qk_ref(q_rep, k_pool, bt, pos, *, reps_per_group=1,
                      window=0):
    """Plain version of ``paged_chai_qk``: densify the pool through the
    block table, then ``chai_qk_ref``. Returns (B, R, P * page)."""
    return chai_qk_ref(q_rep, gather_pages_ref(k_pool, bt), pos,
                       reps_per_group=reps_per_group, window=window)


def paged_chai_av_ref(a, v_pool, bt_v, h2c):
    """Plain version of ``paged_chai_av``: densify the V pool through
    ``bt_v``, then ``chai_av_ref``. a: (B, R, P * page)."""
    return chai_av_ref(a, gather_pages_ref(v_pool, bt_v), h2c)


def chai_fused_decode_ref(q_rep, k_cache, v_cache, h2c, pos, *,
                          k_scale=None, v_scale=None, reps_per_group=0,
                          share_values=False, window=0, softcap=0.0,
                          emit_state=False):
    """Plain version of ``chai_fused_decode`` across its dispatch matrix:
    {MHA, GQA} x {float, int8 scale rows} x {share_values} x {window}.

    v_cache rows: H (per-head), a divisor of H (GQA per-group) or R
    (share_values). Returns (B, H, hd) fp32, or with ``emit_state`` the
    unnormalized triple (m (B, R), l (B, R), acc (B, rows, hd)) fp32 as
    the kernels emit it: m clamped at >= -1e30 on every row, l and acc
    over p = exp(sc - m); acc rows are the heads (R under
    ``share_values``)."""
    b = q_rep.shape[0]
    kf = _dequant(k_cache, k_scale)
    sc = _chai_masked_scores(q_rep, kf, pos, reps_per_group=reps_per_group,
                             window=window, softcap=softcap)  # (B, R, S)
    if emit_state:
        m = torch.clamp(sc.amax(-1), min=-1e30)
        a = torch.exp(sc - m[..., None])
    else:
        a = torch.softmax(sc, dim=-1)
    vf = _dequant(v_cache, v_scale)
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    h = h2c.shape[1]
    if share_values:
        out_rep = torch.einsum("brs,brsd->brd", a, vf)
        if emit_state:
            return m, a.sum(-1), out_rep
        return torch.gather(out_rep, 1, h2c.long()[..., None].expand(
            b, h, out_rep.shape[-1]))
    if vf.shape[1] != h:         # GQA: head h reads V of group h // qpk
        vf = vf.repeat_interleave(h // vf.shape[1], dim=1)
    out = chai_av_ref(a, vf, h2c)
    return (m, a.sum(-1), out) if emit_state else out


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
                                share_values=False, window=0, softcap=0.0,
                                emit_state=False):
    """Plain version of ``paged_chai_fused_decode``: densify, then the
    dense plain version. Returns (B, H, hd) fp32, or the ``emit_state``
    triple."""
    return chai_fused_decode_ref(
        q_rep, gather_pages_ref(k_pool, bt_k), gather_pages_ref(v_pool, bt_v),
        h2c, pos,
        k_scale=(None if k_scale_pool is None
                 else gather_pages_ref(k_scale_pool, bt_k)),
        v_scale=(None if v_scale_pool is None
                 else gather_pages_ref(v_scale_pool, bt_v)),
        reps_per_group=reps_per_group, share_values=share_values,
        window=window, softcap=softcap, emit_state=emit_state)


def _dequant(x, scale):
    """fp32 rows of x (..., hd), times their int8 scales (...) if given
    (the reference oracles' dequantize-first order)."""
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def relay_prefix_decode_ref(q, k, v, k_row, a_row, v_row, plen, *,
                            k_scale=None, v_scale=None, softcap=0.0):
    """Plain version of ``relay_prefix_decode``: row gathers, then the
    masked softmax state in one shot. q: (G, NR, hd); k: (G, KV, Sp, hd);
    v: (G, VR, Sp, hd); k_row: (G, NR) query row -> K row; a_row/v_row:
    (G, A) acc row -> query row / V row; plen: (G,), positions >= plen
    masked (no causal mask). int8 K/V take their scales k_scale (G, KV,
    Sp) and v_scale (G, VR, Sp), dequantized first as the reference's
    oracle does; ``softcap`` caps the scaled scores. Returns (m (G, NR),
    l (G, NR), acc (G, A, hd)) fp32, m clamped at >= -1e30."""
    hd = q.shape[-1]
    sp = k.shape[2]

    def rows(x, idx):               # (G, rows, Sp, hd)[idx] per group
        return torch.gather(x, 1, idx.long()[..., None, None].expand(
            *idx.shape, sp, hd))

    k, v = _dequant(k, k_scale), _dequant(v, v_scale)
    sc = _softcap(torch.einsum("gre,grse->grs", q.float(),
                               rows(k, k_row)) / math.sqrt(hd), softcap)
    idx = torch.arange(sp, device=q.device)
    plen = plen.to(device=q.device).long()
    sc = torch.where(idx[None, None, :] < plen[:, None, None], sc, NEG_INF)
    m = torch.clamp(sc.amax(-1), min=-1e30)                # (G, NR)
    p = torch.exp(sc - m[..., None])                       # (G, NR, Sp)
    p_a = torch.gather(p, 1, a_row.long()[..., None].expand(
        *a_row.shape, sp))                                 # (G, A, Sp)
    return m, p.sum(-1), torch.einsum("gas,gasd->gad", p_a,
                                      rows(v, v_row))


def flash_decode_state_ref(q, k_cache, v_cache, pos, *, window=0):
    """``flash_decode_ref`` unfinalized, per head: the online-softmax
    triple (m (B, H), l (B, H), acc (B, H, hd)) fp32 over the visible
    positions idx <= pos (and pos - idx < window when window > 0), m
    clamped at >= -1e30. A split of the CUDA kernels' plan is this state
    over its own positions (``ops.merge_prefill_states`` combines two).
    Used by the tests; nothing on the card's path calls it."""
    b, h, hd = q.shape
    n_kv, s = k_cache.shape[1], k_cache.shape[2]
    qs = q.reshape(b, n_kv, h // n_kv, hd).float()
    sc = torch.einsum("bkgd,bksd->bkgs", qs,
                      k_cache.float()) * (1.0 / math.sqrt(hd))
    idx = torch.arange(s, device=q.device)
    p_ = pos.to(q.device).long()[:, None]
    valid = idx[None, :] <= p_
    if window:
        valid &= (p_ - idx[None, :]) < window
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m = torch.clamp(sc.amax(-1, keepdim=True), min=-1e30)
    p = torch.exp(sc - m)
    acc = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return (m.reshape(b, h), p.sum(-1).reshape(b, h),
            acc.reshape(b, h, hd))


def flash_decode_ref(q, k_cache, v_cache, pos, *, window=0):
    """Plain version of ``flash_decode``. q: (B, H, hd); k_cache/v_cache:
    (B, KV, S, hd); pos: (B,). Position idx is visible iff idx <= pos
    (and pos - idx < window when window > 0); masked scores are NEG_INF;
    m = max(max(sc), -1e30), p = exp(sc - m), out = (p . V) / max(sum(p),
    1e-37). Returns (B, H, hd) fp32."""
    _, l, acc = flash_decode_state_ref(q, k_cache, v_cache, pos,
                                       window=window)
    return acc / torch.clamp(l, min=1e-37)[..., None]


def paged_decode_ref(q, kv_pool, bt_k, bt_v, pos, *, window=0):
    """Plain version of ``paged_decode``: densify the pool through the
    block tables (null entries read page 0, which ``pos`` masks), then
    ``flash_decode_ref``. kv_pool: (nP, KV, page, hd); bt_k/bt_v: (B, P).
    Returns (B, H, hd) fp32."""
    return flash_decode_ref(q, gather_pages_ref(kv_pool, bt_k),
                            gather_pages_ref(kv_pool, bt_v), pos,
                            window=window)


def _causal_scores(q, k, offset, window=0, softcap=0.0):
    """Head-major scaled (and softcapped) scores of causal attention,
    masked to NEG_INF: q (B, T, H, hd) at positions offset + t (an int or
    a one-element tensor); k (B, S, KV, hd) at 0..S-1, key k visible to
    query p iff k <= p (and p - k < window when window > 0). Returns (sc
    (B, H, T, S) fp32, k's GQA repeat factor, live (T,): the rows that
    see a key)."""
    b, t, h, hd = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    qpk = h // n_kv
    qh = q.float().transpose(1, 2)                          # (B, H, T, hd)
    kh = k.float().transpose(1, 2).repeat_interleave(qpk, 1)
    sc = _softcap(torch.einsum("bhtd,bhsd->bhts", qh, kh) / math.sqrt(hd),
                  softcap)
    off = torch.as_tensor(offset, device=q.device).reshape(()).long()
    qp = off + torch.arange(t, device=q.device)
    kp = torch.arange(s, device=q.device)
    valid = kp[None, :] <= qp[:, None]
    if window:
        valid &= (qp[:, None] - kp[None, :]) < window
    return torch.where(valid, sc, NEG_INF), qpk, valid.any(-1)


def flash_prefill_ref(q, k, v, *, offset=0, window=0, softcap=0.0):
    """Causal attention, queries at offset..offset+T-1 over keys 0..S-1
    (inside the ``window`` when > 0, scores capped at ``softcap`` when
    != 0). q: (B, T, H, hd); k/v: (B, S, KV, hd). Returns (B, T, H, hd)
    fp32; a row that sees no key is zeros."""
    sc, qpk, live = _causal_scores(q, k, offset, window, softcap)
    vh = v.float().transpose(1, 2).repeat_interleave(qpk, 1)
    a = torch.where(live[:, None], torch.softmax(sc, dim=-1), 0.0)
    out = torch.einsum("bhts,bhsd->bhtd", a, vh)
    return out.transpose(1, 2)


def flash_prefill_state_ref(q, k, v, *, offset=0, window=0, softcap=0.0):
    """``flash_prefill_ref`` unfinalized: the head-major triple
    (m (B, H, T), l (B, H, T), acc (B, H, T, hd)) fp32, m clamped at
    >= -1e30 on every row that sees a key; a row that sees none (only
    with a window) is the merge identity (NEG_INF, 0, 0)."""
    sc, qpk, live = _causal_scores(q, k, offset, window, softcap)
    vh = v.float().transpose(1, 2).repeat_interleave(qpk, 1)
    m = torch.where(live, torch.clamp(sc.amax(-1), min=-1e30), NEG_INF)
    p = torch.where(live[:, None], torch.exp(sc - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhts,bhsd->bhtd", p, vh)


def paged_prefix_attend_ref(q, kv_pool, bt_k, bt_v, plen, *,
                            k_scale_pool=None, v_scale_pool=None,
                            softcap=0.0):
    """Plain version of ``paged_prefix_attend``: densify the pool through
    the block tables, then the non-causal softmax state over positions
    < plen. q: (B, T, H, hd); kv_pool: (nP, KV, page, hd); bt_k/bt_v:
    (B, P); plen: (B,). An int8 pool takes its scale pools (nP, KV, page),
    gathered through the same tables and applied first, as the
    reference's oracle does; ``softcap`` caps the scaled scores. Returns
    the head-major (m, l, acc) fp32 triple; rows with plen == 0 hold the
    merge identity (NEG_INF, 0, 0)."""
    h, hd = q.shape[2:]

    def view(bt, spool):                                  # (B, KV, S, hd)
        return _dequant(gather_pages_ref(kv_pool, bt), None if spool is None
                        else gather_pages_ref(spool, bt))

    kf, vf = view(bt_k, k_scale_pool), view(bt_v, v_scale_pool)
    qpk = h // kf.shape[1]
    kf = kf.repeat_interleave(qpk, 1)                     # (B, H, S, hd)
    vf = vf.repeat_interleave(qpk, 1)
    qh = q.float().transpose(1, 2)                        # (B, H, T, hd)
    sc = _softcap(torch.einsum("bhtd,bhsd->bhts", qh, kf) / math.sqrt(hd),
                  softcap)
    idx = torch.arange(kf.shape[2], device=q.device)
    plen = plen.to(device=q.device).long()
    sc = torch.where(idx[None, None, None, :] < plen[:, None, None, None],
                     sc, NEG_INF)
    live = plen[:, None, None] > 0
    m = torch.where(live, torch.clamp(sc.amax(-1), min=-1e30),
                    torch.full_like(sc[..., 0], NEG_INF))  # (B, H, T)
    p = torch.where(live[..., None], torch.exp(sc - m[..., None]), 0.0)
    return m, p.sum(-1), torch.einsum("bhts,bhsd->bhtd", p, vf)
