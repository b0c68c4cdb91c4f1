"""Dispatch for the port's attention ops.

``chai_decode_attention`` (dense cache) and ``paged_chai_decode_attention``
(block-table page pools) are the paper's decode op, finalized or, with
``emit_state``, as the (m, l, acc) state that ``merge_decode_states``
combines with ``relay_prefix_attention``'s group-batched pass over a
shared prefix and ``finalize_decode_state`` normalizes (torch ops);
``flash_decode_attention`` (dense cache) and ``paged_decode_attention``
(one page pool through block tables) are plain MHA/GQA decode attention,
the MHA baseline's (CHAI off); ``flash_prefill_attention`` and
``paged_prefix_attention`` are the two passes of the chunked prefill,
whose states ``merge_prefill_states`` and ``finalize_prefill_state``
combine (torch ops).
``chai_three_kernel_decode`` and ``paged_chai_three_kernel_decode`` drive
the reference's retired three-kernel decode (QK -> row softmax -> AV,
the (B, R, S) scores in device memory between launches), kept as the
fused kernels' baseline; ``decode_flop_estimate``,
``decode_launch_count`` and ``decode_hbm_bytes_estimate`` are the
analytic side of that comparison, ``relay_prefix_hbm_bytes_estimate``
the relay pass's bytes. A tensor on the CPU takes the plain
version (``kernels.ref``); any other device goes to the CUDA kernel,
which launches or raises. There is no fallback from a kernel to its
plain version. Under a cost-counting trace (``launch/roofline``'s
``cost_mode``, the dry-run's), the decode kernels it reaches
(``flash_decode_attention``, ``chai_decode_attention``) answer ``meta``
tensors as a custom op's fake implementation does: empty outputs of the
kernel's shapes, counted as one opaque call (``_opaque_call``).
Outside such a trace a ``meta`` tensor goes to the kernel, which
refuses its device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chai_attention as ck
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ref


def _cost_counter(t):
    """The active cost-counting dispatch mode (one with an
    ``opaque_call`` method: ``launch/roofline.cost_mode``'s) when ``t``
    is a ``meta`` tensor traced under one; else None."""
    if t.device.type != "meta":
        return None
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return next((m for m in _get_current_dispatch_mode_stack()
                 if hasattr(m, "opaque_call")), None)


def _opaque_call(counter, name, plain, flops, *args, **kwargs):
    """A kernel's call on ``meta`` tensors under ``counter`` (a shape
    trace: no data, no launch): its outputs as empty ``meta`` tensors,
    shaped by its plain version run with every dispatch mode off, and
    counted as XLA counts a custom call: each operand read once, each
    output written once, ``flops`` (from the shapes: the cache's whole
    length, since a shape trace reads no positions)."""
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        out = plain(*args, **kwargs)
    counter.opaque_call(name, (args, kwargs), out, flops)
    return out


def flash_decode_attention(q, k_cache, v_cache, pos, *, window=0, ts=0):
    """Decode attention of one query token per head over a dense cache.
    q: (B, H, hd); k_cache/v_cache: (B, KV, S, hd), head h reading KV row
    h // (H // KV); pos: (B,). ``ts``: the kernel's S-tile (0: S; the
    engine passes its page size, so the dense and paged layouts round
    alike). Returns (B, H, hd) fp32."""
    if q.device.type == "cpu":
        return ref.flash_decode_ref(q, k_cache, v_cache, pos, window=window)
    counter = _cost_counter(q)
    if counter is not None:
        b, h, hd = q.shape
        s = k_cache.shape[2]
        s = min(s, window) if window else s
        return _opaque_call(counter, "flash_decode", ref.flash_decode_ref,
                            4.0 * b * h * s * hd, q, k_cache, v_cache, pos,
                            window=window)
    return fk.flash_decode(q, k_cache, v_cache, pos, window=window, ts=ts)


def paged_decode_attention(q, kv_pool, bt_k, bt_v, pos, *, window=0):
    """``flash_decode_attention`` over one layer's page pool (nP, KV, page,
    hd), read in place through the block tables bt_k/bt_v (B, P): no
    densifying gather. Returns (B, H, hd) fp32."""
    if q.device.type == "cpu":
        return ref.paged_decode_ref(q, kv_pool, bt_k, bt_v, pos,
                                    window=window)
    return fk.paged_decode(q, kv_pool, bt_k, bt_v, pos, window=window)


def chai_decode_attention(q_rep, k_cache, v_cache, h2c, pos, *,
                          k_scale=None, v_scale=None, reps_per_group=1,
                          share_values=False, window=0, ts=512, softcap=0.0,
                          emit_state=False):
    """q_rep: (B, R, hd); k_cache: (B, KVk, S, hd) (clustered for MHA:
    KVk == R); v_cache: (B, KVv, S, hd); h2c: (B, H) or (H,); pos: (B,).
    K and V each fp32, bf16 or int8, each with or without its row scales
    k_scale (B, KVk, S) / v_scale (B, KVv, S) (the int8 cache passes
    both; a side without scales is read as values). ``share_values``:
    v_cache is the clustered V (KVv == R). Returns (B, H, hd) fp32, or with
    ``emit_state`` the unnormalized (m (B, R), l (B, R), acc (B, H, hd))
    fp32 triple (acc (B, R, hd) under ``share_values``)."""
    if q_rep.device.type == "cpu":
        return ref.chai_fused_decode_ref(
            q_rep, k_cache, v_cache, h2c, pos, k_scale=k_scale,
            v_scale=v_scale, reps_per_group=reps_per_group,
            share_values=share_values, window=window, softcap=softcap,
            emit_state=emit_state)
    counter = _cost_counter(q_rep)
    if counter is not None:
        b, r, hd = q_rep.shape
        flops = decode_flop_estimate(b, h2c.shape[-1], r, k_cache.shape[2],
                                     hd, share_values=share_values,
                                     window=window)
        return _opaque_call(
            counter, "chai_fused_decode", ref.chai_fused_decode_ref, flops, q_rep,
            k_cache, v_cache, h2c, pos, k_scale=k_scale, v_scale=v_scale,
            reps_per_group=reps_per_group, share_values=share_values,
            window=window, softcap=softcap, emit_state=emit_state)
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
    block tables; h2c: (B, H) or (H,); pos: (B,); each pool fp32, bf16 or
    int8, each with or without its scale pool k_scale_pool (nP, KVk,
    page) / v_scale_pool (nP, KVv, page). ``share_values``: v_pool is the
    clustered pool read through
    bt_v. Returns (B, H, hd) fp32, or the ``emit_state`` triple."""
    if q_rep.device.type == "cpu":
        return ref.paged_chai_fused_decode_ref(
            q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos,
            k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
            reps_per_group=reps_per_group, share_values=share_values,
            window=window, softcap=softcap, emit_state=emit_state)
    return ck.paged_chai_fused_decode(
        q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos,
        k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
        reps_per_group=reps_per_group, share_values=share_values,
        window=window, softcap=softcap, emit_state=emit_state)


def relay_prefix_attention(q, k, v, k_row, a_row, v_row, plen, *,
                           k_scale=None, v_scale=None, ts=0, softcap=0.0):
    """One pass per relay group over its packed shared prefix: the member
    slots' rep queries stacked along one row axis, so the prefix is read
    once per group, not once per slot. q: (G, NR, hd); k: (G, KV, Sp,
    hd); v: (G, VR, Sp, hd), each fp32, bf16 or int8, each with or
    without its scales k_scale (G, KV, Sp) / v_scale (G, VR, Sp) (a side
    without scales is read as values);
    k_row (G, NR), a_row/v_row (G, A) int
    routing maps; plen (G,); ``softcap`` != 0 caps every scaled score.
    Returns the (m (G, NR), l (G, NR), acc (G, A, hd)) fp32 state; ``ts``
    is the kernel's S-tile (0: Sp)."""
    if q.device.type == "cpu":
        return ref.relay_prefix_decode_ref(q, k, v, k_row, a_row, v_row,
                                           plen, k_scale=k_scale,
                                           v_scale=v_scale, softcap=softcap)
    return ck.relay_prefix_decode(q, k, v, k_row, a_row, v_row, plen,
                                  k_scale=k_scale, v_scale=v_scale, ts=ts,
                                  softcap=softcap)


def _gather_rows(x, h2c):
    """x: (B, R) per-rep values -> (B, H) through ``h2c`` ((B, H) or
    (H,))."""
    if h2c.ndim == 1:
        h2c = h2c.expand(x.shape[0], h2c.shape[0])
    return torch.gather(x, 1, h2c.long())


def merge_decode_states(s1, s2, h2c, *, share_values=False):
    """Online-softmax combine of two decode-state triples (m (B, R), l
    (B, R), acc (B, rows, hd)): a slot's suffix pass and its group's
    prefix pass. The acc rows are the heads, and the per-rep rescale
    reaches them through ``h2c``; under ``share_values`` they are the reps
    themselves. An empty side (m = NEG_INF, l = 0, acc = 0) is the exact
    identity: the other side's m is clamped >= -1e30, so its rescale is
    exp(0) == 1 and the empty side's is exp(-2e38 - m) == 0."""
    m1, l1, acc1 = s1
    m2, l2, acc2 = s2
    m = torch.maximum(m1, m2)
    c1 = torch.exp(m1 - m)
    c2 = torch.exp(m2 - m)
    a1, a2 = ((c1, c2) if share_values
              else (_gather_rows(c1, h2c), _gather_rows(c2, h2c)))
    return (m, l1 * c1 + l2 * c2,
            acc1 * a1[..., None] + acc2 * a2[..., None])


def finalize_decode_state(state, h2c, *, share_values=False):
    """Normalize a decode-state triple to (B, H, hd) fp32: acc over the
    member head's rep l, the same IEEE division the kernels' finalized
    mode does, so it is bitwise equal to it. ``share_values``: each rep
    row over its l, then gathered to the member heads (the kernels'
    order)."""
    _, l, acc = state
    if share_values:
        if h2c.ndim == 1:
            h2c = h2c.expand(acc.shape[0], h2c.shape[0])
        return _gather_head_rows(acc / torch.clamp(l, min=1e-37)[..., None],
                                 h2c)
    return acc / torch.clamp(_gather_rows(l, h2c), min=1e-37)[..., None]


def flash_prefill_attention(q, k, v, offset=0, *, window=0, softcap=0.0,
                            emit_state=False):
    """Causal attention of queries at ``offset + t`` over keys 0..S-1
    (inside a sliding ``window`` when > 0; scores capped at ``softcap``
    when != 0). q: (B, T, H, hd); k/v: (B, S, KV, hd). Returns (B, T, H,
    hd) in q's dtype, or with ``emit_state`` the head-major (m, l, acc)
    fp32 triple that ``merge_prefill_states`` combines."""
    kw = dict(offset=offset, window=window, softcap=softcap)
    if q.device.type == "cpu":
        if emit_state:
            return ref.flash_prefill_state_ref(q, k, v, **kw)
        return ref.flash_prefill_ref(q, k, v, **kw).to(q.dtype)
    return fk.flash_prefill(q, k, v, emit_state=emit_state, **kw)


def paged_prefix_attention(q, kv_pool, bt_k, bt_v, plen, *,
                           k_scale_pool=None, v_scale_pool=None,
                           softcap=0.0):
    """Queries (B, T, H, hd) over the cached positions < plen (B,) of one
    layer's page pool (nP, KV, page, hd), read through the block tables
    bt_k/bt_v (B, P), with no causal mask; the pool in q's dtype or int8,
    each side with its scale pool (nP, KV, page) or none; scores capped
    at ``softcap`` when != 0. Returns
    the head-major (m, l, acc) fp32 triple; a row with plen == 0 is the
    merge identity."""
    kw = dict(k_scale_pool=k_scale_pool, v_scale_pool=v_scale_pool,
              softcap=softcap)
    if q.device.type == "cpu":
        return ref.paged_prefix_attend_ref(q, kv_pool, bt_k, bt_v, plen,
                                           **kw)
    return fk.paged_prefix_attend(q, kv_pool, bt_k, bt_v, plen, **kw)


def merge_prefill_states(s1, s2):
    """Online-softmax combine of two head-major prefill-state triples
    (m (B, H, T), l (B, H, T), acc (B, H, T, hd)): the chunk's causal pass
    and its pass over the cached pages. Any per-row triple merges alike:
    the tests combine the flash decode's per-head split states (m (B, H),
    l (B, H), acc (B, H, hd); ``ref.flash_decode_state_ref``) with it. An
    empty side (m = NEG_INF, l = 0, acc = 0; ``plen == 0``) merges as the
    exact identity: the other side's
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


# ---------------------------------------------------------------------------
# The three-kernel pipeline (the fused decode's baseline)
# ---------------------------------------------------------------------------

def _gather_head_rows(x, h2c):
    """x: (B, R, hd) per-rep rows -> (B, H, hd) through h2c (B, H)."""
    return torch.gather(x, 1, h2c.long()[..., None].expand(
        *h2c.shape, x.shape[-1]))


def chai_three_kernel_decode(q_rep, k_cache, v_cache, h2c, pos, *,
                             k_scale=None, v_scale=None, reps_per_group=1,
                             share_values=False, window=0, ts=512):
    """The pre-fusion decode: QK kernel -> row softmax kernel -> AV
    kernel, with the (B, R, S) fp32 scores in device memory between the
    launches (3 launches, ``decode_launch_count(fused=False)``). Same
    arguments and result as ``chai_decode_attention``'s finalized mode:
    (B, H, hd) fp32.

    ``k_scale`` (int8 K): the QK stage is ``chai_qk_i8``. ``v_scale``:
    int8 V is dequantized outside the kernels, as the reference does; int8
    V without scales (the share_values clustered V's raw codes) goes to
    the AV kernel as it is, its codes read as values.
    ``share_values``: AV per rep row (identity h2c), then a gather of the
    member heads. GQA (V rows a divisor of H): the per-group V is
    expanded to per-head rows by a copy before AV."""
    cpu = q_rep.device.type == "cpu"
    kw = dict(reps_per_group=reps_per_group, window=window)
    if k_scale is not None:
        sc = (ref.chai_qk_i8_ref(q_rep, k_cache, k_scale, pos, **kw) if cpu
              else ck.chai_qk_i8(q_rep, k_cache, k_scale, pos, ts=ts, **kw))
    else:
        sc = (ref.chai_qk_ref(q_rep, k_cache, pos, **kw) if cpu
              else ck.chai_qk(q_rep, k_cache, pos, ts=ts, **kw))
    a = ref.row_softmax_ref(sc) if cpu else ck.row_softmax(sc)

    def av(v, idx):
        return (ref.chai_av_ref(a, v, idx) if cpu
                else ck.chai_av(a, v, idx, ts=ts))

    vf = v_cache
    if v_scale is not None:
        vf = v_cache.float() * v_scale.float()[..., None]
    if h2c.ndim == 1:
        h2c = h2c.expand(q_rep.shape[0], h2c.shape[0])
    h = h2c.shape[1]
    if share_values:
        r = a.shape[1]
        return _gather_head_rows(
            av(vf, torch.arange(r, dtype=torch.int32, device=a.device)), h2c)
    if vf.shape[1] != h:
        vf = vf.repeat_interleave(h // vf.shape[1], dim=1)
    return av(vf, h2c)


def paged_chai_three_kernel_decode(q_rep, k_pool, bt_k, v_pool, bt_v, h2c,
                                   pos, *, reps_per_group=1,
                                   share_values=False, window=0):
    """The three-kernel decode over block-table page pools:
    ``paged_chai_qk`` -> ``row_softmax`` -> ``paged_chai_av`` (3
    launches). Returns (B, H, hd) fp32. ``share_values``: AV per rep row,
    then a gather. GQA (V pool rows a divisor of H): the V pool is
    expanded to per-head rows before AV, which COPIES the whole layer's
    pool (the reference does the same)."""
    cpu = q_rep.device.type == "cpu"
    kw = dict(reps_per_group=reps_per_group, window=window)
    sc = (ref.paged_chai_qk_ref(q_rep, k_pool, bt_k, pos, **kw) if cpu
          else ck.paged_chai_qk(q_rep, k_pool, bt_k, pos, **kw))
    a = ref.row_softmax_ref(sc) if cpu else ck.row_softmax(sc)

    def av(v, idx):
        return (ref.paged_chai_av_ref(a, v, bt_v, idx) if cpu
                else ck.paged_chai_av(a, v, bt_v, idx))

    if h2c.ndim == 1:
        h2c = h2c.expand(q_rep.shape[0], h2c.shape[0])
    if share_values:
        r = a.shape[1]
        return _gather_head_rows(
            av(v_pool, torch.arange(r, dtype=torch.int32, device=a.device)),
            h2c)
    h = h2c.shape[1]
    if v_pool.shape[1] != h:
        v_pool = v_pool.repeat_interleave(h // v_pool.shape[1], dim=1)
    return av(v_pool, h2c)


def decode_flop_estimate(b, h, r, s, hd, *, share_values=False, window=0):
    """Analytic decode-attention FLOPs: clustered scores + AV.
    ``share_values``: AV over R rows, not H; ``window``: at most
    ``window`` positions."""
    s_eff = min(s, window) if window else s
    av_rows = r if share_values else h
    return 2.0 * b * r * s_eff * hd + 2.0 * b * av_rows * s_eff * hd


def decode_launch_count(fused=True):
    """Kernel launches per CHAI decode call: the fused path is one; the
    pipeline QK -> row softmax -> AV is three."""
    return 1 if fused else 3


def relay_prefix_hbm_bytes_estimate(k_rows, v_rows, prefix_len, hd, *,
                                    cache_bytes=4, int8_scales=False):
    """Device-memory bytes one relay group's shared-prefix pass must read
    per decode step (the reference's estimator): the packed prefix's
    k_rows + v_rows rows of prefix_len x hd, once, whatever the member
    count; the q/acc traffic (O(members x R x hd)) is left out, as
    ``decode_hbm_bytes_estimate`` leaves out q/out. ``int8_scales``: the
    rows' fp32 scales too. Without relay each slot reads the prefix
    through its own block table: members x this figure."""
    total = (k_rows + v_rows) * prefix_len * hd * cache_bytes
    if int8_scales:
        total += (k_rows + v_rows) * prefix_len * 4
    return float(total)


def decode_hbm_bytes_estimate(b, h, r, s, hd, *, cache_bytes=4,
                              share_values=False, window=0, fused=True):
    """Analytic device-memory bytes of one CHAI decode-attention call (the
    reference's estimator). Both paths stream the K rows of R reps and
    the V rows of H heads (R under ``share_values``) plus the q/out
    vectors; the pipeline also writes the (B, R, S) fp32 scores, reads and
    writes them in the softmax, and reads an A row per head in AV."""
    s_eff = min(s, window) if window else s
    v_rows = r if share_values else h
    total = b * (r + v_rows) * s_eff * hd * cache_bytes + b * (r + h) * hd * 4
    if not fused:
        total += b * r * s_eff * 4 * 3        # scores: write, read, write
        total += b * h * s_eff * 4            # AV reads A row per head
    return float(total)
