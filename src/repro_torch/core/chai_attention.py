"""Clustered Head Attention — the paper's core op (STEADY decode path).

Scores and softmax run only for the representative heads; attention
weights broadcast to member heads through ``h2c``; V stays per head
(paper Table 4). MHA archs read the clustered K cache (k_max rows
instead of H — the paper's KV-memory saving): ``kg_chai`` on the dense
layouts, the clustered page pool ``cp`` on the paged one. The attention
math is ONE fused launch per layer and step
(``repro_torch.kernels.ops.chai_decode_attention``, or
``paged_chai_decode_attention``, which streams the pools through their
block tables: the clustered K through ``bt_kc``, the per-head V through
``bt_vg``).

Relay shared-prefix decode (paged, with the engine's ``relay`` dict):
the STEADY slots of a relay group share the pages of one cached prefix.
Their fused decode covers only their private suffix pages (rolled block
tables, ``pos`` shifted down by the prefix length) and emits its
online-softmax state; ONE group-batched pass per layer
(``kernels.ops.relay_prefix_attention``) covers the shared prefix for
every member; the two states merge and are normalized per slot. A slot
outside any group gets the empty prefix state, the exact merge identity.

int8 KV (``kv_cache_dtype="int8"``): the new rep-K rows and per-head V
rows are written as ``quant_rows`` codes and scales, and the fused kernels
(and the relay pass) read the codes with their scale tensors: the K scale
multiplies the score after the dot, the V scale the V row before A.V.

``share_values`` (CHAI-QKV, the paper's Table 4 ablation; MHA only): V
is clustered like K. Only the reps' V rows are projected and written
(dense ``vg_chai``, or the ``cp`` pool through ``bt_vc``), by a plain
cast into an int8 cache, without scales (the reference's rule), and the
fused kernels run in their share mode: one accumulator row per rep,
broadcast to the member heads after the division. The relay pass then
routes acc row j * R + i to query row j * R + i and V row reps[i], and
reads the prefix V codes without scales.

GQA (``_chai_gqa_decode``): representatives are chosen within each KV
group (``r_max`` per group, ctx ``cluster_of``/``reps``), the K/V caches
stay per group (dense ``kg``/``vg``, or the dense pool ``kvp`` read
through ``bt_kg``/``bt_vg``: GQA has no clustered pool), and the same
fused kernels run with ``reps_per_group = r_max``; the saving is compute
only.

Local layers (gemma2's even layers, every layer of h2o-danube): a GQA
local layer writes the token's K/V rows into its ring (``kl``/``vl``,
slot ``pos % w``) and computes the clustered attention eagerly over the
ring, positions from ``ring_positions`` and the window applied, as the
reference's jnp branch does (no kernel covers a ring); an MHA local
layer takes the plain decode, as in the reference. The attention-logit
softcap (``cfg.attn_logit_softcap``) caps every score: in the fused
kernels' softcap mode on the global layers, in the eager math on the
local ones.

The relay decode passes the cap to both of its passes, as the
reference does; the engine refuses the prefix cache on a local arch
(gemma2, the one softcapped arch), so no served path reaches it yet.

Under int8 a local layer's ring stays in the model dtype (the reference:
"local rings are never quantized"); only the global caches hold codes.

``plain`` (the engine's degraded decode, never with ``relay``): the
fused op's plain version (``kernels.ref``) runs on the state's device in
place of the CUDA kernel.

``qk_norm`` (gemma3, qwen3): q and k are RMS-normed per head over
head_dim wherever a branch projects them, before RoPE, as in the
reference. The norm is per head, so normalizing before the gather of
representative heads (batched membership) equals normalizing after it
(shared membership).

Ported: the MHA and GQA branches, dense and paged, float and int8 caches,
with the mixed-phase ``write_mask``, the relay decode for both,
``share_values`` on MHA, local layers, the softcap and ``qk_norm``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import chai_attention as ck
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.attention import qk_norm
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.sharding.local import batch_local
from repro_torch.models.transformer import (_dense_global_write,
                                            _dense_write_rows,
                                            _local_write,
                                            _paged_global_write,
                                            _paged_write_rows,
                                            _plain_decode_attention,
                                            layer_slice, paged_token_coords)


def _rope1(x, pos, theta):
    """x: (B, n, hd) single-token heads; pos: (B,)."""
    return apply_rope(x[:, None], pos[:, None], theta)[:, 0]


def _gather_heads(x, idx):
    """x: (B, H, hd); idx: (B, k) -> (B, k, hd)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        *idx.shape, x.shape[-1]))


def _fused(*args, plain, ts, **kw):
    """The dense fused decode op, or with ``plain`` its plain version; on
    DTensors through ``sharding.local.batch_local`` (the batch split as
    the cache's, every other axis replicated)."""
    if plain:
        return batch_local(ref.chai_fused_decode_ref, args[1], *args, **kw)
    return batch_local(kops.chai_decode_attention, args[1], *args, ts=ts,
                       **kw)


def _paged_fused(*args, plain, **kw):
    """The paged fused decode op, or with ``plain`` its plain version."""
    if plain:
        return ref.paged_chai_fused_decode_ref(*args, **kw)
    return kops.paged_chai_decode_attention(*args, **kw)


def chai_decode_attention(xn, p, cfg, state, gi, ai, chai_ctx, *, li=None,
                          write_mask=None, decode_ts=0, relay=None,
                          plain=False):
    """xn: (B, d) normed hidden; ``gi``/``ai``: the layer's global-cache
    and attention-layer index, ``li`` its local-ring index (a local
    layer; ``gi`` is then None). Returns (B, H, hd) in xn's dtype; writes
    the token's clustered K rows and per-head V rows into the state
    (only for slots in ``write_mask`` (B,) bool, when given: the
    mixed-phase step runs this path alongside the MHA path). ``relay``:
    the relay decode's group-batched tensors (paged layout; see
    ``_relay_prefix_state``). ``plain``: the fused op's plain version in
    place of its kernel."""
    if not cfg.is_mha:
        return _chai_gqa_decode(xn, p, cfg, state, gi, ai, chai_ctx,
                                write_mask, li=li, decode_ts=decode_ts,
                                relay=relay, plain=plain)
    if li is not None:
        # an MHA arch with a local layer: the plain decode, as in the
        # reference (no served arch has one)
        return _plain_decode_attention(xn, p, cfg, state, gi, ai, li,
                                       write_mask=write_mask)
    return _chai_mha_decode(xn, p, cfg, state, gi, ai, chai_ctx, write_mask,
                            decode_ts=decode_ts, relay=relay, plain=plain)


def _roll_bt(bt, shift):
    """Rotate each slot's block-table row left by ``shift`` (B,) pages, so
    the kernel's logical page 0 is the slot's first private (post-prefix)
    page. With ``pos`` shifted down by the prefix length, the prefix
    entries wrapped to the tail sit at positions past the shifted ``pos``
    and are never read as valid."""
    p = bt.shape[1]
    idx = (torch.arange(p, device=bt.device)[None, :]
           + shift.long()[:, None]) % p
    return torch.gather(bt, 1, idx)


def _relay_prefix_state(relay, gi, ai, q_rep, ts, *, use_v_scale=True,
                        cap=0.0):
    """One group-batched prefix pass for this layer, scattered back to
    batch rows as an unnormalized (m (B, R), l (B, R), acc (B, rows, hd))
    state (rows: the heads; the reps under share_values, whose maps give
    R acc rows a member). ``use_v_scale=False``: the int8 prefix V codes
    are read without scales (share_values, as the reference does).
    ``cap``: the config's attention-logit softcap, as on the suffix pass.

    ``relay`` (built by the engine on the host, tensors on the device):
      k / v              (nG, G, KV, Sp, hd)  packed copies of each
                         group's shared dense pages (zero tail past plen)
      k_scale / v_scale  (nG, G, KV, Sp)      their int8 scales (int8
                         caches only)
      plen               (G,)                 shared prefix length
      members            (G, Nmax)            slot of each member
      k_row/a_row/v_row  (nA, G, NR / A)      routing maps per layer (query
                         row -> K row, acc row -> query row, acc row -> V
                         row): the head -> cluster broadcast lives here
      gid / midx / len   (B,)                 slot -> group, member index,
                         prefix length (0 outside any group)
      in_group           (B,) bool

    A slot outside any group gets the empty state (m = NEG_INF, l = 0,
    acc = 0), the exact merge identity. ``ts``: the prefix pass's S-tile
    (the engine's page, as for the fused decode)."""
    g, nmax = relay["members"].shape
    _, r, hd = q_rep.shape
    qg = q_rep[relay["members"].long()].reshape(g, nmax * r, hd)
    m, l, acc = kops.relay_prefix_attention(
        qg, relay["k"][gi], relay["v"][gi], relay["k_row"][ai],
        relay["a_row"][ai], relay["v_row"][ai], relay["plen"],
        k_scale=layer_slice(relay, "k_scale", gi),
        v_scale=layer_slice(relay, "v_scale", gi) if use_v_scale else None,
        ts=ts, softcap=cap)
    gid, midx = relay["gid"].long(), relay["midx"].long()
    ing = relay["in_group"]
    h = acc.shape[1] // nmax
    m_pb = torch.where(ing[:, None], m.reshape(g, nmax, r)[gid, midx],
                       NEG_INF)
    l_pb = torch.where(ing[:, None], l.reshape(g, nmax, r)[gid, midx], 0.0)
    acc_pb = torch.where(ing[:, None, None],
                         acc.reshape(g, nmax, h, hd)[gid, midx], 0.0)
    return m_pb, l_pb, acc_pb


def _relay_decode(q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos, relay, gi,
                  ai, ts, reps_per_group=1, k_scale_pool=None,
                  v_scale_pool=None, share_values=False, cap=0.0):
    """One layer's relay decode over the paged pools: the suffix-only
    fused pass in the state mode (rolled tables and the shifted ``pos``
    drop the prefix pages from this launch), the group pass over the
    packed prefix (``_relay_prefix_state``), merged and normalized per
    slot; both passes cap their scores at ``cap`` (0: off), as the
    reference's do. Returns (B, H, hd) fp32."""
    shift = relay["len"] // k_pool.shape[2]
    suffix = kops.paged_chai_decode_attention(
        q_rep, k_pool, _roll_bt(bt_k, shift), v_pool, _roll_bt(bt_v, shift),
        h2c, pos - relay["len"], k_scale_pool=k_scale_pool,
        v_scale_pool=v_scale_pool, reps_per_group=reps_per_group,
        share_values=share_values, softcap=cap, emit_state=True)
    prefix = _relay_prefix_state(relay, gi, ai, q_rep, ts,
                                 use_v_scale=not share_values, cap=cap)
    return kops.finalize_decode_state(
        kops.merge_decode_states(suffix, prefix, h2c,
                                 share_values=share_values),
        h2c, share_values=share_values)


def _chai_mha_decode(xn, p, cfg, state, gi, ai, chai_ctx, write_mask=None,
                     *, decode_ts=0, relay=None, plain=False):
    b = xn.shape[0]
    cap = cfg.attn_logit_softcap
    h = cfg.n_heads
    pos = state["pos"]
    reps, h2c = chai_ctx["reps"][ai], chai_ctx["h2c"][ai]
    share = cfg.chai.share_values

    if reps.ndim == 2:
        # Per-request membership: project all heads, gather activations.
        q = torch.einsum("bd,dhe->bhe", xn, p["wq"])
        k = torch.einsum("bd,dhe->bhe", xn, p["wk"])
        q, k = qk_norm(q, k, p, cfg)
        q_rep, k_rep = _gather_heads(q, reps), _gather_heads(k, reps)
    else:
        # Shared membership: gather weight rows (skips pruned projections —
        # the paper's full compute saving).
        ri = reps.long()
        q_rep = torch.einsum("bd,dke->bke", xn, p["wq"][:, ri])
        k_rep = torch.einsum("bd,dke->bke", xn, p["wk"][:, ri])
        q_rep, k_rep = qk_norm(q_rep, k_rep, p, cfg)
    q_rep = _rope1(q_rep, pos, cfg.rope_theta)
    k_rep = _rope1(k_rep, pos, cfg.rope_theta)

    # V: per head, or the reps' rows only under share_values (CHAI-QKV).
    if not share:
        v_new = torch.einsum("bd,dhe->bhe", xn, p["wv"])
    elif reps.ndim == 2:
        v_new = _gather_heads(torch.einsum("bd,dhe->bhe", xn, p["wv"]), reps)
    else:
        v_new = torch.einsum("bd,dke->bke", xn, p["wv"][:, ri])
    gather_idx = h2c if h2c.ndim == 2 else h2c.expand(b, h)
    if "cp" in state:
        # Paged: the pools are read in place by the kernel, no densifying.
        cp = state["cp"][gi]                      # (nP, k, page, hd)
        csc = layer_slice(state, "cp_scale", gi)  # int8: (nP, k, page)
        page = cp.shape[2]
        pk, row = paged_token_coords(state["bt_kc"], pos, page)
        _paged_write_rows(cp, pk, row, k_rep, write_mask, csc)
        if share:       # clustered V pages in the same pool, scale-less
            vp, vsp, bt_v = cp, None, state["bt_vc"]
        else:
            vp = state["kvp"][gi]                 # (nP, H, page, hd)
            vsp = layer_slice(state, "kvp_scale", gi)
            bt_v = state["bt_vg"]
        pv, vrow = paged_token_coords(bt_v, pos, page)
        _paged_write_rows(vp, pv, vrow, v_new, write_mask, vsp)
        if relay is None:
            out = _paged_fused(
                q_rep, cp, state["bt_kc"], vp, bt_v, gather_idx, pos,
                k_scale_pool=csc, v_scale_pool=vsp, share_values=share,
                softcap=cap, plain=plain)
        else:
            out = _relay_decode(q_rep, cp, state["bt_kc"], vp, bt_v,
                                gather_idx, pos, relay, gi, ai, decode_ts,
                                k_scale_pool=csc, v_scale_pool=vsp,
                                share_values=share, cap=cap)
        return out.to(xn.dtype)

    kc = state["kg_chai"][gi]                     # (B, k, S, hd)
    ksc = layer_slice(state, "kg_chai_scale", gi)
    if share:                                     # (B, k, S, hd), scale-less
        vc, vsc = state["vg_chai"][gi], None
    else:
        vc = state["vg"][gi]                      # (B, H, S, hd)
        vsc = layer_slice(state, "vg_scale", gi)
    _dense_write_rows(kc, pos, k_rep, write_mask, ksc)
    _dense_write_rows(vc, pos, v_new, write_mask, vsc)
    out = _fused(
        q_rep, kc, vc, gather_idx, pos, k_scale=ksc, v_scale=vsc,
        share_values=share, ts=ck.fused_tile_size(decode_ts, kc.shape[2]),
        softcap=cap, plain=plain)
    return out.to(xn.dtype)


def _local_gqa_attention(q_rep, kc, vc, kv_pos, pos, cluster_of, cfg):
    """The clustered attention of a GQA local layer over its ring, in
    torch (the reference's jnp branch: no kernel covers a ring). q_rep:
    (B, KV, r, hd); kc/vc: (B, KV, w, hd); kv_pos: (B, w) ring positions;
    cluster_of: (B, KV, qpk). Scores scaled, softcapped, masked outside
    0 <= kv_pos <= pos and pos - kv_pos < window; softmax per rep; head
    (g, i) takes rep cluster_of[b, g, i]'s weights over its group's V.
    Returns (B, H, hd) fp32."""
    b, n_kv, _, hd = q_rep.shape
    sc = torch.einsum("bkre,bkse->bkrs", q_rep.float(),
                      kc.float()) * (1.0 / math.sqrt(hd))
    sc = softcap(sc, cfg.attn_logit_softcap)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    valid &= (pos[:, None] - kv_pos) < cfg.window_size
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    a = torch.softmax(sc, dim=-1)                          # (B, KV, r, w)
    a_full = torch.gather(a, 2, cluster_of.long()[..., None].expand(
        *cluster_of.shape, a.shape[-1]))                   # (B, KV, qpk, w)
    out = torch.einsum("bkgs,bksd->bkgd", a_full, vc.float())
    return out.reshape(b, -1, hd)


def _chai_gqa_decode(xn, p, cfg, state, gi, ai, chai_ctx, write_mask=None,
                     *, li=None, decode_ts=0, relay=None, plain=False):
    """GQA clustered decode with per-request membership: each KV group's
    representative queries (``reps`` (B, KV, r)), flattened to rep rows
    g * r + j, attend the group's own K; head h of group g reads rep row
    g * r + cluster_of[b, g, h % qpk] and its group's V. The token's K/V
    rows are written per group (dense rectangles, or the dense pool's
    pages). One fused launch with ``reps_per_group = r`` (and the
    softcap mode under ``attn_logit_softcap``).

    A local layer (``li``): the rows go to the layer's ring and the
    clustered attention runs eagerly over it (``_local_gqa_attention``).

    ``relay`` (paged): ``_relay_decode`` as for MHA, the group pass
    routed by the engine's GQA maps."""
    b = xn.shape[0]
    hd, h, n_kv, qpk = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.q_per_kv
    pos = state["pos"]
    reps, cluster_of = chai_ctx["reps"][ai], chai_ctx["cluster_of"][ai]
    r = reps.shape[-1]
    q = torch.einsum("bd,dhe->bhe", xn, p["wq"]).reshape(b, n_kv, qpk, hd)
    q, _ = qk_norm(q, None, p, cfg)
    q_rep = torch.gather(q, 2, reps.long()[..., None].expand(b, n_kv, r, hd))
    q_flat = _rope1(q_rep.reshape(b, n_kv * r, hd), pos, cfg.rope_theta)
    h2c_flat = (torch.arange(n_kv, dtype=torch.int32,
                             device=xn.device)[None, :, None] * r
                + cluster_of).reshape(b, h)

    # K/V: the per-group projections, unchanged (no K saving for GQA).
    _, k_new = qk_norm(None, torch.einsum("bd,dke->bke", xn, p["wk"]), p,
                       cfg)
    k_new = _rope1(k_new, pos, cfg.rope_theta)
    v_new = torch.einsum("bd,dke->bke", xn, p["wv"])
    cap = cfg.attn_logit_softcap
    if li is not None:
        # Local: the ring (never quantized, never paged), eager attention.
        kc, vc, kv_pos = _local_write(state, li, k_new, v_new, pos,
                                      write_mask)
        out = _local_gqa_attention(q_flat.reshape(b, n_kv, r, hd), kc, vc,
                                   kv_pos, pos, cluster_of, cfg)
        return out.to(xn.dtype)
    if "kvp" in state:
        # Paged: K and V pages of one dense pool (and, int8, of its scale
        # pool), read in place.
        pool, spool = _paged_global_write(state, gi, k_new, v_new, pos,
                                          write_mask)
        if relay is None:
            out = _paged_fused(
                q_flat, pool, state["bt_kg"], pool, state["bt_vg"],
                h2c_flat, pos, k_scale_pool=spool, v_scale_pool=spool,
                reps_per_group=r, softcap=cap, plain=plain)
        else:
            out = _relay_decode(q_flat, pool, state["bt_kg"], pool,
                                state["bt_vg"], h2c_flat, pos, relay, gi, ai,
                                decode_ts, reps_per_group=r,
                                k_scale_pool=spool, v_scale_pool=spool,
                                cap=cap)
        return out.to(xn.dtype)
    kc, vc, ksc, vsc = _dense_global_write(state, gi, k_new, v_new, pos,
                                           write_mask)   # (B, KV, S, hd)
    out = _fused(
        q_flat, kc, vc, h2c_flat, pos, k_scale=ksc, v_scale=vsc,
        reps_per_group=r, ts=ck.fused_tile_size(decode_ts, kc.shape[2]),
        softcap=cap, plain=plain)
    return out.to(xn.dtype)
