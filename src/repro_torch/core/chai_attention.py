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

Ported: the MHA branch, dense and paged, with the mixed-phase
``write_mask``, without int8 or ``share_values``. GQA, local layers and
relay decode raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import chai_attention as ck
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope
from repro_torch.models.transformer import (_masked_rows, _paged_write_rows,
                                            paged_token_coords,
                                            write_positions)


def _rope1(x, pos, theta):
    """x: (B, n, hd) single-token heads; pos: (B,)."""
    return apply_rope(x[:, None], pos[:, None], theta)[:, 0]


def _gather_heads(x, idx):
    """x: (B, H, hd); idx: (B, k) -> (B, k, hd)."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        *idx.shape, x.shape[-1]))


def chai_decode_attention(xn, p, cfg, state, gi, ai, chai_ctx, *,
                          write_mask=None, decode_ts=0):
    """xn: (B, d) normed hidden; ``gi``/``ai``: the layer's global-cache
    and attention-layer index. Returns (B, H, hd) in xn's dtype; writes
    the token's clustered K rows and per-head V rows into the state
    (only for slots in ``write_mask`` (B,) bool, when given: the
    mixed-phase step runs this path alongside the MHA path)."""
    if not cfg.is_mha:
        raise NotImplementedError("CHAI decode for GQA models is not "
                                  "ported yet")
    if cfg.chai.share_values or cfg.kv_cache_dtype:
        raise NotImplementedError("share_values / int8 CHAI decode is not "
                                  "ported yet")
    return _chai_mha_decode(xn, p, cfg, state, gi, ai, chai_ctx, write_mask,
                            decode_ts=decode_ts)


def _chai_mha_decode(xn, p, cfg, state, gi, ai, chai_ctx, write_mask=None,
                     *, decode_ts=0):
    b = xn.shape[0]
    h = cfg.n_heads
    pos = state["pos"]
    reps, h2c = chai_ctx["reps"][ai], chai_ctx["h2c"][ai]

    if reps.ndim == 2:
        # Per-request membership: project all heads, gather activations.
        q = torch.einsum("bd,dhe->bhe", xn, p["wq"])
        k = torch.einsum("bd,dhe->bhe", xn, p["wk"])
        q_rep, k_rep = _gather_heads(q, reps), _gather_heads(k, reps)
    else:
        # Shared membership: gather weight rows (skips pruned projections —
        # the paper's full compute saving).
        ri = reps.long()
        q_rep = torch.einsum("bd,dke->bke", xn, p["wq"][:, ri])
        k_rep = torch.einsum("bd,dke->bke", xn, p["wk"][:, ri])
    q_rep = _rope1(q_rep, pos, cfg.rope_theta)
    k_rep = _rope1(k_rep, pos, cfg.rope_theta)

    v_new = torch.einsum("bd,dhe->bhe", xn, p["wv"])
    gather_idx = h2c if h2c.ndim == 2 else h2c.expand(b, h)
    if "cp" in state:
        # Paged: the pools are read in place by the kernel, no densifying.
        cp = state["cp"][gi]                      # (nP, k, page, hd)
        vp = state["kvp"][gi]                     # (nP, H, page, hd)
        page = cp.shape[2]
        pk, row = paged_token_coords(state["bt_kc"], pos, page)
        _paged_write_rows(cp, pk, row, k_rep, write_mask)
        pv, vrow = paged_token_coords(state["bt_vg"], pos, page)
        _paged_write_rows(vp, pv, vrow, v_new, write_mask)
        out = kops.paged_chai_decode_attention(
            q_rep, cp, state["bt_kc"], vp, state["bt_vg"], gather_idx, pos)
        return out.to(xn.dtype)

    kc = state["kg_chai"][gi]                     # (B, k, S, hd)
    vc = state["vg"][gi]                          # (B, H, S, hd)
    ar = torch.arange(b, device=xn.device)
    pl = write_positions(pos, kc.shape[2])
    kc[ar, :, pl, :] = _masked_rows(write_mask, k_rep.to(kc.dtype),
                                    kc[ar, :, pl, :])
    vc[ar, :, pl, :] = _masked_rows(write_mask, v_new.to(vc.dtype),
                                    vc[ar, :, pl, :])
    out = kops.chai_decode_attention(
        q_rep, kc, vc, gather_idx, pos,
        ts=ck.fused_tile_size(decode_ts, kc.shape[2]))
    return out.to(xn.dtype)
