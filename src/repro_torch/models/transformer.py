"""Decoder stack for every arch: global, local, RG-LRU and RWKV mixers,
dense, MoE and channel-mix FFNs, the frontend adapter.

Parameters keep the reference's layer-stacked layout (``param_table``):
one stack per layer family, with the layer index first on every leaf
(``attn`` over the attention layers, the dense ``ffn`` over the
dense-FFN layers that are not RWKV, ``moe`` over the MoE layers,
``rglru`` over the RG-LRU layers, ``rwkv`` (time mix and channel mix)
over the RWKV layers, ``frontend.adapter``), so weights cross between
the packages leaf by leaf (``repro_torch.weights``). A Python loop over
layers replaces the reference's ``lax.scan``/``lax.switch``, with the
reference's per-family indices (``layer_plan``). The mixers: the global
and the local (sliding-window) attention with ``qk_norm``, the RG-LRU
block (``models.rglru``) and the RWKV-6 time mix (``models.rwkv``); the
FFNs: the dense FFN, the MoE FFN (``models.moe``: ``moe_impl`` "ragged"
or "capacity", the reference's defaults per entry point) and, on an
RWKV layer, the RWKV channel mix; the linear adapter over precomputed
frontend embeddings (``models.frontends``).

Global layers keep a dense cache (``kg``/``vg``, or the engine's paged
pool); local layers keep a ring of the last ``min(window, max_seq)``
positions (``kl``/``vl``, slot ``pos % w``), always in the model dtype and
never paged, as in the reference. The attention-logit softcap (gemma2)
caps every score, global and local; ``final_logit_softcap`` the logits.
Recurrent layers keep their state in the model dtype: ``rg_h`` /
``rg_conv`` (RG-LRU), ``rwkv_wkv`` / ``rwkv_shift`` / ``rwkv_cshift``
(RWKV). A bucketed prefill (``valid_len``) runs its padding through the
recurrence as the reference does, so the recurrent state after it is the
padded sequence's (the reference's caveat, kept for lockstep); decode
advances every slot's recurrent state, FREE slots included.

Two entry points: ``forward_fullseq`` (prefill, and the training
forward with the MoE auxiliary losses and per-layer remat) and
``decode_step`` (one token against the decode state). Unlike the
reference, whose arrays are immutable, the decode state's caches are
updated IN PLACE (the state dict passed in is the state returned), which
saves a cache copy per layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, FFN_DENSE,
                                      FFN_MOE, RGLRU, RWKV, ModelConfig)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import attention as attn_mod
from repro_torch.models import frontends, mlp, moe, rglru, rwkv
from repro_torch.models.layers import embed_lookup, rms_norm, softcap, unembed
from repro_torch.sharding.context import current_ctx, pin_activations
from repro_torch.sharding.local import (batch_local, heads_local, is_dtensor,
                                       on_shards)
from repro_torch.sharding.rules import Ax, Struct

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_supported(cfg: ModelConfig):
    """Check the two settings the reference asserts: the cache dtype, and
    share_values on MHA only."""
    if cfg.kv_cache_dtype not in ("", "int8"):
        raise ValueError(f"kv_cache_dtype {cfg.kv_cache_dtype!r}: the cache "
                         "is the model dtype ('') or 'int8'")
    if cfg.chai.share_values and not cfg.is_mha:
        raise ValueError(f"{cfg.name}: share_values (clustered V, CHAI-QKV) "
                         "is an MHA-only ablation; the reference's kernels "
                         "assert reps_per_group == 1 under it")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_table(cfg: ModelConfig):
    """{group: {name: (shape, Ax(logical...), init_scale)}} — the
    reference's table: ``attn`` over the attention layers (with
    ``q_norm`` / ``k_norm`` (nA, hd) under qk_norm), ``ffn`` over the
    dense-FFN layers that are not RWKV (an RWKV layer's FFN is its channel
    mix), ``moe`` over the MoE layers (router, experts, shared experts),
    ``rglru`` over the RG-LRU layers, ``rwkv`` over the RWKV layers (time
    mix, its norms and the channel mix ``cmu`` / ``c_k`` / ``c_v`` /
    ``c_r``), ``frontend.adapter`` (d, d) on a frontend arch, and the
    embed / unembed / final_norm groups. A group with no layer is absent.
    The logical names (``sharding.rules``) place each leaf on a mesh."""
    check_supported(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    n_a, n_m = cfg.n_attn_layers, cfg.n_moe_ffn
    n_r, n_w = cfg.n_rec_layers, cfg.n_rwkv_layers
    n_d = sum(1 for lt, ft in zip(cfg.layer_types, cfg.ffn_types)
              if ft == FFN_DENSE and lt != RWKV)
    t: Dict[str, Dict[str, tuple]] = {}
    t["embed"] = {"tok": ((cfg.vocab_size, d), Ax("vocab", "embed"), 0.02)}
    if cfg.frontend != "none":
        t["frontend"] = {"adapter": ((d, d), Ax("embed", "embed_tp"),
                                     d ** -0.5)}
    if not cfg.tie_embeddings:
        t["unembed"] = {"w": ((d, cfg.vocab_size), Ax("embed", "vocab"),
                              d ** -0.5)}
    t["final_norm"] = {"scale": ((d,), Ax("embed"), 0.0)}
    if n_a:
        t["attn"] = {
            "ln": ((n_a, d), Ax("layers", "embed"), 0.0),
            "wq": ((n_a, d, h, hd),
                   Ax("layers", "embed", "heads", "head_dim"), d ** -0.5),
            "wk": ((n_a, d, kv, hd),
                   Ax("layers", "embed", "kv_heads", "head_dim"), d ** -0.5),
            "wv": ((n_a, d, kv, hd),
                   Ax("layers", "embed", "kv_heads", "head_dim"), d ** -0.5),
            "wo": ((n_a, h, hd, d),
                   Ax("layers", "heads", "head_dim", "embed"),
                   (h * hd) ** -0.5),
        }
        if cfg.qk_norm:
            t["attn"]["q_norm"] = ((n_a, hd), Ax("layers", "head_dim"), 0.0)
            t["attn"]["k_norm"] = ((n_a, hd), Ax("layers", "head_dim"), 0.0)
    if n_d:
        g = {
            "ln": ((n_d, d), Ax("layers", "embed"), 0.0),
            "w_up": ((n_d, d, cfg.d_ff), Ax("layers", "embed", "mlp"),
                     d ** -0.5),
            "w_down": ((n_d, cfg.d_ff, d), Ax("layers", "mlp", "embed"),
                       cfg.d_ff ** -0.5),
        }
        if cfg.gated_mlp:
            g["w_gate"] = ((n_d, d, cfg.d_ff), Ax("layers", "embed", "mlp"),
                           d ** -0.5)
        t["ffn"] = g
    if n_m:
        fe, e = cfg.moe_d_ff, cfg.n_experts
        ex = Ax("layers", "experts", "embed", "expert_mlp")
        g = {
            "ln": ((n_m, d), Ax("layers", "embed"), 0.0),
            "router": ((n_m, d, e), Ax("layers", "embed", "experts"),
                       d ** -0.5),
            "w_gate": ((n_m, e, d, fe), ex, d ** -0.5),
            "w_up": ((n_m, e, d, fe), ex, d ** -0.5),
            "w_down": ((n_m, e, fe, d),
                       Ax("layers", "experts", "expert_mlp", "embed"),
                       fe ** -0.5),
        }
        if cfg.n_shared_experts:
            sf = cfg.n_shared_experts * fe
            g["shared_gate"] = ((n_m, d, sf), Ax("layers", "embed", "mlp"),
                                d ** -0.5)
            g["shared_up"] = ((n_m, d, sf), Ax("layers", "embed", "mlp"),
                              d ** -0.5)
            g["shared_down"] = ((n_m, sf, d), Ax("layers", "mlp", "embed"),
                                sf ** -0.5)
        t["moe"] = g
    if n_r:
        rw, cw = cfg.rnn_width, cfg.conv_width
        t["rglru"] = {
            "ln": ((n_r, d), Ax("layers", "embed"), 0.0),
            "w_x": ((n_r, d, rw), Ax("layers", "embed", "rnn"), d ** -0.5),
            "w_gate": ((n_r, d, rw), Ax("layers", "embed", "rnn"),
                       d ** -0.5),
            "conv_w": ((n_r, cw, rw), Ax("layers", "conv", "rnn"),
                       cw ** -0.5),
            "conv_b": ((n_r, rw), Ax("layers", "rnn"), 0.0),
            "w_a": ((n_r, rw, rw), Ax("layers", "rnn", "embed_tp"),
                    rw ** -0.5),
            "w_i": ((n_r, rw, rw), Ax("layers", "rnn", "embed_tp"),
                    rw ** -0.5),
            "log_lambda": ((n_r, rw), Ax("layers", "rnn"), 0.5),
            "w_out": ((n_r, rw, d), Ax("layers", "rnn", "embed"),
                      rw ** -0.5),
        }
    if n_w:
        lora = 64
        tp = Ax("layers", "embed", "embed_tp")
        t["rwkv"] = {
            "ln1": ((n_w, d), Ax("layers", "embed"), 0.0),
            "ln2": ((n_w, d), Ax("layers", "embed"), 0.0),
            "mu": ((n_w, 5, d), Ax("layers", None, "embed"), 0.3),
            "w_r": ((n_w, d, d), tp, d ** -0.5),
            "w_k": ((n_w, d, d), tp, d ** -0.5),
            "w_v": ((n_w, d, d), tp, d ** -0.5),
            "w_g": ((n_w, d, d), tp, d ** -0.5),
            "w_decay_a": ((n_w, d, lora), Ax("layers", "embed", "lora"),
                          d ** -0.5),
            "w_decay_b": ((n_w, lora, d), Ax("layers", "lora", "embed"),
                          0.01),
            "decay_base": ((n_w, d), Ax("layers", "embed"), 0.5),
            "u": ((n_w, cfg.n_rwkv_heads, cfg.rwkv_head_dim),
                  Ax("layers", "heads", "head_dim"), 0.5),
            "w_o": ((n_w, d, d), Ax("layers", "embed_tp", "embed"),
                    d ** -0.5),
            "ln_x": ((n_w, d), Ax("layers", "embed"), 0.0),
            "cmu": ((n_w, 2, d), Ax("layers", None, "embed"), 0.3),
            "c_k": ((n_w, d, cfg.d_ff), Ax("layers", "embed", "mlp"),
                    d ** -0.5),
            "c_v": ((n_w, cfg.d_ff, d), Ax("layers", "mlp", "embed"),
                    cfg.d_ff ** -0.5),
            "c_r": ((n_w, d, d), tp, d ** -0.5),
        }
    return t


def init_params(cfg: ModelConfig, generator=None, device=None):
    """Random weights with the reference's shapes and init scales:
    N(0, 1) in fp32 times the leaf's scale, cast to the model dtype
    (zero-scale leaves are zeros). The bits are torch's, not jax's."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    dt = model_dtype(cfg)
    params: Dict[str, Any] = {}
    for g, grp in param_table(cfg).items():
        params[g] = {}
        for n, (shape, _, scale) in grp.items():
            if scale == 0.0:
                params[g][n] = torch.zeros(shape, dtype=dt, device=dev)
            else:
                w = torch.randn(shape, generator=generator,
                                dtype=torch.float32, device=dev)
                params[g][n] = w.mul_(scale).to(dt)
                del w
    return params


def param_structs(cfg: ModelConfig):
    """(tree of ``Struct`` (shape, dtype), tree of ``Ax``) of the
    parameters: no allocation (the dry-run and the sharding rules)."""
    dt = model_dtype(cfg)
    table = param_table(cfg)
    return ({g: {n: Struct(s, dt) for n, (s, _, _) in grp.items()}
             for g, grp in table.items()},
            {g: {n: ax for n, (_, ax, _) in grp.items()}
             for g, grp in table.items()})


def layer_plan(cfg: ModelConfig):
    """Per-layer routing (the reference's ``layer_plan``), one counter a
    family, None for a layer outside it: ``attn`` the layer's index among
    the attention layers, ``global`` / ``local`` among the global / local
    ones, ``rec`` among the RG-LRU layers, ``rwkv`` among the RWKV layers;
    ``dense`` / ``moe`` its index among the dense-FFN / MoE layers. An
    RWKV layer's FFN is its channel mix (``rwkv``), never dense or MoE."""
    check_supported(cfg)
    plan = {"attn": [], "global": [], "local": [], "rec": [], "rwkv": [],
            "dense": [], "moe": []}
    count = dict.fromkeys(plan, 0)
    for i, (lt, ft) in enumerate(zip(cfg.layer_types, cfg.ffn_types)):
        kinds = {"attn": lt in (ATTN_GLOBAL, ATTN_LOCAL),
                 "global": lt == ATTN_GLOBAL, "local": lt == ATTN_LOCAL,
                 "rec": lt == RGLRU, "rwkv": lt == RWKV,
                 "dense": lt != RWKV and ft != FFN_MOE,
                 "moe": lt != RWKV and ft == FFN_MOE}
        for key, on in kinds.items():
            plan[key].append(count[key] if on else None)
            count[key] += on
    return plan


def _layer(group, i):
    return {n: t[i] for n, t in group.items()}


# ---------------------------------------------------------------------------
# Decode state
# ---------------------------------------------------------------------------

def kv_int8(cfg: ModelConfig) -> bool:
    """The KV cache holds int8 codes with one fp32 scale per row."""
    return cfg.kv_cache_dtype == "int8"


def ring_width(cfg: ModelConfig, max_seq: int) -> int:
    """Slots of a local layer's ring cache: min(window, max_seq)."""
    return min(cfg.window_size, max_seq)


def decode_state_shapes(cfg: ModelConfig, batch: int, max_seq: int):
    """{name: (shape, dtype)} of the decode state: ``pos`` (B,) int32; with
    global layers their caches ``kg``/``vg`` (nG, B, KV, S, hd) in the
    model dtype, or, under int8, int8 codes with the rows' fp32 scales
    ``kg_scale``/``vg_scale`` (nG, B, KV, S); with local layers their
    rings ``kl``/``vl`` (nL, B, KV, min(window, S), hd), always in the
    model dtype; with RG-LRU layers ``rg_h`` (nR, B, rnn) and ``rg_conv``
    (nR, B, cw-1, rnn); with RWKV layers ``rwkv_wkv`` (nW, B, H, hd, hd),
    ``rwkv_shift`` and ``rwkv_cshift`` (nW, B, d); the recurrent state in
    the model dtype (the reference's ``decode_state_structs``)."""
    check_supported(cfg)
    shapes = {"pos": ((batch,), torch.int32)}
    if cfg.n_global_layers:
        shape = (cfg.n_global_layers, batch, cfg.n_kv_heads, max_seq,
                 cfg.head_dim)
        dt = torch.int8 if kv_int8(cfg) else model_dtype(cfg)
        shapes["kg"] = (shape, dt)
        shapes["vg"] = (shape, dt)
        if kv_int8(cfg):
            shapes["kg_scale"] = (shape[:-1], torch.float32)
            shapes["vg_scale"] = (shape[:-1], torch.float32)
    if cfg.n_local_layers:
        ring = (cfg.n_local_layers, batch, cfg.n_kv_heads,
                ring_width(cfg, max_seq), cfg.head_dim)
        shapes["kl"] = (ring, model_dtype(cfg))
        shapes["vl"] = (ring, model_dtype(cfg))
    dt = model_dtype(cfg)
    if cfg.n_rec_layers:
        n_r, rw = cfg.n_rec_layers, cfg.rnn_width
        shapes["rg_h"] = ((n_r, batch, rw), dt)
        shapes["rg_conv"] = ((n_r, batch, cfg.conv_width - 1, rw), dt)
    if cfg.n_rwkv_layers:
        n_w, nh, rhd = cfg.n_rwkv_layers, cfg.n_rwkv_heads, cfg.rwkv_head_dim
        shapes["rwkv_wkv"] = ((n_w, batch, nh, rhd, rhd), dt)
        shapes["rwkv_shift"] = ((n_w, batch, cfg.d_model), dt)
        shapes["rwkv_cshift"] = ((n_w, batch, cfg.d_model), dt)
    return shapes


def decode_state_structs(cfg: ModelConfig, batch: int, max_seq: int):
    """(tree of ``Struct``, tree of ``Ax``) of the decode state
    (``decode_state_shapes``) with the reference's logical names."""
    cache = Ax("layers", "batch", "kv_heads", "seq", "head_dim")
    names = {"pos": Ax("batch"), "kg": cache, "vg": cache,
             "kg_scale": Ax("layers", "batch", "kv_heads", "seq"),
             "vg_scale": Ax("layers", "batch", "kv_heads", "seq"),
             "kl": Ax("layers", "batch", "kv_heads", "seq_nosplit",
                      "head_dim"),
             "vl": Ax("layers", "batch", "kv_heads", "seq_nosplit",
                      "head_dim"),
             "rg_h": Ax("layers", "batch", "rnn"),
             "rg_conv": Ax("layers", "batch", None, "rnn"),
             "rwkv_wkv": Ax("layers", "batch", "heads", None, None),
             "rwkv_shift": Ax("layers", "batch", "embed"),
             "rwkv_cshift": Ax("layers", "batch", "embed")}
    shapes = decode_state_shapes(cfg, batch, max_seq)
    return ({k: Struct(s, dt) for k, (s, dt) in shapes.items()},
            {k: names[k] for k in shapes})


def zeros_state(shapes, device):
    """Zero tensors for a ``{name: (shape, dtype)}`` table."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zeros of ``decode_state_shapes``: ``pos``, the global caches
    ``kg``/``vg`` (and int8 scales), the local rings ``kl``/``vl`` and the
    recurrent state."""
    return zeros_state(decode_state_shapes(cfg, batch, max_seq), device)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _unembed_w(params, cfg):
    return (params["embed"]["tok"].T if cfg.tie_embeddings
            else params["unembed"]["w"])


def _prefix_attention(q, k, v, prefix_kv, gi, plen, cap):
    """A chunk's attention over the cached prefix and itself, two passes
    merged by online-softmax state: the non-causal paged pass over the
    positions < plen that earlier chunks wrote (``prefix_kv``'s pool,
    layer ``gi``, read through its block tables) and the causal pass over
    the chunk's own K/V at relative offset 0, both with the attention
    softcap ``cap`` (0: off). plen == 0 (a first chunk) leaves the paged
    state at the exact merge identity."""
    spool = layer_slice(prefix_kv, "scale", gi)
    st_p = kops.paged_prefix_attention(q, prefix_kv["pool"][gi],
                                       prefix_kv["bt_k"], prefix_kv["bt_v"],
                                       plen, k_scale_pool=spool,
                                       v_scale_pool=spool, softcap=cap)
    st_s = kops.flash_prefill_attention(q, k, v, softcap=cap,
                                        emit_state=True)
    return kops.finalize_prefill_state(kops.merge_prefill_states(st_s, st_p),
                                       dtype=q.dtype)


def _prefill_write(state, gi, pos_idx, k, v):
    """Write a prefill's K/V (B, T, KV, hd) at rows ``pos_idx`` of layer
    ``gi``'s dense caches, in place; int8 caches take ``quant_rows`` codes
    and scales (reference ``attn_branch``'s cache write). DTensor caches
    are written shard by shard."""
    for name, x in (("kg", k), ("vg", v)):
        x = x.transpose(1, 2)                       # (B, KV, T, hd)
        cache = state[name][gi]
        if name + "_scale" in state:
            from repro_torch.core.cache import quant_rows
            if is_dtensor(cache) and any(p.is_shard(3)
                                         for p in cache.placements):
                raise NotImplementedError(
                    "an int8 cache split on head_dim: a row's scale needs "
                    "the whole row")
            x, sc = quant_rows(x)
            on_shards(lambda c, i, r: c.index_copy_(2, i, r),
                      state[name + "_scale"][gi], pos_idx, sc,
                      dim_maps=(None, {0: 0, 1: 1}), fixed=(2,))
        on_shards(lambda c, i, r: c.index_copy_(2, i, r), cache, pos_idx,
                  x.to(state[name].dtype),
                  dim_maps=(None, {0: 0, 1: 1, 3: 3}), fixed=(2,))


def _ring_write(state, li, k, v, positions, vl):
    """Write a prefill's K/V (B, T, KV, hd) into layer ``li``'s rings
    (B, KV, w, hd), in place (the reference's local cache write). Without
    ``vl`` (exact-length prefill) the last min(T, w) rows land at slots
    ``positions % w``. With ``vl`` ((B,) real lengths of a right-padded
    bucket, positions 0..T-1) the ring is rebuilt: slot s takes the row of
    the latest REAL position p < vl with p % w == s, and a slot with no
    such p keeps its old row."""
    kc, vc = state["kl"][li], state["vl"][li]
    w, t = kc.shape[2], k.shape[1]
    if vl is None:
        n = min(t, w)
        slots = torch.remainder(positions[-n:].long(), w)
        for cache, x in ((kc, k), (vc, v)):
            cache[:, :, slots] = x[:, -n:].transpose(1, 2).to(cache.dtype)
        return
    s_arr = torch.arange(w, device=k.device)
    p_s = s_arr[None, :] + w * torch.div(vl[:, None] - 1 - s_arr[None, :],
                                         w, rounding_mode="floor")
    keep = (p_s >= 0)[:, None, :, None]                     # (B, 1, w, 1)
    idx = p_s.clamp(0, t - 1)[:, :, None, None]
    for cache, x in ((kc, k), (vc, v)):
        rows = torch.gather(x, 1, idx.expand(-1, -1, *x.shape[2:]))
        cache.copy_(torch.where(keep, rows.transpose(1, 2).to(cache.dtype),
                                cache))


MOE_IMPLS = ("ragged", "capacity", "ep")


def _embed(params, cfg, tokens, embeddings=None):
    """The residual stream's input in the model dtype: the embedding rows
    of ``tokens``, or float ``embeddings`` (precomputed frontend
    outputs, (..., d)) through the adapter."""
    dt = model_dtype(cfg)
    if embeddings is not None:
        return frontends.adapt(embeddings.to(dt)[:, None],
                               params["frontend"])[:, 0]
    if tokens.is_floating_point():
        return frontends.adapt(tokens.to(dt), params["frontend"])
    return embed_lookup(params["embed"]["tok"], tokens).to(dt)


def _ffn(h, params, cfg, plan, i, moe_impl, aux=None):
    """Layer ``i``'s FFN sublayer on h (B, T, d), residual included: the
    dense FFN, or the MoE FFN by ``moe_impl``. Returns (h, aux): ``aux``,
    the running {"load_balance", "router_z"} sums or None, gains a
    capacity MoE layer's auxiliary losses, as in the reference's training
    forward (the ragged form and the dense FFN add none)."""
    mi = plan["moe"][i]
    if mi is None:
        pf = _layer(params["ffn"], plan["dense"][i])
        return h + mlp.dense_ffn(rms_norm(h, pf["ln"], cfg.norm_eps), pf,
                                 cfg), aux
    pm = _layer(params["moe"], mi)
    xn = rms_norm(h, pm["ln"], cfg.norm_eps)
    if moe_impl == "ragged":
        return h + moe.moe_ffn_ragged(xn, pm, cfg), aux
    ctx = current_ctx() if moe_impl == "ep" else None
    if ctx is not None:     # expert parallel; without a mesh, capacity
        y, a = moe.moe_ffn_ep(xn, pm, cfg, ctx, return_aux=True)
    elif aux is None:
        return h + moe.moe_ffn(xn, pm, cfg), None
    else:
        y, a = moe.moe_ffn(xn, pm, cfg, return_aux=True)
    if aux is None:
        return h + y, None
    return h + y, {k: aux[k] + a[k] for k in aux}


def _recurrent_mixer(h, params, cfg, plan, i, state, step=False):
    """Layer ``i``'s RG-LRU or RWKV time-mix mixer on h, residual
    included: the full sequence (B, T, d), or with ``step`` one decode
    token (B, d). With a ``state`` the layer starts from its recurrent
    state and writes the new one back in place, in the state's dtype;
    without one (a forward with no decode state) it starts from zeros."""
    ri = plan["rec"][i]
    if ri is not None:
        p = _layer(params["rglru"], ri)
        xn = rms_norm(h, p["ln"], cfg.norm_eps)
        if step:
            y, (h1, tail) = rglru.rglru_decode(
                xn, p, cfg, state["rg_h"][ri], state["rg_conv"][ri])
        elif state is None:
            return h + rglru.rglru_fullseq(xn, p, cfg)[0]
        else:
            y, (h1, tail) = rglru.rglru_fullseq(
                xn, p, cfg, h0=state["rg_h"][ri],
                conv_tail=state["rg_conv"][ri])
        state["rg_h"][ri] = h1
        state["rg_conv"][ri] = tail
        return h + y
    wi = plan["rwkv"][i]
    p = _layer(params["rwkv"], wi)
    xn = rms_norm(h, p["ln1"], cfg.norm_eps)
    if state is None:
        b, hd = h.shape[0], cfg.rwkv_head_dim
        st = {"shift": h.new_zeros((b, cfg.d_model)),
              "wkv": h.new_zeros((b, cfg.n_rwkv_heads, hd, hd))}
    else:
        st = {"shift": state["rwkv_shift"][wi], "wkv": state["rwkv_wkv"][wi]}
    mix = rwkv.rwkv_time_mix_decode if step else rwkv.rwkv_time_mix_fullseq
    y, st1 = mix(xn, p, cfg, st)
    if state is not None:
        state["rwkv_shift"][wi] = st1["shift"]
        state["rwkv_wkv"][wi] = st1["wkv"]
    return h + y


def _channel_mix(h, params, cfg, wi, state, step=False):
    """RWKV layer ``wi``'s channel mix (its FFN) on h, residual included,
    over the full sequence or, with ``step``, one token; with a ``state``
    from and into its ``rwkv_cshift`` row."""
    p = _layer(params["rwkv"], wi)
    xn = rms_norm(h, p["ln2"], cfg.norm_eps)
    last = (h.new_zeros((h.shape[0], cfg.d_model)) if state is None
            else state["rwkv_cshift"][wi])
    mix = (rwkv.rwkv_channel_mix_decode if step
           else rwkv.rwkv_channel_mix_fullseq)
    y, last1 = mix(xn, p, last)
    if state is not None:
        state["rwkv_cshift"][wi] = last1
    return h + y


def _check_moe_impl(moe_impl):
    if moe_impl not in MOE_IMPLS:
        raise ValueError(f"moe_impl {moe_impl!r}: one of {MOE_IMPLS}")


def _attention_fullseq(h, params, cfg, plan, i, state, positions, pos_idx,
                       vl, plen, prefix_kv):
    """Attention layer ``i`` over h (B, T, d), residual included, writing
    its K/V into the state's cache (global) or ring (local)."""
    p = _layer(params["attn"], plan["attn"][i])
    gi, li = plan["global"][i], plan["local"][i]
    xn = rms_norm(h, p["ln"], cfg.norm_eps)
    q, k, v = attn_mod.project_qkv(xn, p, cfg, positions)
    if prefix_kv is not None and li is None:
        y = _prefix_attention(q, k, v, prefix_kv, gi, plen,
                              cfg.attn_logit_softcap)
    else:
        y = heads_local(attn_mod.attention_fullseq, q, k, v, positions,
                        positions,
                        window=cfg.window_size if li is not None else 0,
                        attn_softcap=cfg.attn_logit_softcap)
    if state is not None and li is not None:
        _ring_write(state, li, k, v, positions, vl)
    elif state is not None:
        _prefill_write(state, gi, pos_idx, k, v)
    return h + attn_mod.output_proj(y, p)


def forward_fullseq(params, cfg: ModelConfig, tokens, *, state=None,
                    positions=None, logits_slice=None, valid_len=None,
                    prefix_len=None, prefix_kv=None, moe_impl=None,
                    remat=False, return_aux=False):
    """tokens: (B, T) int, or float embeddings (B, T, d) of a frontend
    stub, which enter through the adapter. ``state``: decode state to
    fill (prefill) or None. ``moe_impl`` (MoE layers): "ragged" or
    "capacity"; None takes the reference's default, "ragged" with a
    ``state`` and "capacity" without.

    Returns (logits, state). ``logits_slice="last"`` computes only the last
    position's logits; with ``valid_len`` ((B,) or scalar: bucketed
    prefill, tokens at index >= valid_len are right-padding) that is the
    last REAL token's, and ``pos`` starts at ``valid_len``. Padding rows
    are written to the global caches too: decode masks them by ``pos`` and
    overwrites them as the sequence advances. A local layer attends a
    window of ``cfg.window_size`` positions and writes its ring
    (``_ring_write``: the last real positions, never the padded tail).
    RG-LRU and RWKV layers run over the whole bucket, padding included,
    and their state after the call is the padded sequence's, as in the
    reference (which masks nothing there either).

    Under int8 the cache write stores ``quant_rows`` codes and scales.

    ``prefix_len`` (int or (B,)) and ``prefix_kv`` ({"pool": (nG, nP, KV,
    page, hd) paged KV pool, "scale": its (nG, nP, KV, page) int8 scale
    pool or absent, "bt_k"/"bt_v": (B, P) block tables} holding
    positions [0, prefix_len)): the chunked prefill. This call's tokens
    sit at absolute positions ``prefix_len + arange(T)``, attend over the
    cached pages and themselves (``_prefix_attention``), write the cache
    at those positions, and ``pos`` starts at ``prefix_len + valid_len``.

    The training forward (no ``state``): ``return_aux`` returns (logits,
    None, aux) with aux the MoE auxiliary losses {"load_balance",
    "router_z"} summed over the capacity MoE layers (fp32 zeros without
    one), and ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of
    its layer body): gradients equal, activation memory one layer's.
    """
    if remat and state is not None:
        raise ValueError("remat is for the training forward (state=None)")
    plan = layer_plan(cfg)
    if moe_impl is None:
        moe_impl = "capacity" if state is None else "ragged"
    _check_moe_impl(moe_impl)
    h = _embed(params, cfg, tokens)
    b, t = h.shape[0], h.shape[1]
    plen = None
    if prefix_len is not None:
        plen = torch.as_tensor(prefix_len, dtype=torch.int32,
                               device=h.device).expand(b)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=h.device)
        if plen is not None:
            positions = positions + plen[0]
    pos_idx = positions.long()
    vl = None
    if valid_len is not None:
        vl = torch.as_tensor(valid_len, dtype=torch.int64, device=h.device)
        vl = vl.expand(b) if vl.ndim == 0 else vl

    aux = None
    if return_aux:
        aux = {k: torch.zeros((), dtype=torch.float32, device=h.device)
               for k in ("load_balance", "router_z")}

    def layer(i, h, aux):
        if plan["attn"][i] is None:
            h = _recurrent_mixer(h, params, cfg, plan, i, state)
        else:
            h = _attention_fullseq(h, params, cfg, plan, i, state,
                                   positions, pos_idx, vl, plen, prefix_kv)
        if plan["rwkv"][i] is not None:
            h = _channel_mix(h, params, cfg, plan["rwkv"][i], state)
        else:
            h, aux = _ffn(h, params, cfg, plan, i, moe_impl, aux)
        # the carry pinned to batch-sharded (identity without a context)
        return pin_activations(h), aux

    for i in range(cfg.n_layers):
        h, aux = (torch.utils.checkpoint.checkpoint(layer, i, h, aux,
                                                    use_reentrant=False)
                  if remat else layer(i, h, aux))

    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    if logits_slice == "last":
        if vl is None:
            h = h[:, -1:]
        else:   # bucketed prefill: each row's last REAL token
            h = h[torch.arange(b, device=h.device), vl - 1][:, None]
    logits = unembed(h, _unembed_w(params, cfg), cfg.final_logit_softcap)
    if state is not None:
        fill = (torch.full((b,), t, device=h.device) if vl is None else vl)
        if plen is not None:
            fill = fill + plen
        state["pos"] = fill.to(torch.int32)
    if return_aux:
        return logits, state, aux
    return logits, state


# ---------------------------------------------------------------------------
# Decode step (one token). CHAI hooks: repro_torch/core/chai_attention.py
# ---------------------------------------------------------------------------

def _decode_attention_batched(q, kc, vc, kv_pos, pos, window, cap):
    """Per-example-position decode attention. q: (B,H,hd); kc/vc:
    (B,KV,S,hd); kv_pos: (B,S); pos: (B,). Returns (out in q's dtype,
    probs (B,KV,qpk,S) fp32)."""
    b, h, hd = q.shape
    n_kv = kc.shape[1]
    qs = q.reshape(b, n_kv, h // n_kv, hd).float()
    scale = 1.0 / math.sqrt(hd)
    sc = torch.einsum("bkgd,bksd->bkgs", qs, kc.float()) * scale
    sc = softcap(sc, cap)
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    if window:
        valid &= (pos[:, None] - kv_pos) < window
    sc = torch.where(valid[:, None, None, :], sc, attn_mod.NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgs,bksd->bkgd", p, vc.float())
    return out.reshape(b, h, hd).to(q.dtype), p


def _masked_rows(write_mask, new, old):
    """Commit ``new`` only for slots in ``write_mask`` (mixed-phase step);
    identity when no mask. new/old: (B, ...)."""
    if write_mask is None:
        return new
    m = write_mask.reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def write_positions(pos, s):
    """Cache row each slot writes this step. A FREE slot's ``pos`` keeps
    advancing with every batched step until the slot is refilled; the
    reference's scatter drops such out-of-range writes, and here they are
    clamped onto the FREE slot's own last row, which is rewritten before
    it is read again."""
    return pos.long().clamp(max=s - 1)


def paged_token_coords(bt, pos, page):
    """(physical page, in-page row) for each slot's current write
    position. bt: (B, P) block table; pos: (B,). Unallocated logical
    pages map to the null sink page 0, where writes are harmless (a FREE
    slot past its table's end is clamped onto its last entry, also the
    null page)."""
    b = pos.shape[0]
    logical = (pos.long() // page).clamp(max=bt.shape[1] - 1)
    ar = torch.arange(b, device=pos.device)
    return bt[ar, logical].long(), pos.long() % page


def _cache_rows(new, dtype):
    """Rows in the cache's dtype: a float row into an int8 cache without
    scales (the share_values clustered V) takes the reference's plain
    cast, ``core.cache.plain_int8``."""
    if dtype == torch.int8 and new.dtype != torch.int8:
        from repro_torch.core.cache import plain_int8
        return plain_int8(new)
    return new.to(dtype)


def _paged_write_rows(pool, page_idx, row, new, write_mask, scale=None):
    """Commit one token's rows into pool pages, in place. pool: (nP, rows,
    page, hd); page_idx/row: (B,); new: (B, rows, hd). With ``scale`` (the
    pool's int8 scale pool (nP, rows, page)) the rows are stored as
    ``quant_rows`` codes and scales. Slots whose current page is the null
    page 0 (FREE slots, a STEADY slot's nulled dense K table) may collide
    there; whichever write wins, page 0 is never read as valid."""
    if scale is not None:
        from repro_torch.core.cache import quant_rows
        new, sc = quant_rows(new)
        scale[page_idx, :, row] = _masked_rows(write_mask, sc,
                                               scale[page_idx, :, row])
    pool[page_idx, :, row] = _masked_rows(
        write_mask, _cache_rows(new, pool.dtype), pool[page_idx, :, row])


def _dense_write_rows(cache, pos, new, write_mask, scale=None):
    """Commit one token's rows (B, rows, hd) at each slot's ``pos`` of a
    dense cache (B, rows, S, hd), in place; with ``scale`` ((B, rows, S),
    int8 caches) as ``quant_rows`` codes and scales. A DTensor cache is
    written shard by shard (``sharding.local.on_shards``)."""
    if is_dtensor(cache):
        if scale is not None and any(p.is_shard(3) for p in cache.placements):
            raise NotImplementedError(
                "an int8 cache split on head_dim: a row's scale needs the "
                "whole row")
        return on_shards(_dense_write_rows, cache, pos, new, write_mask,
                         scale, dim_maps=({0: 0}, {0: 0, 1: 1, 3: 2},
                                          {0: 0}, None), fixed=(2,))
    ar = torch.arange(new.shape[0], device=new.device)
    pl = write_positions(pos, cache.shape[2])
    if scale is not None:
        from repro_torch.core.cache import quant_rows
        new, sc = quant_rows(new)
        scale[ar, :, pl] = _masked_rows(write_mask, sc, scale[ar, :, pl])
    cache[ar, :, pl] = _masked_rows(write_mask, _cache_rows(new, cache.dtype),
                                    cache[ar, :, pl])


def layer_slice(state, key, gi):
    """Layer ``gi`` of ``state[key]``, or None when the state has no such
    entry (the scale tensors exist only under int8)."""
    t = state.get(key)
    return None if t is None else t[gi]


def _paged_global_write(state, gi, k, v, pos, write_mask):
    """Paged-layout global-cache decode write: commit one token's K/V rows
    into each slot's current page of the shared dense pool. Returns the
    layer's pool and its int8 scale pool (None for a float cache), views
    updated in place."""
    pool = state["kvp"][gi]                              # (nP, KV, page, hd)
    spool = layer_slice(state, "kvp_scale", gi)
    page = pool.shape[2]
    pk, row = paged_token_coords(state["bt_kg"], pos, page)
    pv, _ = paged_token_coords(state["bt_vg"], pos, page)
    _paged_write_rows(pool, pk, row, k, write_mask, spool)
    _paged_write_rows(pool, pv, row, v, write_mask, spool)
    return pool, spool


def _dense_global_write(state, gi, k, v, pos, write_mask):
    """Dense-layout global-cache decode write: commit one token's K/V rows
    at each slot's ``pos``, in place. Returns the layer's caches (B, KV,
    S, hd) and their int8 scales (B, KV, S) (None for a float cache)."""
    kc, vc = state["kg"][gi], state["vg"][gi]
    ksc = layer_slice(state, "kg_scale", gi)
    vsc = layer_slice(state, "vg_scale", gi)
    _dense_write_rows(kc, pos, k, write_mask, ksc)
    _dense_write_rows(vc, pos, v, write_mask, vsc)
    return kc, vc, ksc, vsc


def _local_write(state, li, k, v, pos, write_mask):
    """Local-layer decode write: commit one token's K/V rows at ring slot
    ``pos % w`` of layer ``li``'s rings (B, KV, w, hd), in place. Returns
    the rings and the absolute position each slot holds after the write
    (``ring_positions(pos + 1, w)``, (B, w))."""
    kc, vc = state["kl"][li], state["vl"][li]
    w = kc.shape[2]
    slot = torch.remainder(pos.long(), w)
    _dense_write_rows(kc, slot, k, write_mask)
    _dense_write_rows(vc, slot, v, write_mask)
    return kc, vc, attn_mod.ring_positions(pos + 1, w)


def _global_views(state, gi):
    """Dense logical views (B, KV, S, hd) of layer ``gi``'s global K and V:
    the dense caches, or the paged pool gathered through the block tables;
    an int8 cache dequantized to fp32 (the reference's jnp decode path)."""
    from repro_torch.core.cache import dequant_rows, gather_pages
    if "kvp" in state:
        pool = state["kvp"][gi]
        spool = layer_slice(state, "kvp_scale", gi)
        views = []
        for bt in (state["bt_kg"], state["bt_vg"]):
            x = gather_pages(pool, bt)
            if spool is not None:
                x = dequant_rows(x, gather_pages(spool, bt))
            views.append(x)
        return tuple(views)
    kc, vc = state["kg"][gi], state["vg"][gi]
    if "kg_scale" in state:
        kc = dequant_rows(kc, state["kg_scale"][gi])
        vc = dequant_rows(vc, state["vg_scale"][gi])
    return kc, vc


def _plain_decode_attention(xn, p, cfg, state, gi, ai, li=None,
                            write_mask=None, decode_ts=0, plain=False):
    """MHA/GQA decode for one token. xn: (B, d). Returns (B, H, hd).

    A global layer (``gi``) writes the token's K/V rows at ``pos`` (dense
    ``kg``/``vg``, or the paged pool ``kvp`` through ``bt_kg``/``bt_vg``);
    a local layer (``li`` given) at ring slot ``pos % w`` of ``kl``/``vl``
    and attends the ring's positions inside the window. During CHAI
    WARMUP (a ``chai_scores`` buffer in the state) this step's attention
    probabilities over the first ``feature_window`` positions (a local
    layer: over the first ring SLOTS, in slot order, zero-padded when the
    ring is narrower than the buffer, as the reference does) are added to
    the layer's clustering features (paper §3.3). ``write_mask`` (B,)
    bool: rows and features are committed only for masked slots (the
    mixed-phase step runs this path alongside the CHAI path).

    Without a ``chai_scores`` buffer (the MHA baseline: CHAI off) no
    probabilities are needed, and a global layer's attention is the flash
    decode op: over the paged pool in place
    (``kops.paged_decode_attention``, no densifying gather), or over the
    dense cache with ``decode_ts`` (the engine's page size) as its tile,
    so the two layouts round alike. An int8 cache is read as the
    reference reads it: the rows are dequantized into a dense fp32 view
    (paged: gathered first), and the flash decode op runs over that view
    on both layouts. The flash decode kernels, like the Pallas ones, have
    no scale mode, no softcap and no ring: with ``attn_logit_softcap`` a
    global layer, and a local layer always, takes the eager attention
    (``_decode_attention_batched``), the reference's decode math.
    ``plain``: the flash decode op's plain version (``kernels.ref``) on
    the state's device, in place of the op (the degraded decode)."""
    b = xn.shape[0]
    pos = state["pos"]
    q, k, v = attn_mod.project_qkv(xn[:, None], p, cfg, pos[:, None])
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    cap = cfg.attn_logit_softcap
    if li is not None:
        kc, vc, kv_pos = _local_write(state, li, k, v, pos, write_mask)
        window = cfg.window_size
    else:
        if "kvp" in state:
            pool, spool = _paged_global_write(state, gi, k, v, pos,
                                              write_mask)
        else:
            kc, vc, spool, _ = _dense_global_write(state, gi, k, v, pos,
                                                   write_mask)
        flash = "chai_scores" not in state and not cap
        if flash and spool is None:
            if "kvp" in state:
                y = (kref.paged_decode_ref if plain
                     else kops.paged_decode_attention)(
                    q, pool, state["bt_kg"], state["bt_vg"], pos)
            else:
                y = _flash_decode(q, kc, vc, pos, decode_ts, plain)
            return y.to(q.dtype)
        kc, vc = _global_views(state, gi)
        if flash:
            return _flash_decode(q, kc, vc, pos, decode_ts,
                                 plain).to(q.dtype)
        s = kc.shape[2]
        kv_pos = torch.arange(s, dtype=torch.int32,
                              device=xn.device).expand(b, s)
        window = 0
    y, probs = _decode_attention_batched(q, kc, vc, kv_pos, pos, window, cap)
    if "chai_scores" in state:
        wf = state["chai_scores"].shape[-1]
        pw = probs.reshape(b, -1, probs.shape[-1])[:, :, :wf]
        if pw.shape[-1] < wf:    # a ring narrower than the feature window
            pw = torch.nn.functional.pad(pw, (0, wf - pw.shape[-1]))
        if write_mask is not None:   # steady slots: features stay frozen
            pw = pw * write_mask[:, None, None]
        state["chai_scores"][ai] += pw
    return y


def _flash_decode(q, kc, vc, pos, ts, plain):
    """The flash decode op (or its plain version); on DTensors through
    ``sharding.local.batch_local``: batch split, the rest replicated."""
    if plain:
        return batch_local(kref.flash_decode_ref, kc, q, kc, vc, pos)
    return batch_local(kops.flash_decode_attention, kc, q, kc, vc, pos,
                       ts=ts)


def _attention_decode(h, params, cfg, plan, i, state, chai_ctx, steady,
                      decode_ts, relay, plain):
    """Attention layer ``i`` for one decode token h (B, d), residual
    included: the MHA path, the CHAI path, or both selected per slot by
    ``steady`` (the mixed-phase step)."""
    from repro_torch.core import chai_attention as chai_mod
    ai, gi, li = plan["attn"][i], plan["global"][i], plan["local"][i]
    p = _layer(params["attn"], ai)
    xn = rms_norm(h, p["ln"], cfg.norm_eps)
    if steady is not None:
        y_m = _plain_decode_attention(xn, p, cfg, state, gi, ai, li,
                                      write_mask=~steady,
                                      decode_ts=decode_ts, plain=plain)
        y_c = chai_mod.chai_decode_attention(
            xn, p, cfg, state, gi, ai, chai_ctx, li=li, write_mask=steady,
            decode_ts=decode_ts, relay=relay, plain=plain)
        y = torch.where(steady[:, None, None], y_c, y_m)
    elif chai_ctx is not None:
        y = chai_mod.chai_decode_attention(xn, p, cfg, state, gi, ai,
                                           chai_ctx, li=li,
                                           decode_ts=decode_ts, relay=relay,
                                           plain=plain)
    else:
        y = _plain_decode_attention(xn, p, cfg, state, gi, ai, li,
                                    decode_ts=decode_ts, plain=plain)
    return h + torch.einsum("bhe,hed->bd", y, p["wo"])


def decode_step(params, cfg: ModelConfig, tokens, state, *, chai_ctx=None,
                mixed_phase=False, decode_ts=0, relay=None, plain=False,
                embeddings=None, moe_impl="ragged"):
    """One decode step. tokens: (B,) int, or ``embeddings`` (B, d) of a
    frontend stub through the adapter (tokens then unused). Returns
    (logits (B, V) fp32, state) with ``pos`` advanced by one.
    ``moe_impl``: the MoE layers' "ragged" (the reference's default here)
    or "capacity" form.

    ``chai_ctx`` (membership, see ``repro_torch.core.clustering``) routes
    every attention layer through Clustered Head Attention over the
    clustered K cache (``kg_chai``, or the paged pool ``cp``);
    ``decode_ts`` is the S-tile size of the dense decode kernels (the
    fused CHAI decode and, CHAI off, the flash decode; the engine passes
    its page size, the paged kernels' tile).

    ``mixed_phase`` (continuous batching, with a ``chai_ctx``): WARMUP and
    STEADY slots share the batch. Both attention paths run for every
    slot, each committing its cache writes only for its own slots
    (``state["phase"]`` STEADY -> CHAI path, else the MHA path), and the
    output is selected per slot.

    ``relay`` (the relay shared-prefix decode, paged layout): the engine's
    dict of group-batched tensors, passed to every CHAI layer (see
    ``repro_torch.core.chai_attention``).

    ``plain`` (the engine's degraded decode; no ``relay``): every decode
    attention that launches a CUDA kernel otherwise (the fused pair, the
    flash decode pair) calls that kernel's plain version
    (``kernels.ref``) on the state's device instead.

    A local layer reads and writes its ring (``li``), on every path. An
    RG-LRU or RWKV layer advances its recurrent state for every slot, a
    FREE one included, with no write mask, as the reference's does
    (``insert_slot`` overwrites a slot's state at admission)."""
    assert not (plain and relay is not None), "no plain relay step"
    plan = layer_plan(cfg)
    _check_moe_impl(moe_impl)
    h = _embed(params, cfg, tokens, embeddings)
    steady = None
    if chai_ctx is not None and mixed_phase:
        from repro_torch.core.cache import PHASE_STEADY
        steady = state["phase"] >= PHASE_STEADY                # (B,)
    for i in range(cfg.n_layers):
        if plan["attn"][i] is None:
            h = _recurrent_mixer(h, params, cfg, plan, i, state, step=True)
        else:
            h = _attention_decode(h, params, cfg, plan, i, state, chai_ctx,
                                  steady, decode_ts, relay, plain)
        if plan["rwkv"][i] is not None:
            h = _channel_mix(h, params, cfg, plan["rwkv"][i], state,
                             step=True)
        else:
            h = _ffn(h[:, None], params, cfg, plan, i,
                     "capacity" if moe_impl == "ep" else moe_impl)[0][:, 0]
    h = rms_norm(h, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(h, _unembed_w(params, cfg), cfg.final_logit_softcap)
    state["pos"] = state["pos"] + 1
    return logits, state
