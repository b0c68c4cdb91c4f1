"""RWKV-6 "Finch" block: data-dependent-decay linear attention + channel mix.

The reference's ``models/rwkv.py`` in torch ops. The full-sequence path
is chunkwise-parallel: a loop over chunks of ``CHUNK`` tokens carrying
the (B, H, dk, dv) state, with products inside each chunk. Intra-chunk
relative decays use the factored form R~ = r * exp(logW_{i-1}),
K~ = k * exp(-logW_j); the per-step log-decay is clamped to
>= -LOG_CLAMP so the factored exponentials stay in fp32 range over a
chunk. Decode is the plain one-step recurrence. (The reference's XLA
barrier changes no value and has no counterpart here.)
``_pin_replicated_d`` is the reference's pin of a (B, T, d) activation
to batch-sharded, d replicated; as there, no call site uses it (a pin at
the lerp was measured worse there: it adds a resharding instead of
changing the producer's layout).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 32
LOG_CLAMP = 1.5          # per-step |log w| cap; CHUNK*LOG_CLAMP = 48 < 88


def _token_shift_full(x, last):
    """x: (B, T, d); last: (B, d) previous token (state) -> shifted x."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _decays(xw, p, cfg):
    """Data-dependent per-channel log decay, clamped. xw: (..., d). The
    decay is computed in the parameters' dtype and only then cast to
    fp32, as in the reference."""
    lora = torch.tanh(xw @ p["w_decay_a"]) @ p["w_decay_b"]
    logw = -torch.exp(torch.clamp(p["decay_base"] + lora, -8.0, 1.0))
    return torch.clamp(logw.float(), min=-LOG_CLAMP)


def _pin_replicated_d(t):
    """Keep a (B, T, d) DTensor replicated on d, the batch split (the
    layer carry's pin, ``sharding.context.pin_activations``). The
    identity without an active sharding context."""
    from repro_torch.sharding.context import pin_activations
    return pin_activations(t)


def _project(x, xs, p, cfg):
    """Lerped projections. x: (..., d); xs: shifted x."""
    mu = p["mu"]  # (5, d): r, k, v, w, g

    def lerp(i):
        return x + (xs - x) * mu[i]

    r = lerp(0) @ p["w_r"]
    k = lerp(1) @ p["w_k"]
    v = lerp(2) @ p["w_v"]
    logw = _decays(lerp(3), p, cfg)
    g = F.silu(lerp(4) @ p["w_g"])
    return r, k, v, logw, g


def _heads(x, n_heads, hd):
    return x.reshape(*x.shape[:-1], n_heads, hd)


def _group_norm(o, scale, eps):
    """Per-head group norm on (..., H, hd), the population variance (as
    ``jnp.var``; torch's default is the unbiased one)."""
    mean = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    o = (o - mean) * torch.rsqrt(var + eps)
    return o * (1.0 + scale)


def rwkv_time_mix_fullseq(x, p, cfg, state):
    """x: (B, T, d); state: dict(shift=(B, d), wkv=(B, H, dk, dv)).
    Returns (y, new state in x's dtype)."""
    bsz, t, d = x.shape
    nh, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    xs = _token_shift_full(x, state["shift"])
    r, k, v, logw, g = _project(x, xs, p, cfg)
    r, k, v = (_heads(a, nh, hd).float() for a in (r, k, v))
    logw = _heads(logw, nh, hd)                              # (B, T, H, hd)
    u = p["u"].float()                                       # (H, hd)

    c = min(CHUNK, t)
    assert t % c == 0, (t, c)
    nc = t // c

    def chunked(a):  # (B, T, H, X) -> (nc, B, H, c, X)
        return a.reshape(bsz, nc, c, nh, -1).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunked, (r, k, v, logw))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device),
                      diagonal=-1)
    # state stores S with shape (B, H, dk, dv); decay applies on dk axis.
    s = state["wkv"].float()
    outs = []
    for r_i, k_i, v_i, lw_i in zip(rc, kc, vc, wc):          # (B, H, c, hd)
        cum = torch.cumsum(lw_i, dim=2)                      # logW_i
        cum_prev = cum - lw_i                                # logW_{i-1}
        r_t = r_i * torch.exp(cum_prev)
        k_t = k_i * torch.exp(-cum)
        att = r_t @ k_t.transpose(-1, -2)                    # (B, H, c, c)
        att = torch.where(mask, att, 0.0)
        bonus = torch.einsum("bhid,bhid->bhi", r_i * u[None, :, None, :],
                             k_i)
        o = att @ v_i                                        # intra
        o = o + r_t @ s                                      # cross-chunk
        o = o + bonus[..., None] * v_i                       # current token
        decay_all = torch.exp(cum[:, :, -1:, :])             # exp(logW_c)
        k_rem = k_i * torch.exp(cum[:, :, -1:, :] - cum)     # W_c / W_j
        s = s * decay_all.transpose(-1, -2) + k_rem.transpose(-1, -2) @ v_i
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(bsz, t, nh, hd)
    o = _group_norm(o, p["ln_x"].reshape(nh, hd), cfg.norm_eps)
    o = (o.reshape(bsz, t, d) * g.float()).to(x.dtype)
    y = o @ p["w_o"]
    return y, {"shift": x[:, -1], "wkv": s.to(x.dtype)}


def rwkv_time_mix_decode(x, p, cfg, state):
    """x: (B, d); one-step recurrence."""
    bsz, d = x.shape
    nh, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    r, k, v, logw, g = _project(x, state["shift"], p, cfg)
    r, k, v = (_heads(a, nh, hd).float() for a in (r, k, v))
    w = torch.exp(_heads(logw, nh, hd))                      # (B, H, hd)
    u = p["u"].float()
    s = state["wkv"].float()                                 # (B, H, dk, dv)
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhd,bhdv->bhv", r, s + u[None, :, :, None] * kv)
    s_new = s * w[..., None] + kv
    o = _group_norm(o, p["ln_x"].reshape(nh, hd), cfg.norm_eps)
    o = (o.reshape(bsz, d) * g.float()).to(x.dtype)
    y = o @ p["w_o"]
    return y, {"shift": x, "wkv": s_new.to(x.dtype)}


def rwkv_channel_mix_fullseq(x, p, last):
    """x: (B, T, d); last: (B, d). Returns (y, the new last token)."""
    xs = _token_shift_full(x, last)
    mu = p["cmu"]
    xk = x + (xs - x) * mu[0]
    xr = x + (xs - x) * mu[1]
    k = torch.square(F.relu(xk @ p["c_k"]))
    kv = k @ p["c_v"]
    r = torch.sigmoid(xr @ p["c_r"])
    return r * kv, x[:, -1]


def rwkv_channel_mix_decode(x, p, last):
    mu = p["cmu"]
    xk = x + (last - x) * mu[0]
    xr = x + (last - x) * mu[1]
    k = torch.square(F.relu(xk @ p["c_k"]))
    kv = k @ p["c_v"]
    r = torch.sigmoid(xr @ p["c_r"])
    return r * kv, x
