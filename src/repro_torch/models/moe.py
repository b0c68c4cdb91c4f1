"""Mixture-of-Experts FFN: top-k routing, dropless or capacity dispatch.

The reference's two single-device forms (``moe_ffn_ragged`` and
``moe_ffn``), with the same routing arithmetic: the router in fp32,
softmax, then the top k (an exact tie to the lower expert index, as
``lax.top_k`` breaks it), the k gates renormalized by
``max(sum, 1e-9)``, the combine in fp32 and cast back, and the shared
experts (DeepSeekMoE) added after the combine, over every token.

- ``moe_ffn_ragged`` (the reference's ``jax.lax.ragged_dot`` form): the
  (token, choice) rows sorted stably by expert, each expert's rows one
  matrix product with its weights. Exact, with no drops. The group sizes
  are read on the host (one device-to-host copy a call), since a row
  count shapes each product.
- ``moe_ffn`` (capacity, GShard style): each expert takes at most
  ``expert_capacity(n)`` rows, in the flattened (token, choice) priority
  order; a row past capacity goes to the overflow row and its gate is
  zeroed (the token keeps its residual and the shared experts). The
  (E, C, d) buffer runs as one batched product over all experts, so a
  call reads every expert's weights.

- ``moe_ffn_ep`` (expert parallelism over a mesh, the reference's
  ``shard_map`` + ``all_to_all`` GShard dispatch): tokens split over the
  batch axes and, on the sequence, over the model axis; each rank routes
  its own tokens into a per-shard capacity buffer (E, C_loc, d), an
  ``all_to_all`` over the model axis's group takes each expert's rows to
  the rank holding it, the local experts run one batched product, the
  reverse ``all_to_all`` brings the rows home and the rank combines them.
  Shared experts are replicated; the auxiliary losses are averaged over
  every rank. Through ``local_map``, with the functional (autograd-aware)
  ``all_to_all_single``.

Both are matrix products outside any Pallas kernel in the reference, and
port as torch ops. On DTensors (a mesh) the capacity form runs whole on
every rank (``sharding.local.replicated_local``: its dispatch ranks
every token of the call, which a shard cannot see), as the reference's
partitioner replicates it.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import activation_fn


def expert_capacity(n_tokens, cfg):
    """Rows an expert takes in a call of ``n_tokens`` tokens:
    ceil8(top_k * n * capacity_factor / E), at least 8."""
    cap = int(cfg.top_k * n_tokens * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-cap // 8) * 8)


def route(xf, router, k):
    """The router: fp32 logits (N, E), their softmax, and the top ``k``
    (gates (N, k) renormalized, expert ids (N, k) int64). A stable
    descending sort takes the top k, so an exact tie goes to the lower
    expert index, as ``lax.top_k`` orders it."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def _shared(y, xf, p, cfg, act):
    """Add the shared experts' FFN over every token (DeepSeekMoE)."""
    if cfg.n_shared_experts > 0:
        h = act(xf @ p["shared_gate"]) * (xf @ p["shared_up"])
        y = y + h @ p["shared_down"]
    return y


def moe_ffn_ragged(x, p, cfg):
    """Dropless MoE. x: (B, T, d) -> (B, T, d); ``p`` one layer's ``moe``
    parameters (router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d),
    optional shared_gate / shared_up (d, S f), shared_down (S f, d))."""
    b, t, d = x.shape
    n, k = b * t, cfg.top_k
    xf = x.reshape(n, d)
    act = activation_fn(cfg.activation)
    _, _, gate, ids = route(xf, p["router"], k)

    flat_e = ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = xf[order // k]                                    # (N k, d)
    sizes = torch.bincount(flat_e, minlength=cfg.n_experts).tolist()
    yb = torch.empty_like(xs)
    r0 = 0
    for e, c in enumerate(sizes):
        if c:
            xe = xs[r0:r0 + c]
            h = (act(xe @ p["w_gate"][e]) * (xe @ p["w_up"][e])).to(xs.dtype)
            yb[r0:r0 + c] = h @ p["w_down"][e]
            r0 += c
    unsorted = torch.empty_like(yb)
    unsorted[order] = yb
    y = (unsorted.reshape(n, k, d).float() * gate[..., None]).sum(1)
    y = _shared(y.to(x.dtype), xf, p, cfg, act)
    return y.reshape(b, t, d)


def moe_ffn(x, p, cfg, *, return_aux=False):
    """Capacity MoE. x: (B, T, d) -> y (B, T, d), and with ``return_aux``
    the reference's auxiliary losses {"load_balance": E * sum(mean
    prob * top-1 fraction), "router_z": mean logsumexp(logits)^2}."""
    from repro_torch.sharding.local import any_dtensor, replicated_local
    if any_dtensor(x, *p.values()):
        names = sorted(p)
        y, lb, z = replicated_local(
            lambda xx, *ws: _capacity(xx, dict(zip(names, ws)), cfg),
            x, *(p[k] for k in names), n_out=3)
        return (y, {"load_balance": lb, "router_z": z}) if return_aux else y
    y, lb, z = _capacity(x, p, cfg)
    return (y, {"load_balance": lb, "router_z": z}) if return_aux else y


def _capacity(x, p, cfg):
    """The capacity MoE on whole tensors: (y, load_balance, router_z)."""
    b, t, d = x.shape
    n, e, k = b * t, cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)
    act = activation_fn(cfg.activation)
    logits, probs, gate, ids = route(xf, p["router"], k)

    cap = expert_capacity(n, cfg)
    # each (token, choice)'s place in its expert, in flattened priority
    onehot = torch.nn.functional.one_hot(ids.reshape(-1), e)  # (N k, E)
    before = onehot.cumsum(0) - onehot
    pos = (before * onehot).sum(-1).reshape(n, k)
    keep = pos < cap
    flat_idx = torch.where(keep, ids * cap + pos, e * cap).reshape(-1)

    # the (E C + 1, d) buffer; its last row takes every dropped choice
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[flat_idx] = xf.repeat_interleave(k, dim=0)
    buf = buf[:e * cap].reshape(e, cap, d)
    h = act(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    yb = torch.bmm(h, p["w_down"]).reshape(e * cap, d)
    ybf = torch.cat([yb, yb.new_zeros((1, d))])
    gathered = ybf[flat_idx].reshape(n, k, d)
    w = (gate * keep.to(gate.dtype))[..., None]
    y = (gathered.float() * w).sum(1).to(x.dtype)
    y = _shared(y, xf, p, cfg, act).reshape(b, t, d)
    lb, z = _aux(logits, probs, ids, e)
    return y, lb, z


def _aux(logits, probs, ids, e):
    """The auxiliary losses: load balance E * sum(mean prob * top-1
    fraction) and router z mean(logsumexp(logits)^2)."""
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(ids[:, 0], e).float().mean(0)
    lb = e * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return lb, z


def _a2a(x, group):
    """``all_to_all_single`` over ``group`` (dim 0 split evenly, chunk j
    to rank j, received chunks stacked on dim 0 by source), differentiable
    (its backward is the reverse exchange)."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.all_to_all_single_autograd(x, None, None, group)


def moe_ffn_ep(x, p, cfg, ctx, *, return_aux=False):
    """Expert-parallel MoE (the reference's GShard dispatch; see the
    module docstring). x: (B, T, d), B divisible by the product of the
    context's batch axes and T by its model axis, E by the model axis;
    otherwise ``moe_ffn``, as the reference falls back. ``ctx``: a
    ``sharding.context.ShardingCtx``. Plain tensors are taken as
    replicated over the mesh."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.local import _as_dtensor
    mesh, maxis = ctx.mesh, ctx.model_axis
    m = ctx.axis_size(maxis)
    dp = 1
    for a in ctx.batch_axes:
        dp *= ctx.axis_size(a)
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if b % dp or t % m or e % m:
        return moe_ffn(x, p, cfg, return_aux=return_aux)
    act = activation_fn(cfg.activation)
    cap = expert_capacity((b // dp) * (t // m), cfg)
    el = e // m
    group = mesh.get_group(maxis)
    n_all = mesh.size()
    shared = cfg.n_shared_experts > 0

    def body(xb, router, w_gate, w_up, w_down, *sh):
        bl, tl, _ = xb.shape
        n = bl * tl
        xf = xb.reshape(n, d)
        logits, probs, gate, ids = route(xf, router, k)
        # local capacity scatter, the same arithmetic as the capacity form
        onehot = torch.nn.functional.one_hot(ids.reshape(-1), e)
        before = onehot.cumsum(0) - onehot
        pos = (before * onehot).sum(-1).reshape(n, k)
        keep = pos < cap
        flat_idx = torch.where(keep, ids * cap + pos, e * cap).reshape(-1)
        buf = xb.new_zeros((e * cap + 1, d))
        buf = buf.index_put((flat_idx,), xf.repeat_interleave(k, dim=0))
        buf = buf[:e * cap].reshape(e, cap, d)
        # dispatch: (E, C, d) -> (E/m, m C, d), source rank major in m C
        recv = _a2a(buf, group).reshape(m, el, cap, d).transpose(0, 1)
        recv = recv.reshape(el, m * cap, d)
        h = act(torch.bmm(recv, w_gate)) * torch.bmm(recv, w_up)
        yb = torch.bmm(h, w_down)
        # combine: the reverse exchange back to the owning token shard
        yb = yb.reshape(el, m, cap, d).transpose(0, 1).contiguous()
        yb = _a2a(yb, group).reshape(e * cap, d)
        ybf = torch.cat([yb, yb.new_zeros((1, d))])
        gathered = ybf[flat_idx].reshape(n, k, d)
        w = (gate * keep.to(gate.dtype))[..., None]
        y = (gathered.float() * w).sum(1).to(xb.dtype)
        if sh:
            y = y + (act(xf @ sh[0]) * (xf @ sh[1])) @ sh[2]
        lb, z = _aux(logits, probs, ids, e)
        # each rank's share of the mean over every rank
        return y.reshape(bl, tl, d), lb / n_all, z / n_all

    def pl(**dims):
        return [Shard(dims[a]) if a in dims else Replicate()
                for a in mesh.mesh_dim_names]
    x_pl = pl(**{a: 0 for a in ctx.batch_axes}, **{maxis: 1})
    e_pl = pl(**{maxis: 0})
    rep = pl()
    args = [x, p["router"], p["w_gate"], p["w_up"], p["w_down"]]
    in_pl = [x_pl, rep, e_pl, e_pl, e_pl]
    if shared:
        args += [p["shared_gate"], p["shared_up"], p["shared_down"]]
        in_pl += [rep, rep, rep]
    args = [_as_dtensor(a, mesh) for a in args]
    part = [Partial("sum")] * mesh.ndim
    y, lb, z = local_map(body, out_placements=(x_pl, part, part),
                         in_placements=tuple(in_pl), device_mesh=mesh,
                         redistribute_inputs=True)(*args)
    if return_aux:
        return y, {"load_balance": lb, "router_z": z}
    return y
