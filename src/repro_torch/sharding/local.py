"""Where DTensors meet code that runs on one rank's shards.

Two kinds of call cannot take a DTensor as it comes:

* the attention kernels (``kernels/ops.py``), loaded with ``ctypes``, and
  their plain versions: ``batch_local`` runs them through ``local_map``
  with the batch axis kept sharded as the rules shard it (decode rows are
  independent) and every other axis redistributed to ``Replicate`` first,
  which is what XLA's partitioner does with an opaque custom call;
* in-place writes into a sharded cache or state (advanced-index writes,
  ``index_copy_``, ring rebuilds: ops DTensor has no sharding rule for,
  and which must land in the cache's own storage): ``on_shards`` lays
  each operand out like the cache, dim by dim, and runs the write on the
  local shards, where a batch index is local.

Both are the identity on plain tensors, so the unsharded paths run the
same code as before.
"""
from __future__ import annotations

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def any_dtensor(*ts) -> bool:
    return any(is_dtensor(t) for t in ts)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def batch_local(fn, ref, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every tensor argument split on its
    dim 0 as ``ref`` (a DTensor with the batch at dim 0) splits its
    batch, and replicated on every other dim; the outputs (tensors, or a
    tuple of them, batch first) come back as DTensors split the same way.
    Plain tensors throughout: a plain call."""
    if not any_dtensor(ref, *args, *kwargs.values()):
        return fn(*args, **kwargs)
    from torch.distributed.tensor.experimental import local_map
    ref = ref if is_dtensor(ref) else next(
        a for a in (*args, *kwargs.values()) if is_dtensor(a))
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    # a list: one output's placements (a tuple would name several)
    pl = [Shard(0) if p.is_shard(0) else Replicate() for p in ref.placements]
    names = list(kwargs)

    def body(*flat):
        pos, kw = flat[:len(args)], dict(zip(names, flat[len(args):]))
        return fn(*pos, **kw)

    flat = [(_as_dtensor(a, mesh) if torch.is_tensor(a) else a)
            for a in (*args, *kwargs.values())]
    in_pl = tuple(pl if torch.is_tensor(a) else None for a in flat)
    return local_map(body, out_placements=pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*flat)


def heads_local(fn, q, k, v, *rest, **kwargs):
    """``fn(q, k, v, *rest, **kwargs)`` for attention over (B, T, H, hd)
    queries and (B, S, KV, hd) keys / values, run on each rank's (batch,
    heads) block through ``local_map``: the batch split as q's, the heads
    split on every mesh dim where q splits its heads and KV divides by
    that dim's size (a query head's K/V head then lives on the same rank),
    every other dim replicated. The output (B, T, H, hd) comes back split
    the same way; ``rest`` (positions) replicated. Attention is
    independent over batch rows and heads, so no collective runs inside,
    forward or backward. Plain tensors: a plain call."""
    if not any_dtensor(q, k, v):
        return fn(q, k, v, *rest, **kwargs)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    ref = next(t for t in (q, k, v) if is_dtensor(t))
    mesh = ref.device_mesh
    q = _as_dtensor(q, mesh)
    n_kv = k.shape[2]
    qp, kp = [], []
    for j, p in enumerate(q.placements):
        if p.is_shard(0):
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif p.is_shard(2) and n_kv % mesh.size(j) == 0:
            qp.append(Shard(2))
            kp.append(Shard(2))
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    rep = [Replicate()] * mesh.ndim
    flat = [q, _as_dtensor(k, mesh), _as_dtensor(v, mesh),
            *(_as_dtensor(r, mesh) if torch.is_tensor(r) else r
              for r in rest)]
    in_pl = (qp, kp, kp, *(rep if torch.is_tensor(r) else None
                            for r in rest))
    return local_map(lambda *a: fn(*a, **kwargs), out_placements=qp,
                     in_placements=in_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*flat)


def replicated_local(fn, *args, n_out=1, **kwargs):
    """``fn(*args, **kwargs)`` on whole tensors: every DTensor argument
    gathered to ``Replicate`` and each rank running the whole function
    (the outputs replicated). For ops with no sharding rule whose
    semantics span the whole tensor (the capacity MoE's dispatch, which
    ranks every token of the call). Plain tensors: a plain call."""
    flat = [*args, *kwargs.values()]
    ref = next((a for a in flat if is_dtensor(a)), None)
    if ref is None:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = ref.device_mesh
    rep = [Replicate()] * mesh.ndim
    names = list(kwargs)

    def body(*f):
        return fn(*f[:len(args)], **dict(zip(names, f[len(args):])))

    flat = [_as_dtensor(a, mesh) if torch.is_tensor(a) else a for a in flat]
    in_pl = tuple(rep if torch.is_tensor(a) else None for a in flat)
    out_pl = rep if n_out == 1 else tuple([rep] * n_out)
    return local_map(body, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*flat)


def _layout_like(t, ref, dim_map, fixed=()):
    """``t`` (a DTensor or a plain, replicated tensor) laid out so that
    wherever ``ref`` is split on dim d, ``t`` is split on dim_map[d], and
    replicated where ``ref`` is split on a dim ``t`` lacks. A split of
    ``ref`` on a dim in ``fixed`` (one the write indexes by global
    position) is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    pl = []
    for p in ref.placements:
        if p.is_shard() and p.dim in fixed:
            raise NotImplementedError(
                f"an in-place write into a tensor split on dim {p.dim} "
                f"({ref.placements}), which it indexes by global position")
        pl.append(Shard(dim_map[p.dim]) if p.is_shard() and p.dim in dim_map
                  else Replicate())
    return _as_dtensor(t, mesh).redistribute(mesh, tuple(pl)).to_local()


def on_shards(fn, target, *args, dim_maps=(), fixed=()):
    """Run ``fn(target, *args)`` on local shards: ``target`` a DTensor
    written in place, each tensor in ``args`` laid out like it through
    its ``dim_maps`` entry ({target dim: arg dim}; None leaves an
    argument as it is). ``fixed``: the target's dims the write indexes
    by global position, which must not be split. Plain ``target``: a
    plain call."""
    if not is_dtensor(target):
        return fn(target, *args)
    loc = []
    for i, a in enumerate(args):
        m = dim_maps[i] if i < len(dim_maps) else None
        if m is None or not torch.is_tensor(a):
            loc.append(a.to_local() if is_dtensor(a) else a)
        else:
            loc.append(_layout_like(a, target, m, fixed))
    return fn(target.to_local(), *loc)
