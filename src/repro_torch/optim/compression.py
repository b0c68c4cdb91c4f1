"""Int8 error-feedback gradient compression for the cross-pod reduction
(the reference's ``optim/compression.py`` in torch ops).

Gradients are reduced within a pod at full precision; across pods each
leaf is quantized to int8 with one fp32 scale, the quantization error is
carried into the next step's gradient (error feedback keeps the scheme
unbiased over steps), and the int8 payload is summed as int32 over the
pods. ``compressed_psum`` takes an explicit ``torch.distributed`` process
group in place of the reference's ``shard_map`` axis name.

``wrap_pod_manual`` is the port's ``shard_map`` manual over the pod axis
only: each pod runs the body on DTensors over its own in-pod mesh (the
data and model axes stay DTensor-propagated, as the reference's stay
GSPMD-automatic), and the body reaches the other pods only through the
pod group (``compressed_psum``, the loss mean). A DTensor leaf of the
in-pod body is the same local block as on the whole mesh: a leaf
replicated across pods keeps its in-pod placements, and a leaf split on
dim 0 over the pod axis (the batch) is the pod's slice.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map, tree_pick


def _quantize(g):
    """Symmetric per-tensor int8. Returns (q int8, scale 0-d fp32)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_residual_init(params):
    """Error-feedback residual buffer, same shapes (and, on a mesh,
    placements) as params (fp32)."""
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format),
        params)


def _local(t):
    from repro_torch.sharding.local import is_dtensor
    if not is_dtensor(t):
        return t
    if any(p.is_partial() for p in t.placements):
        from torch.distributed.tensor import Replicate
        t = t.redistribute(t.device_mesh, [
            Replicate() if p.is_partial() else p for p in t.placements])
    return t.to_local()


def _like(local, ref):
    """A local result back as a DTensor placed like ``ref`` (as is for a
    plain ``ref``)."""
    from repro_torch.sharding.local import is_dtensor
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    pl = [p for p in ref.placements]
    return DTensor.from_local(local, ref.device_mesh, pl, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def compressed_psum(grads, residual, group=None):
    """Error-feedback int8 sum over the ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default group).

    grads/residual: local (already in-pod-reduced) fp32 trees, plain or
    DTensors over the in-pod mesh. Returns (mean grads fp32, new residual
    fp32): each rank's codes are summed in int32 (no wraparound up to
    2^23 ranks) and scaled by the mean of the ranks' scales, as in the
    reference. On a DTensor the scale is the whole leaf's (a max over the
    in-pod shards) and each rank sums its own block with the same block
    of the other pods."""
    n = dist.get_world_size(group)

    def one(g, r):
        g = g.float() + r                       # fold in carried error
        q, scale = _quantize(g)
        err = g - _dequantize(q, scale)          # local quantization error
        total = _local(q).to(torch.int32)
        dist.all_reduce(total, group=group)
        s_tot = _local(scale).reshape(1).clone()
        dist.all_reduce(s_tot, group=group)      # shared mean scale
        mean = total.float() * (s_tot[0] / n) / n
        return _like(mean, g), err

    out = tree_map(one, grads, residual)
    return tree_pick(out, 0), tree_pick(out, 1)


def pod_mean(t, group):
    """The mean of a 0-d (or any) value over the ranks of ``group``."""
    loc = _local(t).clone()
    dist.all_reduce(loc, group=group)
    return _like(loc / dist.get_world_size(group), t)


def _to_pod(t, split, sub, pod_dim):
    """A whole-mesh leaf as the in-pod body sees it: the same local block
    on the in-pod mesh ``sub``, its pod dim ``Shard(0)`` (``split``) or
    replicated first."""
    from repro_torch.sharding.local import is_dtensor
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    want = list(t.placements)
    want[pod_dim] = Shard(0) if split else Replicate()
    if list(t.placements) != want:
        t = t.redistribute(t.device_mesh, want)
    return DTensor.from_local(t.to_local(), sub, want[:pod_dim]
                              + want[pod_dim + 1:], run_check=False)


def _from_pod(t, split, mesh, pod_dim):
    """An in-pod body's output leaf back on the whole mesh."""
    from repro_torch.sharding.local import is_dtensor
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = list(t.placements)
    pl.insert(pod_dim, Shard(0) if split else Replicate())
    return DTensor.from_local(t.to_local(), mesh, pl, run_check=False)


def _map_spec(fn, tree, spec):
    """``fn(leaf, split)`` over a tree of dicts / NamedTuples; ``spec`` a
    matching tree of ``Spec`` leaves or one ``Spec`` for the whole
    subtree, ``split`` whether it names the pod axis on dim 0."""
    from repro_torch.sharding.rules import Spec
    sub = (lambda k: spec) if isinstance(spec, Spec) else (
        lambda k: spec[k] if isinstance(spec, dict) else getattr(spec, k))
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, sub(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_spec(fn, getattr(tree, f), sub(f))
                            for f in tree._fields))
    return fn(tree, len(spec) > 0 and spec[0] is not None)


def wrap_pod_manual(fn, mesh, in_specs, out_specs, *, pod_axis: str = "pod"):
    """``fn`` run manually over the pod axis only (the reference's
    ``shard_map(..., axis_names={pod_axis})``): each pod calls ``fn`` on
    DTensors over its in-pod mesh (every other mesh axis), which DTensor
    keeps partitioning. ``in_specs`` / ``out_specs``: one tree a
    positional argument / output, of ``sharding.rules.Spec`` leaves (or a
    ``Spec`` for a whole subtree) naming only the pod axis: ``Spec()``
    replicated across pods, ``Spec("pod")`` dim 0 split on pods. The body
    reaches the other pods through ``mesh.get_group(pod_axis)``."""
    names = tuple(mesh.mesh_dim_names)
    if pod_axis not in names:
        raise ValueError(f"wrap_pod_manual needs a mesh with a {pod_axis!r} "
                         f"axis, got {names}")
    pod_dim = names.index(pod_axis)
    rest = tuple(a for a in names if a != pod_axis)
    sub = mesh[rest] if len(rest) > 1 else mesh[rest[0]]

    def wrapped(*args):
        inner = [_map_spec(lambda t, s: _to_pod(t, s, sub, pod_dim), a, sp)
                 for a, sp in zip(args, in_specs)]
        outs = fn(*inner)
        return tuple(_map_spec(lambda t, s: _from_pod(t, s, mesh, pod_dim),
                               o, sp) for o, sp in zip(outs, out_specs))

    return wrapped
