"""Logical-axis rules: logical axis names -> mesh axes -> DTensor placements.

Every tensor of the system carries a tuple of *logical* axis names
(``Ax``). ``spec_for`` maps those names onto the axes of a mesh with the
reference's divisibility-aware fallbacks, so one rule table serves every
arch on every mesh:

* a mesh axis goes to at most one tensor dim;
* a candidate is skipped unless the dim divides by its mesh size (so
  gemma3's 8 query heads fall through to ``head_dim`` on a 16-way model
  axis);
* ``batch`` prefers the combined ("pod", "data") group on a multi-pod
  mesh; ``seq`` takes the data axis only when ``batch`` could not.

A spec is the port's own ``Spec``: one entry a tensor dim (trailing
unsharded dims trimmed), each a mesh-axis name, a tuple of names (one dim
over several mesh axes, the first the major one), or None. It equals the
reference's ``PartitionSpec`` entry for entry on the same mesh shape.

The torch side turns a spec into DTensor placements on a
``torch.distributed.device_mesh.DeviceMesh``: ``placements_for`` gives one
placement a mesh dim, ``Shard(d)`` where the spec puts that mesh axis on
tensor dim d, else ``Replicate()``. A dim over a group such as ("pod",
"data") is ``Shard(d)`` on both mesh dims; DTensor splits a dim sharded on
several mesh dims in mesh-dim order, so the pod index is the major one,
as in JAX: the block at mesh coordinate (p, q, m) is the same block JAX
gives that device. ``sharding_for`` / ``tree_shardings`` /
``zero_shardings`` return a ``Sharding`` (mesh, placements, spec).

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``), or with ``axis_names`` and ``devices.shape`` (a small
stand-in, as the tests use).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence


class Ax:
    """A tensor's tuple of logical axis names (a leaf of a logical tree)."""
    __slots__ = ("names",)

    def __init__(self, *names):
        self.names = tuple(names)

    def __repr__(self):
        return f"Ax{self.names}"

    def __eq__(self, other):
        return isinstance(other, Ax) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


class Struct(NamedTuple):
    """A tensor's shape and dtype, with no storage (the dry-run's and the
    rules' stand-in for ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: object


class Spec(tuple):
    """One entry a tensor dim: a mesh-axis name, a tuple of names, or
    None (trailing Nones trimmed by ``spec_for``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple(self)!r}"


# Ordered candidates per logical axis name. Tuples = combined mesh axes.
DEFAULT_RULES: dict = {
    "batch":      [("pod", "data"), ("data",), ("pod",)],
    "seq":        [("pod", "data"), ("data",)],   # CP fallback (decode B=1)
    "seq_nosplit": [],
    "vocab":      [("model",)],
    "embed":      [],                 # replicated (activations row dim)
    "embed_tp":   [("model",)],       # TP'd embed dim (e.g. rwkv channel dims)
    "heads":      [("model",)],
    "kv_heads":   [("model",)],
    "head_dim":   [("model",)],       # fallback target when heads fail
    "mlp":        [("model",)],
    "experts":    [("model",)],
    "expert_mlp": [("model",)],       # fallback if experts not divisible
    "rnn":        [("model",)],
    "conv":       [],
    "layers":     [],                 # stacked leading dim: never sharded
    "lora":       [],
    "capacity":   [],
    "clusters":   [],                 # CHAI representative-head axis
}


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]],
             mesh, rules: Optional[dict] = None) -> Spec:
    """The spec of a tensor of ``shape`` with logical names ``logical``."""
    rules = rules or DEFAULT_RULES
    assert len(shape) == len(logical), (shape, logical)
    axis_sizes = mesh_axes(mesh)
    used: set = set()
    out: list = []
    for dim, name in zip(shape, logical):
        assigned = None
        for cand in rules.get(name, []) if name else []:
            group = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a not in axis_sizes for a in group):
                continue
            if any(a in used for a in group):
                continue
            size = math.prod(axis_sizes[a] for a in group)
            if size > 1 and dim % size == 0:
                assigned = group if len(group) > 1 else group[0]
                used.update(group)
                break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


def zero_spec(shape, base_spec, mesh) -> Spec:
    """ZeRO-1: shard one more dim of an elementwise-updated tensor
    (optimizer moments, gradients before the update) over the data (and
    pod) axes: the first dim not sharded in ``base_spec`` whose size
    divides the combined data axes; ``base_spec`` unchanged if none does.
    The update is elementwise, so any extra split is valid; the sharded
    step redistributes the gradients to it (a reduce-scatter) and the
    parameters back (an all-gather)."""
    axis_sizes = mesh_axes(mesh)
    group = tuple(a for a in ("pod", "data") if a in axis_sizes)
    if not group:
        return Spec(*base_spec)
    dsize = math.prod(axis_sizes[a] for a in group)
    if dsize <= 1:
        return Spec(*base_spec)
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    for i, dim in enumerate(shape):
        if spec[i] is None and dim % dsize == 0:
            spec[i] = group if len(group) > 1 else group[0]
            return Spec(*spec)
    return Spec(*base_spec)


# ---------------------------------------------------------------- torch ----

class Sharding(NamedTuple):
    """Where a tensor lives: a DeviceMesh, one DTensor placement a mesh
    dim, and the spec they came from."""
    mesh: object
    placements: tuple
    spec: Spec


def placements_for(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim d, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, e in enumerate(spec):
        for a in ((e,) if isinstance(e, str) else (e or ())):
            where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def sharding_for(shape, logical, mesh, rules=None) -> Sharding:
    spec = spec_for(shape, logical, mesh, rules)
    return Sharding(mesh, placements_for(spec, mesh), spec)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, placements_for(Spec(), mesh), Spec())


def _shape(s):
    return tuple(s.shape)


def tree_map2(fn, a, b):
    """``fn`` over the leaves of two matching trees of dicts (and
    NamedTuples); ``Ax`` and shape records are leaves."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, tuple) and hasattr(a, "_fields") and not hasattr(
            a, "dtype"):
        return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))
    return fn(a, b)


def tree_specs(shapes_tree, logical_tree, mesh, rules=None):
    return tree_map2(lambda s, l: spec_for(_shape(s), l.names, mesh, rules),
                     shapes_tree, logical_tree)


def tree_shardings(shapes_tree, logical_tree, mesh, rules=None):
    """Matching trees of shapes and ``Ax`` -> ``Sharding`` leaves."""
    return tree_map2(
        lambda s, l: sharding_for(_shape(s), l.names, mesh, rules),
        shapes_tree, logical_tree)


def zero_shardings(shapes_tree, logical_tree, mesh, rules=None):
    """Shardings of optimizer state under ZeRO-1 (the parameter's spec
    plus one data-sharded dim)."""
    def one(s, l):
        base = spec_for(_shape(s), l.names, mesh, rules)
        spec = zero_spec(_shape(s), base, mesh)
        return Sharding(mesh, placements_for(spec, mesh), spec)
    return tree_map2(one, shapes_tree, logical_tree)


def place(t, sharding: Sharding):
    """A full tensor as the DTensor ``sharding`` names (every rank holds
    the same full tensor; each keeps its block), or a DTensor
    redistributed to it."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_tree(tree, shardings):
    return tree_map2(place, tree, shardings)


def local_shape(shape, sharding: Sharding):
    """The block of ``shape`` each rank holds under ``sharding`` (the
    rules shard only divisible dims)."""
    out = list(shape)
    for p, n in zip(sharding.placements, tuple(sharding.mesh.shape)):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)


def empty_dtensor(struct, sharding: Sharding, device=None, fill=None):
    """A DTensor of ``struct``'s global shape and dtype placed by
    ``sharding``, each rank allocating only its block (zeros with
    ``fill`` 0; under a ``FakeTensorMode``, nothing at all)."""
    import torch
    from torch.distributed.tensor import DTensor
    loc = local_shape(struct.shape, sharding)
    t = (torch.zeros(loc, dtype=struct.dtype, device=device) if fill == 0
         else torch.empty(loc, dtype=struct.dtype, device=device))
    return DTensor.from_local(t, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(struct.shape),
                              stride=_contiguous_strides(struct.shape))


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(tuple(shape)):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def zeros_tree(structs, shardings, device=None):
    """Zero DTensors of a tree of ``Struct`` placed by ``shardings``."""
    return tree_map2(lambda s, sh: empty_dtensor(s, sh, device, fill=0),
                     structs, shardings)
