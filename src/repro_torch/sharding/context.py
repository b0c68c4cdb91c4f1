"""Mesh context: lets the model code opt into sharded sub-regions.

The model code is mesh-agnostic: DTensor propagates the parameters'
placements op by op. A few blocks need what propagation will not give
them: the expert-parallel MoE's ``all_to_all`` dispatch
(``models.moe.moe_ffn_ep``) and the pin of the layer carry to
(batch-sharded, replicated, replicated) (``pin_activations``). Those
blocks read the active context; with none set they take their plain
paths (one device, the CPU tests).

Usage (launcher, dry-run)::

    with sharding_ctx(mesh, batch_axes=("pod", "data"), model_axis="model"):
        out = step(params, batch)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

from repro_torch.sharding.rules import mesh_axes


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    mesh: object
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    def axis_size(self, name):
        return mesh_axes(self.mesh)[name]


_ACTIVE: list = []


@contextlib.contextmanager
def sharding_ctx(mesh, *, batch_axes=("data",), model_axis="model"):
    ctx = ShardingCtx(mesh=mesh, batch_axes=tuple(batch_axes),
                      model_axis=model_axis)
    _ACTIVE.append(ctx)
    try:
        yield ctx
    finally:
        _ACTIVE.pop()


def current_ctx() -> Optional[ShardingCtx]:
    return _ACTIVE[-1] if _ACTIVE else None


def pin_activations(t):
    """Pin a (B, T, d) DTensor activation to (batch-sharded, replicated,
    replicated). Applied to the layer carry: without it propagation may
    leave the residual stream split on d (after a row-parallel
    projection, as a pending sum), and every projection of the next layer
    would gather it again. The identity without an active context, on a
    plain tensor, or for a value that is not 3-D."""
    ctx = current_ctx()
    if ctx is None or getattr(t, "ndim", 0) != 3:
        return t
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(ctx.mesh, [
        Shard(0) if a in ctx.batch_axes else Replicate()
        for a in ctx.mesh.mesh_dim_names])
