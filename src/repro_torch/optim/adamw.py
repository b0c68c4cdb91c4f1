"""AdamW with global-norm clipping and a cosine schedule (the reference's
``optim/adamw.py`` in torch ops, not ``torch.optim.AdamW``: torch's
folds the weight decay and the bias corrections in another order and has
no global-norm clip).

The state is ``AdamWState(step, m, v)``: a 0-d int32 step and fp32
moment trees of the parameters' structure. Parameter trees are nested
dicts (``{group: {name: tensor}}``); ``tree_map`` and ``tree_leaves``
walk them in the reference's order (dict keys sorted). ``update`` is
functional: it returns new parameters and a new state. A bf16 parameter
is updated in fp32 and cast back. (The reference's ``opt_barrier`` is a
TPU scheduling hint and changes no value.) Every op is elementwise or a
sum, so the same code runs on DTensor trees: each moment keeps its
parameter's placements (``init``), or the ZeRO placements the sharded
step gives it, and the update's norm is a sum over ranks.
``state_structs`` gives the dry-run the state's structs and logical
names.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    m: dict
    v: dict


def tree_leaves(tree):
    """The tensors of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_pick(tree, i):
    """Element ``i`` of the tuple at every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    return tree[i]


def init(params) -> AdamWState:
    """Step 0 and zero fp32 moments on each parameter's device (a
    DTensor parameter's moments with its placements)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, m=tree_map(zeros, params),
                      v=tree_map(zeros, params))


def state_structs(param_structs, param_logical):
    """(``AdamWState`` of ``Struct``, ``AdamWState`` of ``Ax``) matching
    ``init`` (the dry-run's optimizer structs)."""
    from repro_torch.sharding.rules import Ax, Struct

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return Struct(tuple(tree.shape), torch.float32)
    shapes = AdamWState(step=Struct((), torch.int32), m=f32(param_structs),
                        v=f32(param_structs))
    return shapes, AdamWState(step=Ax(), m=param_logical, v=param_logical)


@functools.lru_cache(maxsize=1)
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.cosf.restype = ctypes.c_float
    libm.cosf.argtypes = [ctypes.c_float]
    return libm.cosf


def _fma32(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in fp64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def cosine_lr(step, *, peak=3e-4, warmup=100, total=10000, floor=0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine
    down to ``floor * peak`` at ``total``. ``step``: an int or a 0-d
    integer tensor. Returns a 0-d fp32 tensor on the step's device (the
    CPU for an int).

    The scalar is computed on the host in fp32 exactly as the reference's
    jitted step computes it on the CPU, so that ``lr`` is bitwise equal:
    XLA folds each division by a constant into a product with its fp32
    reciprocal, contracts the final multiply-add into one FMA, and calls
    the C library's ``cosf`` (torch's vectorized cosine differs from it
    in the last bit on ~5% of inputs)."""
    f32 = np.float32
    device = step.device if torch.is_tensor(step) else "cpu"
    s = int(step)
    if s < warmup:
        lr = f32(s + 1) * f32(f32(peak) / f32(warmup))
    else:
        inv = f32(f32(1.0) / f32(max(total - warmup, 1)))
        frac = min(max(f32(f32(s - warmup) * inv), f32(0.0)), f32(1.0))
        cos = f32(_cosf()(float(f32(frac * f32(math.pi)))))
        lr = _fma32(f32(cos + f32(1.0)), f32((1 - floor) * 0.5),
                    f32(floor)) * f32(peak)
    return torch.tensor(lr, dtype=torch.float32, device=device)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in ``tree_leaves`` order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def update(grads, state: AdamWState, params, *, lr=None, b1=0.9, b2=0.95,
           eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step: clip ``grads`` to global norm ``clip_norm``, fold
    them into the moments, bias-correct, decay the weights and step by
    ``lr`` (``cosine_lr(state.step)`` when None). Returns (new params,
    new state, {"grad_norm", "lr"})."""
    step = state.step + 1
    if lr is None:
        lr = cosine_lr(state.step)
    dev = step.device
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.float()
    mhat_c = 1.0 / (1 - torch.tensor(b1, dtype=torch.float32,
                                     device=dev) ** t)
    vhat_c = 1.0 / (1 - torch.tensor(b2, dtype=torch.float32,
                                     device=dev) ** t)

    def leaf(p, g, m_, v_):
        g = g.float() * scale
        m = b1 * m_ + (1 - b1) * g
        v = b2 * v_ + (1 - b2) * torch.square(g)
        u = (m * mhat_c) / (torch.sqrt(v * vhat_c) + eps)
        u = u + weight_decay * p.float()
        return (p.float() - lr * u).to(p.dtype), m, v

    out = tree_map(leaf, params, grads, state.m, state.v)
    return tree_pick(out, 0), AdamWState(step=step, m=tree_pick(out, 1),
                                         v=tree_pick(out, 2)), {
        "grad_norm": gnorm, "lr": lr}
