"""Training steps beyond the fused one (the reference's
``train/train_step.py``).

* ``make_train_step`` (``launch/steps.py``): the fused step. Baseline.
* ``make_microbatched_train_step``: the global batch split into
  ``n_micro`` sequential microbatches with an fp32 gradient accumulator
  (a loop in place of the reference's ``lax.scan``); it caps activation
  memory at one microbatch's.
* ``make_compressed_train_step``: manual over the pod axis only
  (``optim.compression.wrap_pod_manual``; the in-pod axes stay
  DTensor-propagated). Each pod's loss and gradients come from its slice
  of the batch, then cross the pods as int8 codes with error feedback
  (``compressed_psum`` over the pod group); parameters, moments and the
  residual are replicated across pods.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_loss_fn, value_and_grad
from repro_torch.optim import adamw


def _split_micro(batch, n_micro):
    """(B, ...) -> n_micro batches of (B / n_micro, ...) for every leaf."""
    def r(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n_micro)]


def make_microbatched_train_step(cfg: ModelConfig, *, n_micro: int,
                                 remat=True, moe_impl="capacity",
                                 lr_kw: Optional[dict] = None):
    """Gradient accumulation over ``n_micro`` sequential microbatches:
    the gradients summed in fp32 and divided by ``n_micro``, then one
    AdamW step. The metrics' loss and ce are the microbatches' means;
    ``load_balance`` and ``router_z`` are zeros, as in the reference."""
    loss_fn = make_loss_fn(cfg, remat=remat, moe_impl=moe_impl)
    lr_kw = lr_kw or {}

    def train_step(params, opt_state, batch):
        gsum = adamw.tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        loss_sum = ce_sum = 0.0
        for mb in _split_micro(batch, n_micro):
            (loss, metrics), grads = value_and_grad(loss_fn, params, mb)
            gsum = adamw.tree_map(lambda a, g: a + g.float(), gsum, grads)
            del grads
            loss_sum = loss_sum + loss
            ce_sum = ce_sum + metrics["ce"]
        grads = adamw.tree_map(lambda g: g / n_micro, gsum)
        lr = adamw.cosine_lr(opt_state.step, **lr_kw) if lr_kw else None
        params, opt_state, om = adamw.update(grads, opt_state, params, lr=lr)
        zero = torch.zeros((), dtype=torch.float32, device=loss_sum.device)
        return params, opt_state, {
            "loss": loss_sum / n_micro, "ce": ce_sum / n_micro,
            "load_balance": zero, "router_z": zero.clone(), **om}

    return train_step


def make_compressed_train_step(cfg: ModelConfig, mesh=None, *,
                               pod_axis="pod", remat=True,
                               moe_impl="capacity",
                               lr_kw: Optional[dict] = None):
    """Train step with the int8 error-feedback cross-pod gradient sum.

    Signature: (params, opt_state, residual, batch) -> (params',
    opt_state', residual', metrics). ``mesh``: a DeviceMesh with a
    ``pod_axis``; params, moments and residual DTensors replicated across
    pods, the batch split on the pod axis (dim 0). The metrics' loss and
    ce are the pods' mean."""
    from repro_torch.optim import compression
    from repro_torch.sharding.rules import Spec
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if pod_axis not in names:
        raise ValueError(
            f"make_compressed_train_step needs a device mesh with a "
            f"{pod_axis!r} axis (got {names or 'no mesh'}): build one with "
            "launch.mesh.make_mesh((pods, data, model), ('pod', 'data', "
            "'model'))")
    loss_fn = make_loss_fn(cfg, remat=remat, moe_impl=moe_impl)
    lr_kw = lr_kw or {}
    group = mesh.get_group(pod_axis)

    def body(params, opt_state, residual, batch):
        (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        grads, residual = compression.compressed_psum(grads, residual,
                                                      group)
        lr = adamw.cosine_lr(opt_state.step, **lr_kw) if lr_kw else None
        params, opt_state, om = adamw.update(grads, opt_state, params, lr=lr)
        return params, opt_state, residual, {
            "loss": compression.pod_mean(loss, group),
            "ce": compression.pod_mean(metrics["ce"], group),
            "load_balance": metrics["load_balance"],
            "router_z": metrics["router_z"], **om}

    rep, split = Spec(), Spec(pod_axis)
    wrapped = compression.wrap_pod_manual(
        body, mesh, in_specs=(rep, rep, rep, split),
        out_specs=(rep, rep, rep, rep), pod_axis=pod_axis)

    def train_step(params, opt_state, residual, batch):
        return wrapped(params, opt_state, residual, batch)

    return train_step
