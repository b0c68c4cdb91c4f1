"""Multi-pod dry-run: trace one step of every (arch x shape x mesh) cell
on a fake mesh and derive its per-device roofline.

The reference lowers and compiles each cell with XLA on 512 placeholder
CPU devices. The port has no compiler to ask, so it runs the step once:

* a fake process group of 256 (16x16) or 512 (2x16x16) ranks in this one
  process (``torch.testing._internal.distributed.fake_pg``): collectives
  are issued and complete, and move nothing;
* every input a DTensor placed by the logical-axis rules
  (``sharding.rules``) on a ``meta``-type mesh, its local block a
  ``meta`` tensor: shapes, dtypes and placements, no storage (a
  ``FakeTensorMode`` would also fake DTensor's own index arithmetic,
  which reads values);
* the step run once under ``roofline.cost_mode()``, which sees the local
  ops each rank runs on its shards (FLOPs on local shapes, not global
  ones) and the collectives DTensor issues.

So it allocates nothing and launches nothing: it is the one entry point
that needs no GPU. The decode kernels, which no trace can see into,
answer ``meta`` tensors with empty outputs of their shapes and are
counted as XLA counts a custom call (``kernels.ops._opaque_call``,
``roofline.CostMode.opaque_call``); the record's ``opaque_calls``
counts them. ``--unroll`` is accepted and changes nothing: an eager
trace runs, and counts, every layer.

Per cell it records, per device: the argument bytes (the local blocks of
the inputs), the peak of live storage bytes (the argument bytes plus the
most bytes of storages the step made alive at once, tracked by weak
references to each new local tensor's storage: no allocator rounding or
fragmentation), FLOPs, bytes, collective bytes by kind, the three
roofline terms at the H100 SXM's constants, the bottleneck,
``model_flops`` and ``useful_flop_ratio``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch chai-llama-7b \\
      --shape train_4k --steps train_zero
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi
Output: ``--out`` (default ``build/dryrun``), never ``benchmarks/``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import production_shape
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding import rules

# Archs whose every layer is full (unwindowed) attention: long_500k
# skipped, as in the reference.
FULL_ATTENTION_ONLY = {"nemotron-4-15b", "qwen3-moe-30b-a3b",
                       "deepseek-moe-16b", "musicgen-large", "internvl2-76b",
                       "chai-llama-7b"}

ASSIGNED = [a for a in list_configs() if a != "chai-llama-7b"]


def eligible_shapes(arch):
    out = []
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and arch in FULL_ATTENTION_ONLY:
            continue
        out.append(s)
    return out


def fake_world(n: int):
    """Make the default process group a fake one of ``n`` ranks (this
    process is rank 0), replacing any other."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if (dist.get_world_size() == n
                and dist.get_backend() == "fake"):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over a fake process group of its
    size, of the ``meta`` device type: its local blocks hold no data, and
    DTensor moves a split from one dim to another by an all-to-all, as on
    the card (a CPU mesh would all-gather instead, gloo having none)."""
    import math
    from repro_torch.launch.mesh import make_mesh
    _register_meta_device()
    fake_world(math.prod(shape))
    return make_mesh(shape, axes, device="meta")


CARDS_PER_HOST = 8      # an HGX H100 node


def _register_meta_device():
    """Give the ``meta`` device type the runtime module DTensor's
    communication cost model asks for (devices a host: an HGX node's
    8), through ``torch._register_device_module``."""
    import types
    if getattr(torch, "meta", None) is None:
        mod = types.ModuleType("repro_torch_meta_device")
        mod.device_count = lambda: CARDS_PER_HOST
        mod.is_available = lambda: True
        torch._register_device_module("meta", mod)


def _bytes(tree):
    from repro_torch.sharding.local import is_dtensor
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return sum(_bytes(v) for v in tree)
    t = tree.to_local() if is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def _args(structs, logical, mesh, shardings=None):
    """Fake DTensors of a struct tree, placed by ``shardings`` (default:
    the rules')."""
    sh = shardings or rules.tree_shardings(structs, logical, mesh)
    return rules.tree_map2(lambda s, h: rules.empty_dtensor(s, h, "meta"),
                           structs, sh), sh


def lower_cell(arch, shape_name, mesh, step_kind, *, unroll=False,
               moe_impl=None, use_ctx=False, cfg=None, shape=None):
    """step_kind: train | train_zero | train_bf16g | train_micro_N |
    prefill | decode_mha | decode_chai (and their ``_i8kv``). ``cfg``
    and ``shape`` (a ``ShapeConfig``) override the arch's config and
    ``SHAPES[shape_name]`` (tests pass reduced ones). Returns the cell's
    record. ``unroll`` changes nothing (see the module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding.context import sharding_ctx
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    t0 = time.time()
    batch_axes = tuple(a for a in ("pod", "data")
                       if a in mesh.mesh_dim_names)
    cm = (sharding_ctx(mesh, batch_axes=batch_axes, model_axis="model")
          if moe_impl == "ep" or use_ctx else contextlib.nullcontext())
    mode = rl.cost_mode()
    args, run = _build(cfg, shape, mesh, step_kind, moe_impl)
    arg_bytes = _bytes(args)
    with cm, implicit_replication(), mode:
        out = run()
        del out
    t_trace = time.time() - t0
    roof = mode.roofline()
    rec = _record(cfg, arch, shape_name, shape, mesh, step_kind, unroll,
                  roof, arg_bytes, arg_bytes + mode.peak, t_trace)
    rec["opaque_calls"] = dict(mode.opaque)
    return rec


def _build(cfg, shape, mesh, step_kind, moe_impl):
    """(the step's arguments as a dict of trees, a callable running the
    step once on them)."""
    pshapes, plog = tfm.param_structs(cfg)
    params, psh = _args(pshapes, plog, mesh)
    kw = dict(moe_impl=moe_impl) if moe_impl else {}
    if step_kind.startswith("train"):
        oshapes, olog = adamw.state_structs(pshapes, plog)
        sk = step_kind
        if "_zero" in sk:       # ZeRO-1: moments data-sharded
            zsh = rules.zero_shardings(pshapes, plog, mesh)
            osh = adamw.AdamWState(
                step=rules.replicated(mesh),
                m=rules.zero_shardings(oshapes.m, olog.m, mesh),
                v=rules.zero_shardings(oshapes.v, olog.v, mesh))
            kw["grad_shardings"] = zsh
            sk = sk.replace("_zero", "")
        else:
            osh = rules.tree_shardings(oshapes, olog, mesh)
        m, _ = _args(oshapes.m, olog.m, mesh, osh.m)
        v, _ = _args(oshapes.v, olog.v, mesh, osh.v)
        # the step counter is a host-known 0 (its schedule reads it)
        opt = adamw.AdamWState(step=torch.tensor(0, dtype=torch.int32),
                               m=m, v=v)
        bshapes, blog = inp.train_input_specs(cfg, shape)
        batch, _ = _args(bshapes, blog, mesh)
        if "_bf16g" in sk:
            kw["grad_dtype"] = "bfloat16"
            sk = sk.replace("_bf16g", "")
        if sk.startswith("train_micro"):
            from repro_torch.train.train_step import \
                make_microbatched_train_step
            kw.pop("grad_shardings", None)
            n_micro = int(sk.rsplit("_", 1)[-1]) if sk[-1].isdigit() else 4
            fn = make_microbatched_train_step(cfg, n_micro=n_micro, **kw)
        else:
            fn = steps_mod.make_train_step(cfg, **kw)
        args = {"params": params, "opt": opt, "batch": batch}
        return args, lambda: fn(params, opt, batch)
    if step_kind == "prefill":
        bshapes, blog = inp.prefill_input_specs(cfg, shape)
        batch, _ = _args(bshapes, blog, mesh)
        sshapes, slog = tfm.decode_state_structs(cfg, shape.global_batch,
                                                 shape.seq_len)
        ssh = rules.tree_shardings(sshapes, slog, mesh)
        fn = steps_mod.make_serve_prefill(cfg, shape.global_batch,
                                          shape.seq_len,
                                          state_shardings=ssh, **kw)
        return {"params": params, "batch": batch}, lambda: fn(params, batch)
    if step_kind.startswith(("decode_mha", "decode_chai")):
        if "i8kv" in step_kind:
            cfg = cfg.replace(kv_cache_dtype="int8")
        chai = step_kind.startswith("decode_chai")
        bshapes, blog = inp.decode_token_specs(cfg, shape)
        batch, _ = _args(bshapes, blog, mesh)
        if chai:
            sshapes, slog = chai_cache.chai_state_structs(
                cfg, shape.global_batch, shape.seq_len)
            cshapes, clog = clustering.ctx_structs(cfg, batch=0)
            ctx, _ = _args(cshapes, clog, mesh)
        else:
            sshapes, slog = tfm.decode_state_structs(
                cfg, shape.global_batch, shape.seq_len)
            ctx = None
        state, _ = _args(sshapes, slog, mesh)
        fn = steps_mod.make_serve_step(cfg, chai=chai, **kw)
        args = {"params": params, "batch": batch, "state": state}
        if ctx is not None:
            args["ctx"] = ctx
        return args, lambda: fn(params, batch, state, ctx)
    raise ValueError(step_kind)


def _record(cfg, arch, shape_name, shape, mesh, step_kind, unroll, roof,
            arg_bytes, peak_bytes, t_trace):
    mf = rl.model_flops(cfg, shape)
    n_dev = mesh.size()
    return {
        "arch": arch, "shape": shape_name, "step": step_kind,
        "unroll": unroll,
        "mesh": "x".join(str(s) for s in tuple(mesh.shape)),
        "n_devices": n_dev,
        "t_trace_s": round(t_trace, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "peak_live_bytes": peak_bytes},
        "roofline": roof.as_dict(),
        "model_flops_total": mf,
        "model_flops_per_dev": mf / n_dev,
        "useful_flop_ratio": (mf / n_dev) / max(roof.flops_per_dev, 1.0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--steps", default="auto",
                    help="auto | comma list of train, train_zero, "
                         "train_bf16g, train_micro_N, prefill, decode_mha, "
                         "decode_chai (each may end in _i8kv for decode)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--ctx", action="store_true",
                    help="activate the sharding context (the layer carry "
                         "pinned to batch-sharded)")
    ap.add_argument("--moe", default="",
                    help="MoE impl override: ep = expert-parallel "
                         "all-to-all dispatch")
    ap.add_argument("--unroll", action="store_true",
                    help="accepted for the reference's CLI; an eager trace "
                         "already counts every layer")
    ap.add_argument("--include-llama", action="store_true",
                    help="also run the paper's chai-llama-7b config")
    args = ap.parse_args(argv)

    mesh = fake_mesh(*production_shape(multi_pod=args.mesh == "multi"))
    os.makedirs(args.out, exist_ok=True)
    suffix = ""
    if args.moe:
        suffix += f"_moe_{args.moe}"
    if args.ctx:
        suffix += "_ctx"
    path = os.path.join(args.out, f"dryrun_{args.mesh}{suffix}.json")
    results = {}
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    archs = (ASSIGNED + (["chai-llama-7b"] if args.include_llama else [])
             if args.arch == "all" else args.arch.split(","))
    for arch in archs:
        cfg = get_config(arch)
        shapes = (eligible_shapes(arch) if args.shape == "all"
                  else args.shape.split(","))
        for shape_name in shapes:
            if args.steps == "auto":
                kind = SHAPES[shape_name].kind
                step_kinds = {"train": ["train"], "prefill": ["prefill"]}.get(
                    kind, ["decode_mha"] + (["decode_chai"]
                                            if cfg.chai.enabled else []))
            else:
                step_kinds = args.steps.split(",")
            for sk in step_kinds:
                key = f"{arch}/{shape_name}/{sk}"
                if key in results and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[trace] {key} on {args.mesh} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, mesh, sk,
                                     unroll=args.unroll,
                                     moe_impl=args.moe or None,
                                     use_ctx=args.ctx)
                    results[key] = rec
                    r = rec["roofline"]
                    print(f"  ok: trace={rec['t_trace_s']}s "
                          f"flops/dev={r['flops_per_dev']:.3e} "
                          f"bytes/dev={r['bytes_per_dev']:.3e} "
                          f"coll/dev={r['coll_bytes_per_dev']:.3e} "
                          f"bottleneck={r['bottleneck']} "
                          f"args={rec['memory']['argument_bytes']/2**30:.2f}"
                          f"GiB peak={rec['memory']['peak_live_bytes']/2**30:.2f}"
                          "GiB", flush=True)
                except Exception as e:  # record failures: they are bugs
                    results[key] = {"arch": arch, "shape": shape_name,
                                    "step": sk, "error": str(e)[:2000],
                                    "traceback":
                                        traceback.format_exc()[-4000:]}
                    print(f"  FAILED: {e}", flush=True)
                with open(path, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for v in results.values() if "error" not in v)
    n_bad = sum(1 for v in results.values() if "error" in v)
    print(f"done: {n_ok} ok, {n_bad} failed -> {path}")
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
