"""The sharding tooling's single-process parts against the reference's,
on the CPU.

* ``spec_for`` / ``zero_spec`` against the reference's over a hypothesis
  sweep of shapes, logical names and mesh shapes (a stand-in mesh of
  axis names and sizes, as the reference's own tests build), and
  ``tree_specs`` over every arch's parameters on both production meshes;
  ``placements_for`` puts a ("pod", "data") group on one tensor dim of
  both mesh dims, pod first.
* Every leaf's logical axes, shape and dtype from ``param_structs``,
  ``decode_state_structs``, ``chai_state_structs``, ``ctx_structs``,
  ``adamw.state_structs`` and ``launch.inputs``, for all eleven archs at
  full size (structs only), exactly the reference's.
* ``model_flops`` equal to the reference's for every arch x ``SHAPES``.
* ``collective_bytes`` on a hand-built trace, and the bottleneck at the
  H100 SXM's constants, as ``tests/test_roofline.py`` holds the
  reference's at its constants.
* FLOPs counted on each rank's local shards: (64,128).(128,256) then
  .(256,128), sharded 4 ways on ``model``, counts 2,097,152 a rank (the
  global shapes would count 8,388,608).
* ``lower_cell`` on reduced configs (1 layer) on a fake 4x4 mesh, at
  small shapes: each cell's per-device argument bytes equal an
  independent count, the sum over the reference's structs of their
  bytes divided by the product of the mesh sizes the reference's
  ``spec_for`` assigns them.
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.launch import inputs as jinputs
from repro.launch import roofline as jrl
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import list_configs
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import roofline as trl
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import rules as trules

ARCHS = list_configs()


class FakeMesh:
    """Axis names and sizes only (no devices), for both packages' rules."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape)
        self.shape = dict(zip(names, shape))


LOGICAL = sorted(trules.DEFAULT_RULES) + [None]
DIMS = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 256]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(DIMS), st.sampled_from(LOGICAL)),
                min_size=0, max_size=5),
       st.sampled_from([1, 2, 4, 16]), st.sampled_from([1, 2, 4, 16]),
       st.sampled_from([0, 1, 2]))
def test_spec_for_and_zero_spec_match_reference(dims, data, model, pods):
    shape = tuple(d for d, _ in dims)
    logical = tuple(n for _, n in dims)
    if pods:
        mesh = FakeMesh((pods, data, model), ("pod", "data", "model"))
    else:
        mesh = FakeMesh((data, model), ("data", "model"))
    ref = jrules.spec_for(shape, logical, mesh)
    got = trules.spec_for(shape, logical, mesh)
    assert tuple(got) == tuple(ref)
    assert tuple(trules.zero_spec(shape, got, mesh)) == tuple(
        jrules.zero_spec(shape, ref, mesh))


@pytest.mark.parametrize("mesh", [FakeMesh((16, 16), ("data", "model")),
                                  FakeMesh((2, 16, 16),
                                           ("pod", "data", "model"))],
                         ids=["single", "multi"])
def test_tree_specs_every_arch(mesh):
    for arch in ARCHS:
        js, jl = jtfm.param_structs(jget_config(arch))
        ts, tl = ttfm.param_structs(get_config(arch))
        ref = jrules.tree_specs(js, jl, mesh)
        got = trules.tree_specs(ts, tl, mesh)
        assert {g: {n: tuple(s) for n, s in grp.items()}
                for g, grp in got.items()} == {
            g: {n: tuple(s) for n, s in grp.items()}
            for g, grp in ref.items()}, arch


def test_placements_pod_major_group():
    from torch.distributed.tensor import Replicate, Shard

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 4, 8)
    spec = trules.spec_for((16, 8), ("batch", "heads"), Named())
    assert tuple(spec) == (("pod", "data"), "model")
    assert trules.placements_for(spec, Named()) == (Shard(0), Shard(0),
                                                    Shard(1))
    assert trules.placements_for(trules.Spec(), Named()) == (Replicate(),) * 3


# --------------------------------------------------------------- structs ----
def _jflat(shapes, logical, prefix=""):
    """{path: (shape, dtype name, logical names)} of a reference tree."""
    if isinstance(shapes, dict):
        out = {}
        for k in shapes:
            out.update(_jflat(shapes[k], logical[k], f"{prefix}{k}/"))
        return out
    if isinstance(shapes, tuple) and hasattr(shapes, "_fields"):
        out = {}
        for f in shapes._fields:
            out.update(_jflat(getattr(shapes, f), getattr(logical, f),
                              f"{prefix}{f}/"))
        return out
    return {prefix: (tuple(shapes.shape), jnp.dtype(shapes.dtype).name,
                     logical.names)}


def _tflat(shapes, logical, prefix=""):
    if isinstance(shapes, dict):
        out = {}
        for k in shapes:
            out.update(_tflat(shapes[k], logical[k], f"{prefix}{k}/"))
        return out
    if isinstance(shapes, tuple) and not isinstance(shapes, trules.Struct):
        out = {}
        for f in shapes._fields:
            out.update(_tflat(getattr(shapes, f), getattr(logical, f),
                              f"{prefix}{f}/"))
        return out
    return {prefix: (tuple(shapes.shape),
                     str(shapes.dtype).replace("torch.", ""),
                     logical.names)}


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_match_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    pairs = [(jtfm.param_structs(jcfg), ttfm.param_structs(tcfg))]
    pj, pt = pairs[0]
    pairs.append((jadamw.state_structs(*pj), tadamw.state_structs(*pt)))
    variants = [(jcfg, tcfg)]
    if tcfg.n_global_layers:
        variants.append((jcfg.replace(kv_cache_dtype="int8"),
                         tcfg.replace(kv_cache_dtype="int8")))
    if arch == "chai-llama-7b":
        variants.append((jcfg.with_chai(share_values=True),
                         tcfg.with_chai(share_values=True)))
    for jc, tc in variants:
        pairs.append((jtfm.decode_state_structs(jc, 4, 96),
                      ttfm.decode_state_structs(tc, 4, 96)))
        pairs.append((jcache.chai_state_structs(jc, 4, 96),
                      tcache.chai_state_structs(tc, 4, 96)))
    if tcfg.chai.enabled and tcfg.n_attn_layers:
        for b in (0, 4):
            pairs.append((jclust.ctx_structs(jcfg, batch=b),
                          tclust.ctx_structs(tcfg, batch=b)))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for fn in ("train_input_specs", "prefill_input_specs",
                   "decode_token_specs"):
            pairs.append((getattr(jinputs, fn)(jcfg, JSHAPES[name]),
                          getattr(tinputs, fn)(tcfg, SHAPES[name])))
    for (js, jl), (ts, tl) in pairs:
        assert _tflat(ts, tl) == _jflat(js, jl), arch


def test_model_flops_match_reference():
    for arch in ARCHS:
        for name in SHAPES:
            assert trl.model_flops(get_config(arch), SHAPES[name]) == \
                jrl.model_flops(jget_config(arch), JSHAPES[name])
    assert SHAPES == {k: ShapeConfig(*(getattr(v, f) for f in (
        "name", "seq_len", "global_batch", "kind")))
        for k, v in JSHAPES.items()}


# ------------------------------------------------------------- roofline ----
def test_collective_bytes_from_a_trace():
    trace = [
        ("_c10d_functional.all_reduce", 256 * 1024 * 2, 256 * 1024 * 2),
        ("_c10d_functional.all_gather_into_tensor", 256 * 64 * 4,
         512 * 64 * 4),
        ("_c10d_functional.reduce_scatter_tensor", 256 * 4, 128 * 4),
        ("_c10d_functional.broadcast", 100, 100),
        ("_c10d_functional.all_to_all_single", 16 * 16 * 2, 16 * 16 * 2),
        ("_dtensor.shard_dim_alltoall", 64, 64),
        ("_c10d_functional.wait_tensor", 512 * 64 * 4, 512 * 64 * 4),
        ("aten.mm", 10, 10),
    ]
    total, kinds, n = trl.collective_bytes(trace)
    assert kinds["all-reduce"] == 256 * 1024 * 2
    assert kinds["all-gather"] == 512 * 64 * 4
    assert kinds["reduce-scatter"] == 256 * 4
    assert kinds["collective-permute"] == 100
    assert kinds["all-to-all"] == 16 * 16 * 2 + 64
    assert n == 6                       # a wait is not a second transfer
    assert total == sum(kinds.values())


def test_roofline_bottleneck_h100():
    assert (trl.PEAK_FLOPS, trl.HBM_BW, trl.LINK_BW) == (989e12, 3.35e12,
                                                          450e9)
    r = trl.Roofline(989e12, 1.0, 1.0, {}, 0)
    assert r.bottleneck == "compute" and r.t_compute == pytest.approx(1.0)
    assert trl.Roofline(1.0, 3.35e12, 1.0, {}, 0).bottleneck == "memory"
    r3 = trl.Roofline(1.0, 1.0, 450e9, {}, 0)
    assert r3.bottleneck == "collective"
    assert r3.t_max == pytest.approx(1.0)


# ------------------------------------------------- fake-mesh dry runs ----
@pytest.fixture()
def fake4():
    """A fake 4-rank process group and a (model,) meta mesh over it (the
    dry-run's), torn down after."""
    if dist.is_initialized():
        pytest.fail("a process group is already initialised")
    from repro_torch.launch import dryrun
    yield dryrun.fake_mesh((4,), ("model",))
    dist.destroy_process_group()


def test_flops_counted_on_local_shards(fake4):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    mesh = fake4

    def dt(shape, pl):
        loc = list(shape)
        if pl.is_shard():
            loc[pl.dim] //= 4
        return DTensor.from_local(torch.empty(loc, device="meta"), mesh,
                                  [pl], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=(shape[1], 1))
    x = dt((64, 128), Replicate())
    w1, w2 = dt((128, 256), Shard(1)), dt((256, 128), Shard(0))
    mode = trl.cost_mode()
    with mode:
        y = (x @ w1) @ w2
    assert mode.flops == 2_097_152
    with FlopCounterMode(display=False) as fc:     # the global-shape count
        (x @ w1) @ w2
    assert fc.get_total_flops() == 8_388_608
    assert y.placements[0].is_partial()


def test_collective_wrappers_move_no_bytes(fake4):
    """A gather to ``Replicate`` counts its all-gather as a collective
    and no local bytes (its wait and autograd wrapper are not copies);
    gathering a split on dim 1 adds the re-layout DTensor makes of the
    gathered chunks (a ``cat``: read and written once)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = fake4
    n = 64 * 32 * 4
    for dim, want in ((0, 0), (1, 2 * n)):
        loc = [64, 32]
        loc[dim] //= 4
        x = DTensor.from_local(torch.empty(loc, device="meta"), mesh,
                               [Shard(dim)], run_check=False,
                               shape=torch.Size((64, 32)), stride=(32, 1))
        mode = trl.cost_mode()
        with mode:
            x.redistribute(mesh, [Replicate()]).to_local()
        total, kinds, count = trl.collective_bytes(mode.trace)
        assert (count, kinds["all-gather"]) == (1, n)
        assert mode.bytes == want, dim


def _ref_arg_bytes(jcfg, shape, kind, mesh):
    """Sum over the reference's structs of bytes / the product of the
    mesh sizes its ``spec_for`` (or ``zero_spec``) assigns them."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))

    def split(spec):
        return math.prod(sizes[a] for e in spec if e
                         for a in ((e,) if isinstance(e, str) else e))

    def total(shapes, logical, zero=False):
        flat = _jflat(shapes, logical)
        out = 0
        for shp, dtype, names in flat.values():
            spec = jrules.spec_for(shp, names, mesh)
            if zero:
                spec = jrules.zero_spec(shp, spec, mesh)
            out += (math.prod(shp) * jnp.dtype(dtype).itemsize
                    // split(spec))
        return out
    ps, pl = jtfm.param_structs(jcfg)
    n = total(ps, pl)
    if kind.startswith("train"):
        os_, ol = jadamw.state_structs(ps, pl)
        zero = "zero" in kind
        n += total(os_.step, ol.step)
        n += total(os_.m, ol.m, zero) + total(os_.v, ol.v, zero)
        n += total(*jinputs.train_input_specs(jcfg, shape))
    elif kind == "prefill":
        n += total(*jinputs.prefill_input_specs(jcfg, shape))
    else:
        n += total(*jinputs.decode_token_specs(jcfg, shape))
        if kind == "decode_chai":
            n += total(*jcache.chai_state_structs(jcfg, shape.global_batch,
                                                  shape.seq_len))
            n += total(*jclust.ctx_structs(jcfg, batch=0))
        else:
            n += total(*jtfm.decode_state_structs(jcfg, shape.global_batch,
                                                  shape.seq_len))
    return n


CELLS = [
    ("chai-llama-7b", "train_zero", "", 64),
    ("chai-llama-7b", "decode_chai", "", 64),
    ("deepseek-moe-16b", "train", "ep", 64),
    ("gemma2-9b", "decode_mha", "", 64),
    ("rwkv6-1.6b", "prefill", "", 64),
]
CELL = r"""
import json, sys
from repro_torch.configs.base import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
arch, kind, moe, seq = sys.argv[1], sys.argv[2], sys.argv[3] or None, int(sys.argv[4])
skind = ("train" if kind.startswith("train") else
         "prefill" if kind == "prefill" else "decode")
mesh = dryrun.fake_mesh((4, 4), ("data", "model"))
rec = dryrun.lower_cell(arch, "t", mesh, kind, moe_impl=moe,
                        cfg=reduced(get_config(arch), n_layers=1),
                        shape=ShapeConfig("t", seq, 16, skind))
print("RECORD " + json.dumps(rec))
"""


@pytest.fixture(scope="module", autouse=True)
def dry_cells():
    """The five dry-run cells, each traced in a process of its own (a
    fake process group there), started when the module starts so they
    run beside its other tests."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = {c: subprocess.Popen([sys.executable, "-c", CELL, c[0], c[1],
                                  c[2], str(c[3])], env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
             for c in CELLS}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("cell", CELLS, ids=[f"{a}-{k}{'-' + m if m else ''}"
                                             for a, k, m, _ in CELLS])
def test_lower_cell_argument_bytes(dry_cells, cell):
    import json
    arch, kind, moe, seq = cell
    out, _ = dry_cells[cell].communicate(timeout=180)
    out = out.decode(errors="replace")
    assert dry_cells[cell].returncode == 0, out[-3000:]
    rec = json.loads(out.split("RECORD ", 1)[1])
    skind = ("train" if kind.startswith("train") else
             "prefill" if kind == "prefill" else "decode")
    jcfg = jreduced(jget_config(arch), n_layers=1)
    jshape = type(JSHAPES["train_4k"])("t", seq, 16, skind)
    want = _ref_arg_bytes(jcfg, jshape, kind,
                          FakeMesh((4, 4), ("data", "model")))
    assert rec["memory"]["argument_bytes"] == want
    r = rec["roofline"]
    assert r["flops_per_dev"] > 0 and r["bottleneck"] in (
        "compute", "memory", "collective")
    assert rec["memory"]["peak_live_bytes"] >= want
    if moe == "ep":
        assert r["coll_breakdown"]["all-to-all"] > 0
    if kind == "decode_chai":     # the kernel as one opaque call a layer
        assert rec["opaque_calls"] == {"chai_fused_decode": 1}


def test_decode_kernels_counted_as_opaque_calls():
    """On ``meta`` tensors the decode kernels answer with empty outputs of
    their shapes, and the cost mode counts each as XLA counts a custom
    call: operands plus outputs, FLOPs from the shapes, nothing of the
    plain version's inner ops (its fp32 upcasts of the cache). Outside
    the cost mode a ``meta`` tensor still goes to the kernel, which
    refuses its device."""
    from repro_torch.kernels import ops as kops
    b, h, r, s, hd = 2, 8, 3, 128, 64
    meta = dict(device="meta")
    q = torch.empty(b, h, hd, dtype=torch.bfloat16, **meta)
    kc = torch.empty(b, h, s, hd, dtype=torch.bfloat16, **meta)
    pos = torch.empty(b, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kops.flash_decode_attention(q, kc, kc, pos, window=32)
    mode = trl.cost_mode()
    with mode:
        y = kops.flash_decode_attention(q, kc, kc, pos, window=32)
    assert y.shape == (b, h, hd) and y.dtype == torch.float32
    nb = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    assert mode.bytes == nb(q, kc, kc, pos, y)
    assert mode.flops == 4 * b * h * 32 * hd
    assert mode.opaque == {"flash_decode": 1} and mode.trace == []
    qr = torch.empty(b, r, hd, dtype=torch.bfloat16, **meta)
    kr = torch.empty(b, r, s, hd, dtype=torch.bfloat16, **meta)
    h2c = torch.empty(b, h, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        kops.chai_decode_attention(qr, kr, kc, h2c, pos)
    mode = trl.cost_mode()
    with mode:
        y = kops.chai_decode_attention(qr, kr, kc, h2c, pos)
    assert y.shape == (b, h, hd) and y.dtype == torch.float32
    assert mode.bytes == nb(qr, kr, kc, h2c, pos, y)
    assert mode.flops == 2 * b * r * s * hd + 2 * b * h * s * hd
    assert mode.opaque == {"chai_fused_decode": 1}
