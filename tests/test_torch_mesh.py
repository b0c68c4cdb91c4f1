"""The sharding tooling on a real 4-rank mesh, on the CPU: the port's
DTensor paths against the reference's on a forced 4-device jax mesh.

One module fixture runs, side by side and with a timeout (a hung rank
fails the test instead of stalling the suite):
* one jax subprocess (``--xla_force_host_platform_device_count=4``) that
  computes every reference value from the same numpy inputs;
* four port ranks, each its own process, in a gloo group on a
  ``FileStore`` in ``tmp_path``, one thread each.

Held (tolerances and why):
* ``moe_ffn_ep`` on a 2x2 (data, model) mesh at capacity factor 0.5
  (rows drop: the output moves by ~3.8 against a dropless call) against
  the reference's ``moe_ffn_ep``: output at 1e-5 (fp32, two orders of
  summation), the auxiliary losses at 1e-5.
* a sharded loss of reduced chai-llama-7b (2 layers, fp32) on the 2x2
  mesh, at 1e-5 of the reference's;
* one ZeRO train step (moments and gradients split on the data axis):
  every parameter at 1e-5, the loss and grad norm at 1e-5;
* the int8 cross-pod step on a (2, 1, 2) (pod, data, model) mesh: the
  parameters at 1e-5 and the loss at 1e-5. The residual: an element
  whose quantized value sits at a rounding edge can take the
  neighbouring code on one side (the two sides' gradients differ in the
  last bits), which moves its residual by one code's scale (twice the
  largest residual of the leaf); every other element at 1e-5, and at
  most 0.1% of a leaf's elements (plus one) may take the other code.
* sharded restore on the pod mesh: each rank's block of a head-split
  weight, a vocab-split table and a batch split over ("pod", "data")
  equal (exactly) to the block the reference's restore gives the device
  at the same mesh coordinate;
* each rank's batch from ``global_batch_array`` equal (exactly) to the
  reference's ``batch(index, host_id, n_hosts)`` for the rank's block.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
TOL = dict(rtol=0, atol=1e-5)

REFERENCE = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
jax.config.update("jax_default_matmul_precision", "highest")
out_dir = sys.argv[1]
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
from repro.configs.base import get_config, reduced
from repro.launch.mesh import make_mesh
from repro.sharding import rules
from repro.sharding.context import sharding_ctx
from repro.models import moe, transformer as tfm
from repro.launch import steps
from repro.optim import adamw
res = {}
def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            g, n = k[len(prefix):].split(".")
            t.setdefault(g, {})[n] = jnp.asarray(v)
    return t
# (a) moe_ffn_ep on a 2x2 mesh, rows dropping
mcfg = reduced(get_config("deepseek-moe-16b"), n_layers=2).replace(capacity_factor=0.5)
mp = {k[4:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("moe.")}
x = jnp.asarray(inp["moe_x"])
mesh = make_mesh((2, 2), ("data", "model"))
with sharding_ctx(mesh, batch_axes=("data",)) as ctx:
    y, aux = jax.jit(lambda x, p: moe.moe_ffn_ep(x, p, mcfg, ctx, return_aux=True))(x, mp)
res["moe_y"] = np.asarray(y); res["moe_lb"] = np.asarray(aux["load_balance"]); res["moe_z"] = np.asarray(aux["router_z"])
res["moe_nodrop"] = np.asarray(moe.moe_ffn(x, mp, mcfg.replace(capacity_factor=8.0)))
# (b) sharded loss, (c) ZeRO step on 2x2
cfg = reduced(get_config("chai-llama-7b"), n_layers=2).replace(dtype="float32")
params = tree("p.")
pshapes, plog = tfm.param_structs(cfg)
psh = rules.tree_shardings(pshapes, plog, mesh)
batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
bsh = {k: rules.sharding_for(v.shape, ("batch", None), mesh) for k, v in batch.items()}
loss_fn = steps.make_loss_fn(cfg, remat=False)
loss, _ = jax.jit(loss_fn, in_shardings=(psh, bsh))(params, batch)
res["loss"] = np.asarray(loss)
oshapes, olog = adamw.state_structs(pshapes, plog)
osh = adamw.AdamWState(step=NamedSharding(mesh, P()),
                       m=rules.zero_shardings(oshapes.m, olog.m, mesh),
                       v=rules.zero_shardings(oshapes.v, olog.v, mesh))
zsh = rules.zero_shardings(pshapes, plog, mesh)
step = steps.make_train_step(cfg, remat=False, grad_shardings=zsh)
opt = adamw.init(params)
p2, o2, m2 = jax.jit(step, in_shardings=(psh, osh, bsh))(params, opt, batch)
for g, grp in p2.items():
    for n, v in grp.items():
        res[f"zero.{g}.{n}"] = np.asarray(v)
res["zero_loss"] = np.asarray(m2["loss"]); res["zero_gnorm"] = np.asarray(m2["grad_norm"])
# (d) compressed step on a (2,1,2) pod mesh
from repro.train.train_step import make_compressed_train_step
from repro.optim import compression
pmesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
cstep = make_compressed_train_step(cfg, pmesh, remat=False)
ppsh = rules.tree_shardings(pshapes, plog, pmesh)
cparams = jax.device_put(params, ppsh)
cres = compression.compress_residual_init(params)
cbatch = {k: jax.device_put(v, rules.sharding_for(v.shape, ("batch", None), pmesh)) for k, v in batch.items()}
p3, o3, r3, m3 = jax.jit(cstep)(cparams, adamw.init(cparams), cres, cbatch)
for g, grp in p3.items():
    for n, v in grp.items():
        res[f"comp.{g}.{n}"] = np.asarray(v)
        res[f"compres.{g}.{n}"] = np.asarray(r3[g][n])
res["comp_loss"] = np.asarray(m3["loss"])
# (e) sharded restore: a checkpoint written here, each device's block
from repro.checkpoint.checkpoint import CheckpointManager
ck = {"params": params, "tokens": batch["tokens"]}
CheckpointManager(os.path.join(out_dir, "ckpt")).save(1, ck)
csh = {"params": ppsh, "tokens": rules.sharding_for(batch["tokens"].shape, ("batch", None), pmesh)}
rt, _ = CheckpointManager(os.path.join(out_dir, "ckpt")).restore(1, ck, shardings=csh)
devs = list(pmesh.devices.flat)
for name, arr in (("wq", rt["params"]["attn"]["wq"]), ("tokens", rt["tokens"]), ("tok", rt["params"]["embed"]["tok"])):
    for sh in arr.addressable_shards:
        res[f"restore.{name}.{devs.index(sh.device)}"] = np.asarray(sh.data)
# (f) per-rank batches
from repro.data.pipeline import DataConfig, SyntheticPipeline
pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=3))
for n in (2, 4):
    for h in range(n):
        res[f"batch.{n}.{h}"] = pipe.batch(5, host_id=h, n_hosts=n)["tokens"]
np.savez(os.path.join(out_dir, "ref.npz"), **res)
print("ref done")
'''

PORT = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist


def rank_main(rank, world, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import rules
    from repro_torch.sharding.context import sharding_ctx
    from repro_torch.models import moe, transformer as tfm
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, compression
    from repro_torch.train.train_step import make_compressed_train_step
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    res = {}

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()

    def tree(prefix):
        t = {}
        for k, v in inp.items():
            if k.startswith(prefix):
                g, n = k[len(prefix):].split(".")
                t.setdefault(g, {})[n] = torch.from_numpy(v)
        return t
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    # (a)
    mcfg = reduced(get_config("deepseek-moe-16b"), n_layers=2).replace(capacity_factor=0.5)
    mp = {k[4:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("moe.")}
    x = torch.from_numpy(inp["moe_x"])
    with sharding_ctx(mesh, batch_axes=("data",)) as ctx, implicit_replication():
        y, aux = moe.moe_ffn_ep(x, mp, mcfg, ctx, return_aux=True)
    res["moe_y"] = full(y); res["moe_lb"] = full(aux["load_balance"]); res["moe_z"] = full(aux["router_z"])
    # (b), (c)
    cfg = reduced(get_config("chai-llama-7b"), n_layers=2).replace(dtype="float32")
    params = tree("p.")
    pshapes, plog = tfm.param_structs(cfg)
    psh = rules.tree_shardings(pshapes, plog, mesh)
    dparams = rules.place_tree(params, psh)
    batch = {k: torch.from_numpy(inp[k]).long() for k in ("tokens", "labels")}
    bsh = {k: rules.sharding_for(tuple(v.shape), ("batch", None), mesh) for k, v in batch.items()}
    dbatch = rules.place_tree(batch, bsh)
    with implicit_replication():
        loss, _ = steps.make_loss_fn(cfg, remat=False)(dparams, dbatch)
    res["loss"] = full(loss)
    oshapes, olog = adamw.state_structs(pshapes, plog)
    zm = rules.zero_shardings(oshapes.m, olog.m, mesh)
    opt = adamw.init(dparams)
    opt = adamw.AdamWState(step=opt.step, m=rules.place_tree(opt.m, zm),
                           v=rules.place_tree(opt.v, zm))
    step = steps.make_train_step(cfg, remat=False,
                                 grad_shardings=rules.zero_shardings(pshapes, plog, mesh))
    with implicit_replication():
        p2, o2, m2 = step(dparams, opt, dbatch)
    for g, grp in p2.items():
        for n, v in grp.items():
            res[f"zero.{g}.{n}"] = full(v)
            assert v.placements == dparams[g][n].placements
    res["zero_loss"] = full(m2["loss"]); res["zero_gnorm"] = full(m2["grad_norm"])
    res["zero_m_placements"] = np.array(str(o2.m["attn"]["wq"].placements))
    # (d)
    pmesh = make_mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    ppsh = rules.tree_shardings(pshapes, plog, pmesh)
    cparams = rules.place_tree(params, ppsh)
    cbatch = {k: rules.place(v, rules.sharding_for(tuple(v.shape), ("batch", None), pmesh)) for k, v in batch.items()}
    cstep = make_compressed_train_step(cfg, pmesh, remat=False)
    with implicit_replication():
        p3, o3, r3, m3 = cstep(cparams, adamw.init(cparams), compression.compress_residual_init(cparams), cbatch)
    for g, grp in p3.items():
        for n, v in grp.items():
            res[f"comp.{g}.{n}"] = full(v)
            res[f"compres.{g}.{n}"] = full(r3[g][n])
    res["comp_loss"] = full(m3["loss"])
    # (e)
    ck = {"params": params, "tokens": batch["tokens"].int()}
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt_port"))
    mgr.save(1, ck)
    csh = {"params": ppsh, "tokens": rules.sharding_for(tuple(batch["tokens"].shape), ("batch", None), pmesh)}
    rt, _ = mgr.restore(1, ck, device="cpu", shardings=csh)
    res["restore.wq"] = rt["params"]["attn"]["wq"].to_local().numpy()
    res["restore.tok"] = rt["params"]["embed"]["tok"].to_local().numpy()
    res["restore.tokens"] = rt["tokens"].to_local().numpy()
    # (f)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8, seed=3))
    for shape in ((2, 2), (4, 1)):
        m_ = mesh if shape == (2, 2) else make_mesh(shape, ("data", "model"), device="cpu")
        sh = rules.sharding_for((8, 16), ("batch", None), m_)
        b = pipe.global_batch_array(5, {"tokens": sh, "labels": sh})
        res[f"batch.{shape[0]}"] = b["tokens"].to_local().numpy()
        res[f"batch.{shape[0]}.coord"] = np.array(m_.get_coordinate())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()



rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
'''


def _inputs(out_dir):
    """Seeded numpy inputs both sides read: reduced chai-llama-7b
    parameters (2 layers, fp32), a batch, one MoE layer of reduced
    deepseek-moe-16b and its input."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(0)
    d = {}
    cfg = reduced(get_config("chai-llama-7b"), n_layers=2).replace(
        dtype="float32")
    for g, grp in tfm.param_table(cfg).items():
        for n, (shape, _, scale) in grp.items():
            d[f"p.{g}.{n}"] = (rng.normal(size=shape)
                               * (scale or 0.1)).astype(np.float32)
    d["tokens"] = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    d["labels"] = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    mcfg = reduced(get_config("deepseek-moe-16b"), n_layers=2)
    for n, (shape, _, scale) in tfm.param_table(mcfg)["moe"].items():
        if n != "ln":
            d[f"moe.{n}"] = (rng.normal(size=shape[1:])
                             * scale).astype(np.float32)
    d["moe_x"] = rng.normal(size=(4, 64, mcfg.d_model)).astype(np.float32)
    np.savez(out_dir / "inputs.npz", **d)


def _env():
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    _inputs(out)
    env = _env()
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)]
    procs += [subprocess.Popen([sys.executable, "-c", PORT, str(r), "4",
                                str(out)], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT)
              for r in range(4)]
    deadline = time.time() + TIMEOUT_S
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            logs.append(log.decode(errors="replace")[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ref = dict(np.load(out / "ref.npz"))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return ref, ranks


def test_moe_ffn_ep_drops_rows_like_the_reference(results):
    ref, ranks = results
    assert np.abs(ref["moe_y"] - ref["moe_nodrop"]).max() > 0.1
    for r in ranks:        # every rank holds the same gathered output
        np.testing.assert_allclose(r["moe_y"], ref["moe_y"], **TOL)
        np.testing.assert_allclose(r["moe_lb"], ref["moe_lb"], **TOL)
        np.testing.assert_allclose(r["moe_z"], ref["moe_z"], **TOL)


def test_sharded_loss(results):
    ref, ranks = results
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], **TOL)


def test_zero_train_step(results):
    ref, ranks = results
    keys = [k for k in ref if k.startswith("zero.")]
    assert keys
    for r in ranks:
        for k in keys:
            np.testing.assert_allclose(r[k], ref[k], err_msg=k, **TOL)
        np.testing.assert_allclose(r["zero_loss"], ref["zero_loss"], **TOL)
        np.testing.assert_allclose(r["zero_gnorm"], ref["zero_gnorm"],
                                   **TOL)
    # the moments live on the ZeRO layout: the data axis splits a dim
    assert "Shard" in str(ranks[0]["zero_m_placements"]).split(",")[0]


def test_compressed_cross_pod_step(results):
    ref, ranks = results
    r0 = ranks[0]           # pod 0's residual, as the reference returns it
    for k in [k for k in ref if k.startswith("comp.")]:
        np.testing.assert_allclose(r0[k], ref[k], err_msg=k, **TOL)
    np.testing.assert_allclose(r0["comp_loss"], ref["comp_loss"], **TOL)
    for k in [k for k in ref if k.startswith("compres.")]:
        d = np.abs(r0[k] - ref[k])
        code = 2.0 * np.abs(ref[k]).max()
        flipped = d > TOL["atol"]
        assert np.all(d[flipped] <= code * 1.0001 + TOL["atol"]), k
        assert flipped.sum() <= 0.001 * d.size + 1, (k, flipped.sum())


def test_sharded_restore_blocks(results):
    ref, ranks = results
    for i, r in enumerate(ranks):
        for name in ("wq", "tok", "tokens"):
            a, b = r[f"restore.{name}"], ref[f"restore.{name}.{i}"]
            assert a.shape == b.shape and np.array_equal(a, b), (i, name)


def test_per_rank_batches(results):
    ref, ranks = results
    for i, r in enumerate(ranks):
        data = int(r["batch.2.coord"][0])       # the rank's batch block
        assert np.array_equal(r["batch.2"], ref[f"batch.2.{data}"])
        assert np.array_equal(r["batch.4"], ref[f"batch.4.{i}"])
