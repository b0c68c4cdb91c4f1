"""The port's training stack against the JAX package's, on the CPU, fp32
unless named: ``optim.adamw``, ``optim.compression``, the loss and train
steps (``launch.steps``, ``train.train_step``), the training forward's
backward, and the data pipeline.

Held:
* ``cosine_lr`` and ``update``'s ``lr`` and ``step`` bitwise against the
  reference's jitted ones (as its trainer runs them); params and moments
  at ``ADAM_TOL`` for fp32 parameters; bf16 parameters, updated in fp32
  and cast back, equal but where the two fp32 values round to
  neighbouring bf16 values (one bf16 step, on a few elements).
* The quantizer's codes and scale bitwise; ``compressed_psum`` on a
  size-1 gloo group (a file store, no network) bitwise against the
  reference's single-pod shard_map.
* The loss and every gradient leaf of ``jax.value_and_grad(loss_fn)``
  against autograd, with and without remat, on reduced chai-llama-7b
  (MHA), deepseek-moe-16b (capacity MoE with its auxiliary losses),
  recurrentgemma-9b (the RG-LRU scan) and rwkv6-1.6b (the chunked time
  mix, two chunks), 2 layers, 2 x 64 tokens: each leaf at
  ``GRAD_TOL[arch]`` of its largest reference entry. Inside the port,
  remat changes no gradient bit.
* Two microbatches against the fused step inside the port, and against
  the reference's microbatched step.
* The pipeline's tables, batches, host slices and calibration batches
  bit for bit.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data import pipeline as jpipe
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import train_step as jts
from repro_torch.configs.base import get_config, reduced
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.train import train_step as tts
from repro_torch.weights import params_from_numpy

GRAD_ARCHS = ("chai-llama-7b", "deepseek-moe-16b", "recurrentgemma-9b",
              "rwkv6-1.6b")
# Each gradient leaf's max abs difference over its max abs reference
# entry. The RWKV time mix sums products whose factored decays reach
# exp(+-48) inside a chunk, so its rounding differs between the packages
# by ~4e-5 of a leaf's largest entry; the others stay under 4e-6.
GRAD_TOL = {"chai-llama-7b": 1e-5, "deepseek-moe-16b": 1e-5,
            "recurrentgemma-9b": 1e-5, "rwkv6-1.6b": 1e-4}
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)


def _np(x):
    return np.asarray(x.detach().float()) if torch.is_tensor(x) else (
        np.asarray(x, np.float32))


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _numpy_params(tcfg, seed):
    """Seeded numpy weights of ``param_table``'s shapes at its init
    scales (zero-init leaves at 0.1, so they act), as jnp arrays."""
    rng = np.random.default_rng(seed)
    return {g: {n: jnp.asarray((rng.normal(size=shape)
                                * (scale or 0.1)).astype(np.float32))
                for n, (shape, _, scale) in grp.items()}
            for g, grp in ttfm.param_table(tcfg).items()}


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jreduced(jget_config(arch), n_layers=2).replace(dtype="float32")
    tcfg = reduced(get_config(arch), n_layers=2).replace(dtype="float32")
    jparams = _numpy_params(tcfg, 1)
    return jcfg, tcfg, jparams, _port(jparams)


def _batch(cfg, seed=0, b=2, t=64):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(
        np.int32)}
    if cfg.frontend != "none":
        batch["embeddings"] = rng.normal(size=(b, t, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, t)).astype(
            np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# --------------------------------------------------------------- adamw ----
def _adam_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (16, 8), "b": (8,)}, "z": {"s": (3, 5, 4)}}
    params = {g: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in grp.items()} for g, grp in shapes.items()}
    grads = [{g: {n: (rng.normal(size=s) * 3.0).astype(np.float32)
                  for n, s in grp.items()} for g, grp in shapes.items()}
             for _ in range(3)]
    jdt = jnp.dtype(dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    jg = [jax.tree.map(lambda a: jnp.asarray(a, jdt), g) for g in grads]
    return jp, jg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """Three jitted reference steps (the default schedule) against the
    port's: step and lr bitwise, grad norm at 1e-6, moments at
    ``ADAM_TOL``; fp32 params at ``ADAM_TOL``, bf16 params at most one
    bf16 step apart, on few elements."""
    jp, jgs = _adam_inputs(dtype)
    tp = _port(jp)
    jopt, topt = jadamw.init(jp), tadamw.init(tp)
    upd = jax.jit(jadamw.update)
    for jg in jgs:
        jp, jopt, jm = upd(jg, jopt, jp)
        tp, topt, tm = tadamw.update(_port(jg), topt, tp)
        assert topt.step.dtype == torch.int32 and topt.step.ndim == 0
        assert int(topt.step) == int(jopt.step)
        assert np.asarray(jm["lr"]).tobytes() == tm["lr"].numpy().tobytes()
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for jtree, ttree in ((jopt.m, topt.m), (jopt.v, topt.v)):
            for g in jtree:
                for n in jtree[g]:
                    assert ttree[g][n].dtype == torch.float32
                    np.testing.assert_allclose(_np(ttree[g][n]),
                                               np.asarray(jtree[g][n]),
                                               **ADAM_TOL)
        for g in jp:
            for n in jp[g]:
                got, want = tp[g][n], np.asarray(jp[g][n])
                if dtype == "float32":
                    np.testing.assert_allclose(_np(got), want, **ADAM_TOL)
                    continue
                assert got.dtype == torch.bfloat16
                a = got.view(torch.int16).numpy().astype(np.int32)
                b = want.view(np.int16).astype(np.int32)
                assert np.abs(a - b).max() <= 1, (g, n)
                assert np.mean(a != b) <= 0.02, (g, n)


@pytest.mark.parametrize("kw", [
    dict(), dict(peak=3e-3, warmup=6, total=60), dict(total=30, warmup=3),
    dict(peak=1e-3, warmup=7, total=70)], ids=["default", "system", "t30",
                                               "t70"])
def test_cosine_lr_bitwise(kw):
    """The schedule at every step of its range (the default's first 400
    and a few late ones) bit for bit against the jitted reference."""
    total = kw.get("total", 10000)
    steps = (list(range(400)) + [4999, 9998, 9999, 10000, 10005]
             if total == 10000 else range(total + 3))
    fn = jax.jit(functools.partial(jadamw.cosine_lr, **kw))
    for s in steps:
        want = np.asarray(fn(jnp.int32(s)))
        got = tadamw.cosine_lr(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), (s, got, want)


def test_global_norm_matches_reference():
    jp, _ = _adam_inputs("float32", seed=3)
    np.testing.assert_allclose(float(tadamw.global_norm(_port(jp))),
                               float(jadamw.global_norm(jp)), rtol=1e-6)


def test_adamw_decreases_loss_quadratic():
    """AdamW on a convex quadratic reaches near-zero (the reference's
    test, on the port)."""
    w = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = tadamw.init(w)
    for _ in range(200):
        g = {"w": 2.0 * w["w"]}
        w, opt, _ = tadamw.update(g, opt, w, lr=0.1, weight_decay=0.0)
    assert float(torch.sum(torch.square(w["w"]))) < 1e-2


# --------------------------------------------------------- compression ----
def test_quantize_matches_reference(rng):
    g = rng.normal(size=(64, 32)).astype(np.float32)
    jq, js = jcomp._quantize(jnp.asarray(g))
    tq, ts = tcomp._quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    err = np.abs(tcomp._dequantize(tq, ts).numpy() - g)
    assert err.max() <= float(ts) / 2 + 1e-7   # half a step of the grid


def test_error_feedback_accumulates_unbiased(rng):
    """The running mean of dequantized outputs, with the quantization
    error fed back, converges to the true gradient."""
    g = torch.from_numpy((rng.normal(size=(128,)) * 1e-3).astype(
        np.float32))
    r = torch.zeros_like(g)
    outs = []
    for _ in range(64):
        gin = g + r
        q, s = tcomp._quantize(gin)
        deq = tcomp._dequantize(q, s)
        r = gin - deq
        outs.append(deq.numpy())
    np.testing.assert_allclose(np.mean(outs, axis=0), g.numpy(), rtol=0.05,
                               atol=float(g.abs().max()) * 0.05)


def test_compressed_psum_single_group_matches_reference(rng, tmp_path):
    """On one rank the sum is over a trivial group: the output is the
    int8-quantized gradient, the residual the rest, both bitwise the
    reference's single-pod shard_map; and mean + residual is g."""
    g = {"w": rng.normal(size=(16,)).astype(np.float32),
         "x": {"y": rng.normal(size=(4, 3)).astype(np.float32)}}
    r = jax.tree.map(lambda a: (a * 1e-3).astype(np.float32), g)
    mesh = jax.make_mesh((1,), ("pod",))
    spec = lambda t: jax.tree.map(  # noqa: E731
        lambda _: jax.sharding.PartitionSpec(), t)
    fn = jcomp.wrap_pod_manual(
        lambda gg, rr: jcomp.compressed_psum(gg, rr, "pod"), mesh,
        in_specs=(spec(g), spec(r)), out_specs=(spec(g), spec(r)))
    jmean, jres = fn(jax.tree.map(jnp.asarray, g),
                     jax.tree.map(jnp.asarray, r))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        tmean, tres = tcomp.compressed_psum(_tensors(g), _tensors(r), group)
    finally:
        dist.destroy_process_group()
    for path in (("w",), ("x", "y")):
        jm, tm, jr, tr = jmean, tmean, jres, tres
        for k in path:
            jm, tm, jr, tr = jm[k], tm[k], jr[k], tr[k]
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        want = functools.reduce(lambda t, k: t[k], path, g)
        want = want + functools.reduce(lambda t, k: t[k], path, r)
        np.testing.assert_allclose(tm.numpy() + tr.numpy(), want,
                                   rtol=1e-5, atol=1e-6)
    res0 = tcomp.compress_residual_init(_tensors(g))
    assert res0["x"]["y"].shape == (4, 3) and not res0["w"].any()


# ----------------------------------------------------- loss and grads ----
@functools.lru_cache(maxsize=None)
def _reference_grads(arch):
    """The reference's jitted ``value_and_grad`` of its loss (no remat:
    its ``jax.checkpoint`` recomputes the same values) on ``_batch``."""
    jcfg, _, jparams, _ = _model(arch)
    jbatch, _ = _batch(jcfg)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg, remat=False), has_aux=True))(jparams,
                                                                jbatch)
    return jloss, jm, jgrads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(arch, remat):
    jcfg, tcfg, _, tparams = _model(arch)
    jloss, jm, jgrads = _reference_grads(arch)
    _, tbatch = _batch(jcfg)
    loss_fn = tsteps.make_loss_fn(tcfg, remat=remat)
    (tloss, tm), tgrads = tsteps.value_and_grad(loss_fn, tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for k in ("ce", "load_balance", "router_z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                   atol=1e-7)
    if tcfg.n_moe_ffn:
        assert float(tm["load_balance"]) > 0 and float(tm["router_z"]) > 0
    assert {g: set(grp) for g, grp in tgrads.items()} == {
        g: set(grp) for g, grp in jgrads.items()}
    for g, grp in jgrads.items():
        for n, want in grp.items():
            want, got = np.asarray(want), tgrads[g][n]
            assert got.dtype == torch.float32 and got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1e-6)
            err = float(np.abs(got.numpy() - want).max()) / scale
            assert err <= GRAD_TOL[arch], (g, n, err)
    if remat:     # the port's remat recomputes the same ops: same bits
        _, plain = tsteps.value_and_grad(
            tsteps.make_loss_fn(tcfg, remat=False), tparams, tbatch)
        for g, grp in plain.items():
            for n, t in grp.items():
                assert torch.equal(t, tgrads[g][n]), (g, n)


def test_frontend_embeddings_get_gradients():
    """A frontend arch trains from float embeddings: the adapter gets a
    gradient, the token table (unused) gets zeros, as in the reference."""
    jcfg, tcfg, jparams, tparams = _model("musicgen-large")
    jbatch, tbatch = _batch(jcfg)
    _, jgrads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg, remat=False), has_aux=True))(jparams,
                                                               jbatch)
    _, tgrads = tsteps.value_and_grad(
        tsteps.make_loss_fn(tcfg, remat=False), tparams, tbatch)
    adapter = tgrads["frontend"]["adapter"]
    assert float(adapter.abs().max()) > 0
    np.testing.assert_allclose(adapter.numpy(),
                               np.asarray(jgrads["frontend"]["adapter"]),
                               atol=1e-5 * float(adapter.abs().max()))
    np.testing.assert_array_equal(tgrads["embed"]["tok"].numpy(),
                                  np.asarray(jgrads["embed"]["tok"]))


# ---------------------------------------------------------- the steps ----
def _tiny():
    kw = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128)
    return (jreduced(jget_config("chai-llama-7b"), **kw).replace(
        dtype="float32"),
        reduced(get_config("chai-llama-7b"), **kw).replace(dtype="float32"))


def test_microbatched_matches_fused_and_reference():
    """Two microbatches against the fused step inside the port (the
    reference's own test and tolerance), and the port's microbatched step
    against the reference's: loss at 1e-6, lr and step bitwise, params at
    1e-5 of their scale."""
    jcfg, tcfg = _tiny()
    jparams = _numpy_params(tcfg, 0)
    rng = np.random.default_rng(0)
    nb = {k: rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
          for k in ("tokens", "labels")}
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    lr_kw = dict(total=10, warmup=2)
    tparams = _port(jparams)
    fused = tsteps.make_train_step(tcfg, remat=False, lr_kw=lr_kw)
    micro = tts.make_microbatched_train_step(tcfg, n_micro=2, remat=False,
                                             lr_kw=lr_kw)
    p1, _, m1 = fused(tparams, tadamw.init(tparams), tbatch)
    p2, o2, m2 = micro(tparams, tadamw.init(tparams), tbatch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(tadamw.tree_leaves(p1), tadamw.tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)
    jmicro = jax.jit(jts.make_microbatched_train_step(
        jcfg, n_micro=2, remat=False, lr_kw=lr_kw))
    jp2, jo2, jm2 = jmicro(jparams, jadamw.init(jparams), jbatch)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-6)
    assert int(o2.step) == int(jo2.step) == 1
    assert m2["lr"].numpy().tobytes() == np.asarray(jm2["lr"]).tobytes()
    assert float(m2["load_balance"]) == float(jm2["load_balance"]) == 0.0
    for g in jp2:
        for n in jp2[g]:
            want = np.asarray(jp2[g][n])
            np.testing.assert_allclose(p2[g][n].numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def test_train_step_grad_dtype_and_refusals():
    """``grad_dtype`` casts the gradients before the optimizer (the
    moments stay fp32); ``grad_shardings`` leaves plain gradients as they
    are; the compressed step refuses a mesh without a pod axis."""
    _, tcfg = _tiny()
    tparams = _port(_numpy_params(tcfg, 0))
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (2, 8)))
             for k in ("tokens", "labels")}
    step = tsteps.make_train_step(tcfg, remat=False, grad_dtype="bfloat16")
    p, opt, m = step(tparams, tadamw.init(tparams), batch)
    assert np.isfinite(float(m["loss"])) and int(opt.step) == 1
    assert all(t.dtype == torch.float32 for t in tadamw.tree_leaves(opt.m))
    # without a mesh the gradients are plain tensors, which a ZeRO layout
    # leaves as they are
    none = tadamw.tree_map(lambda _: None, tparams)
    step_z = tsteps.make_train_step(tcfg, remat=False, grad_dtype="bfloat16",
                                    grad_shardings=none)
    pz, _, mz = step_z(tparams, tadamw.init(tparams), batch)
    assert float(mz["loss"]) == float(m["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tadamw.tree_leaves(pz),
                                                 tadamw.tree_leaves(p)))
    with pytest.raises(ValueError, match="'pod' axis"):
        tts.make_compressed_train_step(tcfg)


# -------------------------------------------------------- the pipeline ----
@pytest.mark.parametrize("cfg", [
    dict(vocab_size=256, seq_len=32, global_batch=8, seed=7),
    dict(vocab_size=128, seq_len=64, global_batch=8),
    dict(vocab_size=32000, seq_len=16, global_batch=4, n_streams=3,
         branch=2)], ids=["v256", "v128", "v32000"])
def test_pipeline_batches_bitwise(cfg):
    jp = jpipe.SyntheticPipeline(jpipe.DataConfig(**cfg))
    tp = tpipe.SyntheticPipeline(tpipe.DataConfig(**cfg))
    np.testing.assert_array_equal(tp.tables, jp.tables)
    for i in (0, 3, 17):
        a, b = jp.batch(i), tp.batch(i)
        for k in ("tokens", "labels"):
            assert b[k].dtype == a[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], a[k])
        for h in (0, 1):
            a = jp.batch(i, host_id=h, n_hosts=2)
            b = tp.batch(i, host_id=h, n_hosts=2)
            np.testing.assert_array_equal(b["tokens"], a["tokens"])
    t = tp.global_batch_tensor(5, "cpu")
    assert t["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(t["labels"].numpy(),
                                  jp.batch(5)["labels"])


def test_calibration_batches_bitwise():
    want = list(jpipe.calibration_batches(256, 24, n_samples=20))
    got = list(tpipe.calibration_batches(256, 24, n_samples=20))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
