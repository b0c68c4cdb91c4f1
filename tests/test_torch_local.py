"""The port's local-attention layers (ring caches, the window) and the
gemma2 softcaps against the JAX package's, on the CPU.

Reduced gemma2-9b (a local and a global layer, 8 heads over 4 KV groups,
head_dim 8, attention cap 50, final cap 30; and at an attention cap of 5,
where the cap is live at these widths) and reduced h2o-danube-1.8b (two
local layers, 8 heads over 2 KV groups), fp32, the reference's own
``init_params`` weights through ``params_from_numpy``.

* (a) ``ring_positions`` bitwise; the rings after prefill, exact-length
  and bucketed (``valid_len``, per row, bucket > true length > window),
  window 8 and 16: placement bitwise with both packages' projections
  replaced by the same numpy rows, and the real model's rings at 1e-5.
* (b) ``forward_fullseq`` logits and ``decode_step`` logits over steps
  that cross the window, CHAI off and on (WARMUP with the score buffer,
  CLUSTER with the membership identified exactly from the reference's
  buffer, STEADY through the GQA local branch and the global layers'
  fused op), teacher-forced, at 1e-4; the score buffers at 1e-5.
* (c) The cohort engine and the continuous engine, paged and dense, in
  lockstep with the reference's (its token each step, its membership
  each CLUSTER): logits of every live row at 1e-4, greedy tokens on
  margin-checked steps, the page accounting step by step, and
  ``kv_bytes()`` equal to the reference's (rings counted).
* (e) The MHA baseline (``use_chai=False``) on gemma2: every layer takes
  the eager attention (the flash decode kernels have no softcap), tokens
  and logits equal to the reference engine's.
* (f) The prefix cache and chunked prefill refuse local archs with the
  reference's ``ValueError``.
* (g) The int8 KV cache (``kv_cache_dtype="int8"``) with local layers:
  the state shapes and dtypes of every layout equal the reference's (int8
  global caches and fp32 scales, rings in the model dtype); reduced
  gemma2 at cap 5 on the cohort and the continuous engine, paged and
  dense, CHAI on (and off on the paged one), in lockstep with the
  reference's, and the byte
  counts equal (the analytic one counts a ring at the int8 element size,
  as the reference's does); reduced danube, with no global layer,
  serves the same tokens with and without int8.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

GEMMA, DANUBE = "gemma2-9b", "h2o-danube-1.8b"
# name: (arch, reduced kw, replace kw)
CONFIGS = {"gemma2": (GEMMA, dict(n_layers=2, window=8), {}),
           "gemma2_cap5": (GEMMA, dict(n_layers=2, window=8),
                           dict(attn_logit_softcap=5.0)),
           "danube": (DANUBE, dict(n_layers=2, window=16), {})}
INT8_CONFIGS = {"gemma2_cap5_int8": "gemma2_cap5", "danube_int8": "danube"}
ENGINES = {"cohort": dict(scheduler="cohort"),
           "paged": dict(kv_layout="paged"),
           "dense": dict(kv_layout="dense")}
PROMPT_LENS = (11, 6, 17, 9, 14)
BUDGETS = (12, 7, 10, 4, 9)
TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
FEATURE_TOL = dict(atol=1e-5, rtol=1e-4)
MARGIN = 1e-3
# int8: the two packages' fp32 K/V rows differ in the last bits, and a row
# element on a rounding edge of ``quant_rows`` takes the neighbouring code
# on one side (the reference's jitted prefill vs the port's eager one).
# One code of one V row moves every logit of its slot by up to ~5e-4 in
# the steps after, so under int8 the logits are held at INT8_TOL, a greedy
# pick where the reference's top-2 margin exceeds INT8_MARGIN, and the
# WARMUP features at INT8_FEATURE_TOL (``tests/test_torch_int8.py``'s).
INT8_TOL = dict(atol=2e-3, rtol=0)
INT8_MARGIN = 1e-2
INT8_FEATURE_TOL = dict(atol=2e-3, rtol=0)
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages", "n_warmup",
                "n_steady")


def _pair(name):
    arch, red, rep = CONFIGS[name]
    jcfg = jreduced(jget_config(arch), **red).replace(**rep)
    tcfg = reduced(get_config(arch), **red).replace(**rep)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    jcfg, tcfg = _pair(request.param)
    assert (tcfg.layer_types, tcfg.n_kv_heads, tcfg.head_dim,
            tcfg.attn_logit_softcap, tcfg.final_logit_softcap) == (
        jcfg.layer_types, jcfg.n_kv_heads, jcfg.head_dim,
        jcfg.attn_logit_softcap, jcfg.final_logit_softcap)
    assert tcfg.n_local_layers and not tcfg.is_mha
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------ (a) the rings ----
def test_ring_positions_bitwise():
    for size in (1, 5, 8, 16):
        pos = np.arange(0, 3 * size + 2, dtype=np.int32)
        want = np.stack([np.asarray(jattn.ring_positions(jnp.int32(p), size))
                         for p in pos])
        got = tattn.ring_positions(torch.from_numpy(pos), size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _stub_projection(monkeypatch, b, t, kv, h, hd):
    """Both packages' ``project_qkv`` return the same numpy rows, distinct
    per (row, position, head, element), so the rings' placement can be
    held bitwise whatever the two packages' matmuls round."""
    base = (np.arange(b)[:, None, None, None] * 1000.0
            + np.arange(t)[None, :, None, None]
            + np.arange(kv)[None, None, :, None] * 0.01
            + np.arange(hd)[None, None, None, :] * 1e-4).astype(np.float32)
    q = np.repeat(base, h // kv, axis=2)

    def jproj(x, p, cfg, positions, layer_slice=None):
        n = x.shape[1]
        return (jnp.asarray(q[:, :n]), jnp.asarray(base[:, :n]),
                jnp.asarray(-base[:, :n]))

    def tproj(x, p, cfg, positions):
        n = x.shape[1]
        return _t(q[:, :n]), _t(base[:, :n]), _t(-base[:, :n])
    monkeypatch.setattr(jattn, "project_qkv", jproj)
    monkeypatch.setattr(tattn, "project_qkv", tproj)


@pytest.mark.parametrize("window", [8, 16])
@pytest.mark.parametrize("arch", [GEMMA, DANUBE])
@pytest.mark.parametrize("mode", ["exact", "bucket"])
def test_ring_after_prefill(arch, window, mode, monkeypatch):
    """The ring after prefill, exact-length (the last min(T, w) rows at
    ``pos % w``) and bucketed (slot s holds the latest REAL position
    congruent to s; a slot with none keeps its row): the two rows of the
    batch at 21 and 13 real tokens of a 32-token bucket (bucket > true
    length > window, and 13 < 16 leaves slots without a real position).
    Placement bitwise (stubbed projections), real model at 1e-5."""
    red = dict(n_layers=2, window=window)
    jcfg = jreduced(jget_config(arch), **red)
    tcfg = reduced(get_config(arch), **red)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    b, t, bucket, s = 2, 21, 32, 64
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (b, t))
    if mode == "exact":
        jt, tt, jvl, tvl = jnp.asarray(toks, jnp.int32), _t(toks), None, None
    else:
        pad = np.zeros((b, bucket), np.int64)
        pad[:, :t] = toks
        pad[1, 13:] = 0
        lens = np.array([t, 13], np.int32)
        jt, tt = jnp.asarray(pad, jnp.int32), _t(pad)
        jvl, tvl = jnp.asarray(lens), _t(lens)

    def run():
        js = jtfm.init_decode_state(jcfg, b, s)
        jl, js, _ = jtfm.forward_fullseq(jparams, jcfg, jt, state=js,
                                         logits_slice="last", valid_len=jvl)
        ts = ttfm.init_decode_state(tcfg, b, s, "cpu")
        tl, ts = ttfm.forward_fullseq(tparams, tcfg, tt, state=ts,
                                      logits_slice="last", valid_len=tvl)
        assert set(ts) == set(js)
        return jl, js, tl, ts

    jl, js, tl, ts = run()
    assert ts["kl"].shape == (tcfg.n_local_layers, b, tcfg.n_kv_heads,
                              min(window, s), tcfg.head_dim)
    assert ts["kl"].dtype == torch.float32
    for key in ts:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   **STATE_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    _stub_projection(monkeypatch, b, jt.shape[1], tcfg.n_kv_heads,
                     tcfg.n_heads, tcfg.head_dim)
    _, js, _, ts = run()
    for key in ("kl", "vl"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    # slot s of row 1 (13 real tokens, w = 16) holds no real position for
    # s >= 13: kept at zero
    if mode == "bucket" and window == 16:
        assert not ts["kl"][:, 1, :, 13:].any()
    assert (ts["pos"].numpy() == np.asarray(js["pos"])).all()


# ------------------------------------------ (b) the model, step by step ----
def _decode_run(jcfg, tcfg, jparams, tparams, *, chai, n_steps=12):
    """Prefill 12 tokens (2 rows), then ``n_steps`` teacher-forced decode
    steps, both packages; with ``chai`` the first ``warmup_tokens`` steps
    fill the score buffer, the membership comes from the reference's
    buffer (the port's identification held equal to it), and the rest
    are STEADY. Returns the largest logits difference."""
    b, t0, s = 2, 12, 64
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (b, t0))
    nxt = rng.integers(0, jcfg.vocab_size, (n_steps, b))
    js = jtfm.init_decode_state(jcfg, b, s)
    jl, js, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                     state=js, logits_slice="last")
    ts = ttfm.init_decode_state(tcfg, b, s, "cpu")
    tl, ts = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=ts,
                                  logits_slice="last")
    worst = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    warm = jcfg.chai.warmup_tokens if chai else 0
    if chai:
        js = jcache.add_score_buffer(js, jcfg, b)
        ts = tcache.add_score_buffer(ts, tcfg, b)
        assert ts["chai_scores"].shape == tuple(js["chai_scores"].shape)
    jctx = tctx = None
    jstep = jax.jit(lambda p, tok, st, ctx: jtfm.decode_step(
        p, jcfg, tok, st, chai_ctx=ctx))
    for i in range(n_steps):
        if chai and i == warm:
            js, jsc = jcache.pop_score_buffer(js)
            ts, tsc = tcache.pop_score_buffer(ts)
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       **STATE_TOL)
            jctx = jclust.identify_membership(jsc, jcfg)
            tctx = tclust.identify_membership(_t(jsc), tcfg)
            for key in jctx:
                np.testing.assert_array_equal(tctx[key].numpy(),
                                              np.asarray(jctx[key]))
        jl, js = jstep(jparams, jnp.asarray(nxt[i]), js, jctx)
        tl, ts = ttfm.decode_step(tparams, tcfg, _t(nxt[i]), ts,
                                  chai_ctx=tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    for key in ("kl", "vl", "kg", "vg"):
        if key in ts:
            np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                       **STATE_TOL)
    assert int(ts["pos"][0]) == t0 + n_steps > tcfg.window_size
    return worst


@pytest.mark.parametrize("chai", [False, True], ids=["mha", "chai"])
def test_decode_steps_cross_the_window(models, chai):
    name, jcfg, tcfg, jparams, tparams = models
    worst = _decode_run(jcfg, tcfg, jparams, tparams, chai=chai)
    print(f"{name} chai={chai}: logits max abs diff {worst:.2e}")


def test_softcap_is_live_at_cap5():
    """At an attention cap of 5 the reduced model's logits move, prefill
    and decode (the cap is not the identity at these widths)."""
    jcfg, tcfg = _pair("gemma2_cap5")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    toks = _t(np.random.default_rng(2).integers(0, tcfg.vocab_size, (2, 12)))
    outs = []
    for cap in (5.0, 0.0):
        cfg = tcfg.replace(attn_logit_softcap=cap)
        st = ttfm.init_decode_state(cfg, 2, 32, "cpu")
        lg, st = ttfm.forward_fullseq(tparams, cfg, toks, state=st,
                                      logits_slice="last")
        lg2, _ = ttfm.decode_step(tparams, cfg, toks[:, 0], st)
        outs.append((lg, lg2))
    for capped, uncapped in zip(*outs):
        assert not torch.allclose(capped, uncapped, atol=1e-4)


# ----------------------------------------------------- (c) the engines ----
def _engine_cfg(ekw):
    return {"batch_slots": 2, "max_seq": 64, "page_size": 16, **ekw}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in PROMPT_LENS]


def _reference_run(jcfg, jparams, prompts, ekw):
    """The reference engine's run: (argmax inputs and outputs per call,
    (scores, membership) per CLUSTER, tokens, page history, KV bytes)."""
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**_engine_cfg(ekw)))
    calls, idents = [], []
    argmax = jeng._argmax

    def rec_argmax(lg):
        out = argmax(lg)
        calls.append((np.asarray(lg), np.asarray(out)))
        return out
    jeng._argmax = rec_argmax
    if ekw.get("use_chai", True):
        if ekw.get("scheduler") == "cohort":
            identify = jeng._identify

            def rec_identify(sc):
                out = identify(sc)
                idents.append((np.asarray(sc),
                               {k: np.asarray(v) for k, v in out.items()}))
                return out
            jeng._identify = rec_identify
        else:
            cluster = jeng._cluster_fn()

            def rec_cluster(state, ctx, slot, *rest):
                i = int(slot)
                sc = np.array(state["chai_scores"][:, i])[:, None]
                state, ctx = cluster(state, ctx, slot, *rest)
                idents.append((sc, {k: np.array(v[:, i])[:, None]
                                    for k, v in ctx.items()}))
                return state, ctx
            jeng._cluster_slot = rec_cluster
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        jeng.submit(p, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in jeng.run()}
    hist = [{k: h[k] for k in HISTORY_KEYS}
            for h in getattr(jeng, "kv_bytes_history", [])]
    return calls, idents, done, hist, jeng.kv_bytes(), jeng.paged


def _live_rows(eng, n):
    if n == 1 or eng.ecfg.scheduler == "cohort":
        return list(range(n))
    return [i for i, r in enumerate(eng._slot_req)
            if r is not None and eng._phases[i] != tcache.PHASE_PREFILL]


def _lockstep(jcfg, tcfg, jparams, tparams, ekw, *, tol=TOL, margin=MARGIN,
              feature_tol=FEATURE_TOL):
    """Serve the five requests on the reference engine and on the port's
    in lockstep; returns (port engine, margin-checked tokens, CLUSTER
    count). The logits are held at ``tol``, the port's pick where the
    reference's top-2 margin exceeds ``margin``, the CLUSTER features at
    ``feature_tol``."""
    prompts = _prompts(jcfg.vocab_size)
    calls, idents, jdone, jhist, jbytes, jpaged = _reference_run(
        jcfg, jparams, prompts, ekw)
    teng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(ekw)),
                         device="cpu")
    feed, forced = iter(calls), iter(idents)
    seen = {"tokens": 0}

    def lockstep_argmax(lg):
        want_lg, want_tok = next(feed)
        rows = _live_rows(teng, lg.shape[0])
        np.testing.assert_allclose(lg[rows].numpy(), want_lg[rows], **tol)
        for i in rows:
            top2 = np.sort(want_lg[i])[-2:]
            if top2[1] - top2[0] > margin:
                assert int(lg[i].argmax()) == int(want_tok[i])
                seen["tokens"] += 1
        return torch.from_numpy(want_tok.astype(np.int64))

    def lockstep_identify(sc):
        want_sc, want_ctx = next(forced)
        np.testing.assert_allclose(sc.numpy(), want_sc, **feature_tol)
        same_buf = tclust.identify_membership(_t(want_sc), tcfg)
        for key in want_ctx:
            np.testing.assert_array_equal(same_buf[key].numpy(),
                                          want_ctx[key])
        return {k: _t(v) for k, v in want_ctx.items()}

    teng._argmax, teng._identify = lockstep_argmax, lockstep_identify
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        teng.submit(p, max_new_tokens=m, uid=i)
    tdone = {r.uid: r.generated for r in teng.run()}
    assert tdone == jdone
    assert next(feed, None) is None and next(forced, None) is None
    assert teng.paged == jpaged
    if teng.paged:
        assert [{k: h[k] for k in HISTORY_KEYS}
                for h in teng.kv_bytes_history] == jhist
        assert teng.dense_pool.pages_in_use == 0
    assert teng.kv_bytes() == jbytes
    return teng, seen["tokens"], len(idents)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_in_lockstep_with_reference(models, engine):
    """Both schedulers and both layouts (danube, with no global layer,
    runs the paged setting on the unified layout, as the reference does);
    the prompts of 14 and 17 tokens pass a window of 8 or 16, and the
    cohort's buckets (16, 32) exceed them."""
    name, jcfg, tcfg, jparams, tparams = models
    teng, n_tok, n_cluster = _lockstep(jcfg, tcfg, jparams, tparams,
                                       ENGINES[engine])
    assert n_cluster == (3 if engine == "cohort" else 4)
    assert n_tok >= 30
    assert teng.paged == (engine == "paged" and tcfg.n_global_layers > 0)
    if engine != "cohort":
        assert teng.cluster_transitions == 4
    print(f"{name} {engine}: {n_tok} margin-checked tokens, kv_bytes "
          f"{teng.kv_bytes():,}")


def test_kv_bytes_count_the_rings(models):
    """The byte counts equal the reference's, rings included: the
    unified layout's residency, the paged layout's allocation (pages in
    use plus every slot's rings) and the analytic size."""
    _, jcfg, tcfg, _, _ = models
    for b, s in ((2, 64), (3, 48), (1, 8)):
        for chai in (False, True):
            assert tcache.unified_kv_bytes(tcfg, b, s, chai=chai) == \
                jcache.unified_kv_bytes(jcfg, b, s, chai=chai)
            assert tcache.kv_cache_bytes(tcfg, b, s, chai=chai) == \
                jcache.kv_cache_bytes(jcfg, b, s, chai=chai)
        for used in (0, 5):
            assert tcache.paged_kv_bytes(tcfg, 16, used, 0, batch=b,
                                         max_seq=s) == \
                jcache.paged_kv_bytes(jcfg, 16, used, 0, batch=b, max_seq=s)
    ring = 2 * tcfg.n_local_layers * 2 * tcfg.n_kv_heads * min(
        tcfg.window_size, 64) * tcfg.head_dim * 4
    assert tcache.paged_kv_bytes(tcfg, 16, 0, batch=2, max_seq=64) == ring


# -------------------------------------------- (e) the MHA baseline ----
@pytest.mark.parametrize("engine", list(ENGINES))
def test_gemma2_mha_baseline_matches_reference(engine, monkeypatch):
    """CHAI off on gemma2 (cap 5, so the cap is live): the flash decode
    kernels take no softcap, so every layer of every decode step runs the
    eager attention (``_decode_attention_batched``, the reference's
    decode math) and the flash decode ops never run; logits of live rows
    at 1e-4 against the reference engine's, identical tokens."""
    jcfg, tcfg = _pair("gemma2_cap5")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    eager = [0]
    inner = ttfm._decode_attention_batched

    def counted(*args):
        eager[0] += 1
        return inner(*args)

    def refused(*args, **kw):
        raise AssertionError("a flash decode op ran on a softcap arch")
    monkeypatch.setattr(ttfm, "_decode_attention_batched", counted)
    monkeypatch.setattr(ttfm.kops, "flash_decode_attention", refused)
    monkeypatch.setattr(ttfm.kops, "paged_decode_attention", refused)
    ekw = dict(ENGINES[engine], use_chai=False)
    teng, n_tok, _ = _lockstep(jcfg, tcfg, jparams, tparams, ekw)
    assert eager[0] == tcfg.n_layers * teng.steps_executed > 0
    assert n_tok >= 30


@pytest.mark.parametrize("arch", [GEMMA, DANUBE])
def test_weights_carry_leaf_by_leaf(arch):
    """``params_from_numpy`` carries the reference's tree leaf by leaf:
    the port's ``param_table`` names the same leaves with the same shapes
    (the gated MLP, GELU for gemma2 and SiLU for danube, and the untied
    unembed included), and every value arrives unchanged."""
    jcfg = jreduced(jget_config(arch), n_layers=3)
    tcfg = reduced(get_config(arch), n_layers=3)
    assert tcfg.activation == jcfg.activation == (
        "gelu" if arch == GEMMA else "silu")
    assert not tcfg.tie_embeddings and tcfg.gated_mlp
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    table = ttfm.param_table(tcfg)
    assert {g: set(grp) for g, grp in table.items()} == {
        g: set(grp) for g, grp in jparams.items()}
    for g, grp in table.items():
        for n, (shape, _, _) in grp.items():
            assert tuple(tparams[g][n].shape) == shape == jparams[g][n].shape
            np.testing.assert_array_equal(tparams[g][n].numpy(),
                                          np.asarray(jparams[g][n]))


# ---------------------------------------------------- (f) refusals ----
@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(prefill_chunk_tokens=16)],
                         ids=["prefix_cache", "chunked"])
@pytest.mark.parametrize("name", ["gemma2", "danube"])
def test_local_archs_refuse_prefix_cache_and_chunks(name, kw):
    """Local rings are not paged: a suffix-only or chunked prefill cannot
    rebuild them, so both engines refuse, with the same message (danube
    has no global layer, so its continuous engine is not paged and its
    prefix cache is refused for that)."""
    jcfg, tcfg = _pair(name)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    msgs = []
    for make in (lambda: JServingEngine(jcfg, jparams,
                                        JEngineConfig(**_engine_cfg(kw))),
                 lambda: ServingEngine(tcfg, tparams,
                                       EngineConfig(**_engine_cfg(kw)),
                                       device="cpu")):
        try:
            make()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    # danube has no global layer: its continuous engine is not paged, so
    # the chunk setting is ignored there (both packages)
    chunk_ignored = "prefill_chunk_tokens" in kw and not tcfg.n_global_layers
    assert (msgs[0] is None) == chunk_ignored


def _shapes_of_structs(structs):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}


def _shapes_of_table(table):
    return {k: (tuple(shape), str(dt).replace("torch.", ""))
            for k, (shape, dt) in table.items()}


def _int8_pair(name):
    jcfg, tcfg = _pair(INT8_CONFIGS[name])
    return (jcfg.replace(kv_cache_dtype="int8"),
            tcfg.replace(kv_cache_dtype="int8"))


def test_int8_with_local_layers_refused():
    """The int8 KV cache with local layers is not refused: the decode
    state of every layout (the cohort's, the unified and the paged one)
    equals the reference's shape for shape and dtype for dtype: int8
    global caches and pools with fp32 scales, the rings in the model
    dtype (fp32 and bf16 configs); danube has rings only."""
    b, s = 3, 64
    kw = dict(page_size=16, dense_pages=9, chai_pages=5)
    for name in INT8_CONFIGS:
        for dtype in ("float32", "bfloat16"):
            jcfg, tcfg = (c.replace(dtype=dtype) for c in _int8_pair(name))
            for want, got in (
                    (jtfm.decode_state_structs(jcfg, b, s)[0],
                     ttfm.decode_state_shapes(tcfg, b, s)),
                    (jcache.unified_state_structs(jcfg, b, s)[0],
                     tcache.unified_state_shapes(tcfg, b, s)),
                    (jcache.paged_state_structs(jcfg, b, s, **kw)[0],
                     tcache.paged_state_shapes(tcfg, b, s, **kw))):
                want = _shapes_of_structs(want)
                assert _shapes_of_table(got) == want
                assert want["kl"][1] == want["vl"][1] == dtype
                if tcfg.n_global_layers:
                    pool = "kvp" if "kvp" in want else "kg"
                    assert want[pool][1] == "int8"
                    assert want[pool + "_scale"][1] == "float32"
                else:
                    assert not any(v[1] == "int8" for v in want.values())


@pytest.fixture(scope="module", params=["gemma2_cap5_int8"])
def int8_models(request):
    jcfg, tcfg = _int8_pair(request.param)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return request.param, jcfg, tcfg, jparams, tparams


INT8_KW = dict(tol=INT8_TOL, margin=INT8_MARGIN,
               feature_tol=INT8_FEATURE_TOL)


# CHAI on every engine; the MHA baseline on the default one only: it is
# the eager attention on every layer on each of them, over the same
# dequantized global view and the same rings.
@pytest.mark.parametrize("engine,chai", [
    ("cohort", True), ("paged", True), ("dense", True), ("paged", False)],
    ids=["cohort-chai", "paged-chai", "dense-chai", "paged-mha"])
def test_int8_engines_in_lockstep_with_reference(int8_models, engine, chai):
    """Reduced gemma2 (cap 5) under int8, CHAI on (the global layers'
    fused op in its int8 x softcap mode, the local layers over their
    float rings) on every engine and off (the eager attention on every
    layer: the dequantized global view, the rings as they are) on the
    continuous paged one, in lockstep with the reference's engines; page
    history and ``kv_bytes()`` equal."""
    name, jcfg, tcfg, jparams, tparams = int8_models
    ekw = dict(ENGINES[engine], use_chai=chai)
    teng, n_tok, n_cluster = _lockstep(jcfg, tcfg, jparams, tparams, ekw,
                                       **INT8_KW)
    assert n_cluster == (0 if not chai else 3 if engine == "cohort" else 4)
    assert n_tok >= 25, n_tok
    assert teng.paged == (engine == "paged")
    state = teng._dev_state if engine != "cohort" else None
    if state is not None:
        glob = state["kvp"] if teng.paged else state["kg"]
        assert glob.dtype == torch.int8
        assert state["kl"].dtype == state["vl"].dtype == torch.float32
    print(f"{name} {engine} chai={chai}: {n_tok} margin-checked tokens, "
          f"kv_bytes {teng.kv_bytes():,}")


def test_int8_kv_bytes_match_reference():
    """Every byte count under int8 equals the reference's, rings
    included: the unified residency (int8 rectangles and scales, float
    rings), the paged allocation (int8 pages, rings at the model dtype's
    size) and the analytic size, which counts a ring at the int8 element
    size 1 + 4 / hd although the rings are allocated in the model dtype
    (the reference's own count, copied as it is)."""
    for name in INT8_CONFIGS:
        jcfg, tcfg = _int8_pair(name)
        for b, s in ((2, 64), (3, 48), (1, 8)):
            for chai in (False, True):
                assert tcache.unified_kv_bytes(tcfg, b, s, chai=chai) == \
                    jcache.unified_kv_bytes(jcfg, b, s, chai=chai)
                assert tcache.kv_cache_bytes(tcfg, b, s, chai=chai) == \
                    jcache.kv_cache_bytes(jcfg, b, s, chai=chai)
            for used in (0, 5):
                assert tcache.paged_kv_bytes(tcfg, 16, used, 0, batch=b,
                                             max_seq=s) == \
                    jcache.paged_kv_bytes(jcfg, 16, used, 0, batch=b,
                                          max_seq=s)
        hd, kv = tcfg.head_dim, tcfg.n_kv_heads
        ring = 2 * kv * min(tcfg.window_size, 64) * hd
        assert tcache.kv_cache_bytes(tcfg, 1, 64) == (
            tcfg.n_global_layers * 2 * kv * 64 * hd * (1 + 4 / hd)
            + tcfg.n_local_layers * ring * (1 + 4 / hd))
        assert tcache.paged_kv_bytes(tcfg, 16, 0, batch=1, max_seq=64) == (
            tcfg.n_local_layers * ring * 4)


@pytest.mark.parametrize("engine", ["paged"])
def test_danube_int8_tokens_equal_float_tokens(engine):
    """danube has no global layer, so int8 quantizes nothing: the same
    requests give the same greedy tokens, CHAI on, on the default engine
    (every engine builds the same float rings and no int8 cache: the
    state shapes of every layout are held in
    ``test_int8_with_local_layers_refused``)."""
    _, tcfg = _pair("danube")
    jparams = jtfm.init_params(_pair("danube")[0], jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    prompts = _prompts(tcfg.vocab_size)
    out = []
    for cfg in (tcfg, tcfg.replace(kv_cache_dtype="int8")):
        eng = ServingEngine(cfg, tparams,
                            EngineConfig(**_engine_cfg(ENGINES[engine])),
                            device="cpu")
        for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(p, max_new_tokens=m, uid=i)
        out.append({r.uid: r.generated for r in eng.run()})
    assert out[0] == out[1]
    assert sum(map(len, out[0].values())) == sum(BUDGETS)
