"""The port's GQA model path (reduced nemotron-4-15b) against the JAX
package's, on the CPU.

Two reduced configurations, 2 layers, fp32, the reference's own
``init_params`` weights: ``n_heads=8`` (one KV group of 8 heads, the
shape the reference's tests use) and ``n_heads=12, d_model=96`` (two KV
groups of 6 heads, head_dim 8), which exercises the group indexing that
one group hides.

* Membership: ``identify_membership`` exactly equal to the reference's
  from one score buffer (block-diagonal K-Means per KV group), the batched
  ctx buffers and the per-slot scatter.
* Engines in lockstep: the reference's cohort engine and continuous
  engine (paged, dense, and paged with chunked prefill) serve 5 requests
  on 2 slots; the port's engine of the same kind takes the reference's
  token at every step and its membership at every CLUSTER transition
  (after computing that membership exactly from the reference's buffer),
  so every step sees the same inputs: logits of every live row at atol =
  rtol = 1e-4 (prefill, WARMUP, mixed-phase and STEADY steps through
  ``_chai_gqa_decode``), and the port's greedy token equal to the
  reference's at every step where the reference's top-2 margin exceeds
  1e-3. The paged page accounting is held step by step (GQA frees no page
  at CLUSTER).
* Inside the port: paged, dense and cohort give identical tokens.
* ``relay_decode`` and ``prefix_cache`` on a GQA model are accepted (a
  request served through the cache); relay without the cache is refused
  with the MHA model's ``ValueError``.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import clustering as jclust
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

ARCH = "nemotron-4-15b"
CONFIGS = {"1group": dict(n_heads=8), "2groups": dict(n_heads=12, d_model=96)}
ENGINES = {"cohort": dict(scheduler="cohort"),
           "paged": dict(kv_layout="paged"),
           "dense": dict(kv_layout="dense"),
           "chunked": dict(kv_layout="paged", prefill_chunk_tokens=16,
                           max_seq=128)}
PROMPT_LENS = (11, 6, 17, 9, 14)
CHUNK_PROMPT_LENS = (40, 9, 33, 20, 50)
BUDGETS = (12, 7, 10, 4, 9)
TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages", "n_warmup",
                "n_steady")


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    kw = CONFIGS[request.param]
    jcfg = jreduced(jget_config(ARCH), n_layers=2, **kw)
    tcfg = reduced(get_config(ARCH), n_layers=2, **kw)
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim) == (
        jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim)
    assert not tcfg.is_mha and tcfg.activation == "relu2"
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    assert set(tparams["ffn"]) == {"ln", "w_up", "w_down"}   # not gated
    return request.param, jcfg, tcfg, jparams, tparams


def _engine_cfg(ekw):
    return {"batch_slots": 2, "max_seq": 64, "page_size": 16, **ekw}


def _prompts(vocab, engine):
    rng = np.random.default_rng(0)
    lens = CHUNK_PROMPT_LENS if engine == "chunked" else PROMPT_LENS
    return [rng.integers(0, vocab, size=n) for n in lens]


def test_gqa_membership_exact(models):
    """One score buffer, one membership: block-diagonal K-Means within
    each KV group, ``r_max`` clusters of the group's ``qpk`` heads."""
    _, jcfg, tcfg, _, _ = models
    rng = np.random.default_rng(3)
    na, b, h = tcfg.n_attn_layers, 3, tcfg.n_heads
    for f in (64, 128):
        sc = rng.dirichlet(np.ones(f), size=(na, b, h)).astype(np.float32)
        sc *= 5
        want = jax.jit(lambda x: jclust.identify_membership(x, jcfg))(
            jax.numpy.asarray(sc))
        got = tclust.identify_membership(torch.from_numpy(sc), tcfg)
        assert set(got) == set(want) == {"cluster_of", "reps"}
        for key in want:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    _, r_max = tclust.chai_widths(tcfg)
    assert got["reps"].shape == (na, b, tcfg.n_kv_heads, r_max)
    ctx = tclust.init_batched_ctx(tcfg, 2, "cpu")
    assert {k: tuple(v.shape) for k, v in ctx.items()} == {
        "cluster_of": (na, 2, tcfg.n_kv_heads, tcfg.q_per_kv),
        "reps": (na, 2, tcfg.n_kv_heads, r_max)}
    one = tclust.identify_membership_slot(torch.from_numpy(sc[:, 1]), tcfg)
    tclust.update_ctx_slot(ctx, one, 1)
    for key in ctx:
        assert not ctx[key][:, 0].any()
        np.testing.assert_array_equal(ctx[key][:, 1].numpy(),
                                      np.asarray(want[key])[:, 1])


def _reference_run(jcfg, jparams, prompts, engine):
    """The reference engine's run: (argmax inputs and outputs per call,
    (scores, membership) per CLUSTER, tokens, page history)."""
    jeng = JServingEngine(jcfg, jparams,
                          JEngineConfig(**_engine_cfg(ENGINES[engine])))
    calls, idents = [], []
    argmax = jeng._argmax

    def rec_argmax(lg):
        out = argmax(lg)
        calls.append((np.asarray(lg), np.asarray(out)))
        return out
    jeng._argmax = rec_argmax
    if engine == "cohort":
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
    return calls, idents, done, hist, jeng.kv_bytes()


def _live_rows(eng, n):
    if n == 1 or eng.ecfg.scheduler == "cohort":
        return list(range(n))
    return [i for i, r in enumerate(eng._slot_req)
            if r is not None and eng._phases[i] != tcache.PHASE_PREFILL]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_in_lockstep_with_reference(models, engine):
    name, jcfg, tcfg, jparams, tparams = models
    prompts = _prompts(jcfg.vocab_size, engine)
    calls, idents, jdone, jhist, jbytes = _reference_run(jcfg, jparams,
                                                         prompts, engine)
    teng = ServingEngine(tcfg, tparams, EngineConfig(
        **_engine_cfg(ENGINES[engine])), device="cpu")
    feed, forced = iter(calls), iter(idents)
    seen = {"held": 0, "tokens": 0, "worst": 0.0}

    def lockstep_argmax(lg):
        want_lg, want_tok = next(feed)
        rows = _live_rows(teng, lg.shape[0])
        got = lg[rows].numpy()
        np.testing.assert_allclose(got, want_lg[rows], **TOL)
        seen["worst"] = max(seen["worst"],
                            float(np.abs(got - want_lg[rows]).max()))
        for i in rows:
            top2 = np.sort(want_lg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert int(lg[i].argmax()) == int(want_tok[i])
                seen["tokens"] += 1
        seen["held"] += 1
        return torch.from_numpy(want_tok.astype(np.int64))  # a copy

    def lockstep_identify(sc):
        want_sc, want_ctx = next(forced)
        np.testing.assert_allclose(sc.numpy(), want_sc, atol=1e-5,
                                   rtol=1e-4)
        same_buf = tclust.identify_membership(torch.from_numpy(want_sc.copy()),
                                              tcfg)
        for key in want_ctx:
            np.testing.assert_array_equal(same_buf[key].numpy(),
                                          want_ctx[key])
        return {k: torch.from_numpy(v.copy()) for k, v in want_ctx.items()}

    mixed = [0]
    teng._argmax, teng._identify = lockstep_argmax, lockstep_identify
    if hasattr(teng, "_mixed_step"):
        step = teng._mixed_step

        def counted(*args):
            mixed[0] += 1
            return step(*args)
        teng._mixed_step = counted
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        teng.submit(p, max_new_tokens=m, uid=i)
    tdone = {r.uid: r.generated for r in teng.run()}
    assert tdone == jdone                     # teacher-forced: same tokens
    assert next(feed, None) is None and next(forced, None) is None
    # one CLUSTER per cohort (3 cohorts of 2, 2, 1), or per slot of each
    # request but the 4-token one, which retires in WARMUP
    assert len(idents) == (3 if engine == "cohort" else 4)
    assert seen["tokens"] >= 40
    print(f"{name} {engine}: {seen['held']} argmax calls held, "
          f"{seen['tokens']} margin-checked tokens, logits max abs diff "
          f"{seen['worst']:.2e}, {mixed[0]} mixed steps")
    if engine != "cohort":
        assert mixed[0] > 0
        assert teng.cluster_transitions == 4
    if teng.paged:
        hist = [{k: h[k] for k in HISTORY_KEYS}
                for h in teng.kv_bytes_history]
        assert hist == jhist
        # GQA keeps its dense K pages through CLUSTER: no clustered pool
        assert teng.chai_pool is None and all(
            h["chai_pages"] == 0 for h in hist)
        assert teng.dense_pool.pages_in_use == 0
    assert teng.kv_bytes() == jbytes


def test_layouts_and_schedulers_agree_inside_the_port(models):
    """Paged (the kernel default) and dense layouts decode bitwise alike
    at tile = page, and the cohort scheduler gives the same tokens."""
    _, jcfg, tcfg, _, tparams = models
    prompts = _prompts(jcfg.vocab_size, "paged")
    runs = {}
    for engine in ("paged", "dense", "cohort"):
        eng = ServingEngine(tcfg, tparams, EngineConfig(
            **_engine_cfg(ENGINES[engine])), device="cpu")
        for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(p, max_new_tokens=m, uid=i)
        runs[engine] = {r.uid: r.generated for r in eng.run()}
    assert runs["paged"] == runs["dense"] == runs["cohort"]


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(prefix_cache=True, relay_decode=True),
                                dict(relay_decode=True)],
                         ids=["prefix_cache", "relay", "relay_alone"])
def test_gqa_prefix_cache_and_relay_refused(models, kw):
    """A GQA model takes ``prefix_cache`` and ``relay_decode`` as an MHA
    model does (they were refused until the GQA branch was ported): the
    engine serves a request through the cache, and relay decode without
    the prefix cache is refused with the MHA model's ``ValueError``.
    ``tests/test_torch_gqa_prefix_relay.py`` holds both against the
    reference."""
    _, _, tcfg, _, tparams = models
    ecfg = EngineConfig(**_engine_cfg(kw))
    if not kw.get("prefix_cache"):
        with pytest.raises(ValueError, match="relay_decode requires"):
            ServingEngine(tcfg, tparams, ecfg, device="cpu")
        return
    eng = ServingEngine(tcfg, tparams, ecfg, device="cpu")
    assert eng.prefix_cache is not None and eng.chai_pool is None
    assert eng.relay_decode == bool(kw.get("relay_decode"))
    eng.submit(list(range(20)), max_new_tokens=3, uid=0)
    assert [len(r.generated) for r in eng.run()] == [3]
    eng.prefix_cache.clear()
    assert eng.dense_pool.pages_in_use == 0
