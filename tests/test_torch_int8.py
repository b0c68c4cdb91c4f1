"""The port's int8 KV cache (``kv_cache_dtype="int8"``) served end to end
against the JAX package's, on the CPU.

Reduced chai-llama-7b (MHA) and reduced nemotron-4-15b (GQA), 2 layers,
fp32, hd 16, the reference's own ``init_params`` weights, with
``cfg.replace(kv_cache_dtype="int8")`` on both sides; the reference runs
its Pallas kernels in interpret mode, the port their plain versions.

* Engines in lockstep: the reference's cohort engine and continuous
  engine (paged, and paged with chunked prefill) serve 3 requests on 2
  slots; the port's engine of the same kind (and the port's dense layout
  against the reference's paged run: the same function, the same
  schedule) takes the reference's token at every step and its membership
  at every CLUSTER (after computing that membership exactly from the
  reference's buffer), so every step sees the same inputs: logits of
  every live row at atol = rtol = 1e-4, and the port's own greedy pick
  equal to the reference's wherever the reference's top-2 margin exceeds
  1e-3 (the margin rule of ``test_torch_gqa.py``; forcing the membership
  is the two-head-tie rule: a pair tie may flip the port's own pick).
  The page accounting (int8 page bytes) is held step by step.
* The MHA baseline (``use_chai=False``) under int8, paged, in lockstep
  the same way: its decode reads the dequantized view through the flash
  decode op (never ``paged_decode``: the flash pair has no scale mode).
* The prefix cache with relay decode under int8, in lockstep as
  ``tests/test_torch_prefix_cache.py`` holds it: phases, tables, ``pos``,
  refcounts, cache hits after every step, and every relay dict, the
  packed prefix codes within one code and their scale planes at 1e-5;
  held against the reference on the same path, not cached against cold.
* Inside the port: paged, dense and cohort give identical greedy tokens
  under int8 (page == tile), for both models and the MHA baseline.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.kernels import ops as tops
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

ARCHS = {"mha": "chai-llama-7b", "gqa": "nemotron-4-15b"}
ENGINES = {"cohort": dict(scheduler="cohort"),
           "paged": dict(kv_layout="paged"),
           "chunked": dict(kv_layout="paged", prefill_chunk_tokens=16,
                           max_seq=128)}
PROMPT_LENS = (11, 6, 17)
CHUNK_PROMPT_LENS = (40, 9, 33)
BUDGETS = (10, 7, 9)
TOL = dict(atol=1e-4, rtol=1e-4)
FEATURE_TOL = dict(atol=2e-3, rtol=0)
MARGIN = 1e-3
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages", "n_warmup",
                "n_steady")


def _int8(cfg):
    return cfg.replace(kv_cache_dtype="int8")


@pytest.fixture(scope="module", params=sorted(ARCHS))
def models(request):
    arch = ARCHS[request.param]
    jcfg = _int8(jreduced(jget_config(arch), n_layers=2))
    tcfg = _int8(reduced(get_config(arch), n_layers=2))
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _engine_cfg(ekw):
    return {"batch_slots": 2, "max_seq": 64, "page_size": 16, **ekw}


def _prompts(vocab, engine):
    rng = np.random.default_rng(0)
    lens = CHUNK_PROMPT_LENS if engine == "chunked" else PROMPT_LENS
    return [rng.integers(0, vocab, size=n) for n in lens]


def _reference_run(jcfg, jparams, prompts, ekw):
    """The reference engine's run: (argmax inputs and outputs per call,
    (scores, membership) per CLUSTER, tokens, page history, kv bytes)."""
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**_engine_cfg(ekw)))
    calls, idents = [], []
    argmax = jeng._argmax

    def rec_argmax(lg):
        out = argmax(lg)
        calls.append((np.asarray(lg), np.asarray(out)))
        return out
    jeng._argmax = rec_argmax
    if ekw.get("scheduler") == "cohort":
        identify = jeng._identify

        def rec_identify(sc):
            out = identify(sc)
            idents.append((np.asarray(sc),
                           {k: np.asarray(v) for k, v in out.items()}))
            return out
        jeng._identify = rec_identify
    elif ekw.get("use_chai", True):
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


def _lockstep(tcfg, tparams, prompts, ekw, reference):
    """The port's engine of kind ``ekw`` driven against a recorded
    reference run (see the module docstring). Returns (engine, tokens,
    margin-checked picks)."""
    calls, idents, jdone, _, _ = reference
    teng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(ekw)),
                         device="cpu")
    feed, forced = iter(calls), iter(idents)
    seen = {"tokens": 0}

    def lockstep_argmax(lg):
        want_lg, want_tok = next(feed)
        rows = _live_rows(teng, lg.shape[0])
        np.testing.assert_allclose(lg[rows].numpy(), want_lg[rows], **TOL)
        for i in rows:
            top2 = np.sort(want_lg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert int(lg[i].argmax()) == int(want_tok[i])
                seen["tokens"] += 1
        return torch.from_numpy(want_tok.astype(np.int64))

    def lockstep_identify(sc):
        want_sc, want_ctx = next(forced)
        # The two packages' fp32 K rows differ in the last bits, and a row
        # that sits on a rounding edge of ``quant_rows`` takes the
        # neighbouring code on one side: one code of one K row moves that
        # position's probability by ~1e-3 in every later WARMUP step. So
        # the features are held at FEATURE_TOL, nearly all of them at 1e-5.
        diff = np.abs(sc.numpy() - want_sc)
        np.testing.assert_allclose(sc.numpy(), want_sc, **FEATURE_TOL)
        assert np.mean(diff > 1e-5) < 0.02, np.mean(diff > 1e-5)
        same_buf = tclust.identify_membership(
            torch.from_numpy(want_sc.copy()), tcfg)
        for key in want_ctx:
            np.testing.assert_array_equal(same_buf[key].numpy(),
                                          want_ctx[key])
        return {k: torch.from_numpy(v.copy()) for k, v in want_ctx.items()}

    teng._argmax, teng._identify = lockstep_argmax, lockstep_identify
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        teng.submit(p, max_new_tokens=m, uid=i)
    tdone = {r.uid: r.generated for r in teng.run()}
    assert tdone == jdone                     # teacher-forced: same tokens
    assert next(feed, None) is None and next(forced, None) is None
    return teng, tdone, seen["tokens"]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_int8_engines_in_lockstep_with_reference(models, engine):
    name, jcfg, tcfg, jparams, tparams = models
    ekw = ENGINES[engine]
    prompts = _prompts(jcfg.vocab_size, engine)
    reference = _reference_run(jcfg, jparams, prompts, ekw)
    _, idents, _, jhist, jbytes = reference
    layouts = ([ekw, dict(ekw, kv_layout="dense")] if engine == "paged"
               else [ekw])
    for kw in layouts:
        teng, _, checked = _lockstep(tcfg, tparams, prompts, kw, reference)
        assert checked >= 20, checked
        # one CLUSTER per cohort (2 cohorts), or per request
        assert len(idents) == (2 if engine == "cohort" else 3)
        if teng.paged:
            hist = [{k: h[k] for k in HISTORY_KEYS}
                    for h in teng.kv_bytes_history]
            assert hist == jhist
            assert teng.dense_pool.pages_in_use == 0
            assert teng.kv_bytes() == jbytes == 0


def test_int8_mha_baseline_in_lockstep_with_reference(models, monkeypatch):
    """CHAI off under int8: the decode reads the dequantized view through
    the flash decode op on both layouts, never ``paged_decode``."""
    _, jcfg, tcfg, jparams, tparams = models
    prompts = _prompts(jcfg.vocab_size, "paged")
    ekw = dict(kv_layout="paged", use_chai=False)
    reference = _reference_run(jcfg, jparams, prompts, ekw)
    calls = {"flash": 0}
    flash = tops.flash_decode_attention

    def counted(*args, **kw):
        calls["flash"] += 1
        return flash(*args, **kw)

    def refused(*args, **kw):
        raise AssertionError("paged_decode on an int8 cache")

    monkeypatch.setattr(tops, "flash_decode_attention", counted)
    monkeypatch.setattr(tops, "paged_decode_attention", refused)
    for kw in (ekw, dict(ekw, kv_layout="dense")):
        teng, _, checked = _lockstep(tcfg, tparams, prompts, kw, reference)
        assert checked >= 15, checked
    decode_steps = sum(BUDGETS) - len(BUDGETS)
    assert calls["flash"] >= 2 * tcfg.n_layers * decode_steps // 2


def test_int8_layouts_and_schedulers_agree_inside_the_port(models):
    """Paged (the kernel default), dense and cohort decode alike under
    int8 (page == tile); so do the MHA baseline's layouts."""
    _, jcfg, tcfg, _, tparams = models
    prompts = _prompts(jcfg.vocab_size, "paged")
    runs = {}
    for name, ekw in (("paged", {}), ("dense", dict(kv_layout="dense")),
                      ("cohort", dict(scheduler="cohort")),
                      ("mha_paged", dict(use_chai=False)),
                      ("mha_dense", dict(use_chai=False, kv_layout="dense"))):
        eng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(ekw)),
                            device="cpu")
        for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(p, max_new_tokens=m, uid=i)
        runs[name] = {r.uid: r.generated for r in eng.run()}
    assert runs["paged"] == runs["dense"] == runs["cohort"]
    assert runs["mha_paged"] == runs["mha_dense"]


# ------------------------------------------------- prefix cache + relay ---
S, PAGE, SLOTS = 64, 16, 2
POOL_TOL = dict(atol=1e-5, rtol=1e-5)


def _slo_cfg(get, red):
    return _int8(red(get("chai-llama-7b"), n_layers=2, d_model=32, d_ff=64,
                     vocab=64).replace(dtype="float32").with_chai(
                         enabled=True, warmup_tokens=3))


def _ecfg(cls):
    return cls(batch_slots=SLOTS, max_seq=S, page_size=PAGE, num_pages=33,
               num_chai_pages=25, prefix_cache=True, relay_decode=True)


def _traffic():
    """A shared 32-token prefix warmed by a request that retires in
    WARMUP; two suffix requests (partial hits, a relay group of two); a
    miss; then request 1's prompt again (a snapshot hit)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 64, size=2 * PAGE).tolist()
    s = [rng.integers(0, 64, size=n).tolist() for n in (4, 5, 10)]
    warm = (0, prefix + [1], 4)
    rest = [(1, prefix + s[0], 8), (2, prefix + s[1], 8), (3, s[2], 5),
            (4, prefix + s[0], 8)]
    return warm, rest


def _codes_close(got, want, err_msg):
    """int8 codes within one code (the two packages' fp32 K/V may round to
    neighbouring codes), float tensors at POOL_TOL."""
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max(initial=0) <= 1, err_msg
    else:
        np.testing.assert_allclose(got, want, **POOL_TOL, err_msg=err_msg)


def test_int8_prefix_cache_relay_in_lockstep_with_reference():
    jcfg, tcfg = _slo_cfg(jget_config, jreduced), _slo_cfg(get_config,
                                                          reduced)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jeng = JServingEngine(jcfg, jparams, _ecfg(JEngineConfig))
    teng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig), device="cpu")
    calls, clusters, checked = [], [], []
    jargmax, jcluster = jeng._argmax, jeng._cluster_fn()

    def rec_argmax(lg):
        live = ([True] if lg.shape[0] == 1 else
                [r is not None and jeng._phases[i] != jcache.PHASE_PREFILL
                 for i, r in enumerate(jeng._slot_req)])
        tok = jargmax(lg)
        calls.append((np.asarray(lg), np.asarray(tok), live))
        return tok

    def rec_cluster(state, ctx, slot, *rest):
        state, ctx = jcluster(state, ctx, slot, *rest)
        clusters.append({k: np.array(v[:, int(slot)])
                         for k, v in ctx.items()})
        return state, ctx

    def port_argmax(lg):
        jlg, jtok, live = calls.pop(0)
        rows = [i for i, a in enumerate(live) if a]
        np.testing.assert_allclose(lg.numpy()[rows], jlg[rows], **TOL)
        own = torch.argmax(lg, dim=-1).numpy()
        for i in rows:
            top2 = np.sort(jlg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert own[i] == jtok[i]
                checked.append(1)
        return torch.from_numpy(jtok.astype(np.int64))

    jeng._argmax, jeng._cluster_slot = rec_argmax, rec_cluster
    teng._argmax = port_argmax
    teng._identify = lambda sc: {k: torch.from_numpy(v[:, None])
                                 for k, v in clusters.pop(0).items()}
    relays = {"ref": [], "port": []}
    for eng, side in ((jeng, "ref"), (teng, "port")):
        def built(active, _fn=eng._build_relay, _s=side):
            out = _fn(active)
            relays[_s].append(out)
            return out
        eng._build_relay = built
    n_relay = 0

    def run_until_idle():
        nonlocal n_relay
        while jeng.has_work():
            jeng.step()
            teng.step()
            assert not calls and not clusters
            np.testing.assert_array_equal(teng._phases, jeng._phases)
            js, ts = jeng._dev_state, teng._dev_state
            for key in ("kvp", "kvp_scale", "cp", "cp_scale"):
                _codes_close(ts[key][:, 1:], np.asarray(js[key])[:, 1:], key)
            for key in ("pos", "phase", "bt_kg", "bt_vg", "bt_kc"):
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]), key)
            for tp, jp in ((teng.dense_pool, jeng.dense_pool),
                           (teng.chai_pool, jeng.chai_pool)):
                assert tp._rc == jp._rc
            assert teng.relay_steps == jeng.relay_steps
            for trel, jrel in zip(relays["port"], relays["ref"]):
                assert (trel is None) == (jrel is None)
                if trel is None:
                    continue
                assert sorted(trel) == sorted(jrel)
                assert {"k_scale", "v_scale"} <= set(trel)
                for key in trel:
                    if trel[key].dtype in (torch.int32, torch.bool):
                        np.testing.assert_array_equal(
                            trel[key].numpy(), np.asarray(jrel[key]), key)
                    else:
                        _codes_close(trel[key], jrel[key], key)
                n_relay += 1
            relays["port"].clear()
            relays["ref"].clear()

    warm, rest = _traffic()
    for eng in (jeng, teng):
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
    run_until_idle()
    for uid, prompt, max_new in rest:
        for eng in (jeng, teng):
            eng.submit(prompt, max_new_tokens=max_new, uid=uid)
    run_until_idle()
    tdone = {r.uid: r for r in teng.done}
    jdone = {r.uid: r for r in jeng.done}
    assert {u: r.generated for u, r in tdone.items()} == \
        {u: r.generated for u, r in jdone.items()}
    assert {u: (r.cache_hit, r.cached_tokens) for u, r in tdone.items()} \
        == {u: (r.cache_hit, r.cached_tokens) for u, r in jdone.items()}
    assert tdone[4].cache_hit == "snapshot" and tdone[1].cache_hit == "prefix"
    assert n_relay > 0 and teng.relay_steps == n_relay
    assert len(checked) >= 15
    assert teng.kv_bytes_peak() == jeng.kv_bytes_peak()
    for eng in (teng, jeng):
        eng.prefix_cache.clear()
        assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
