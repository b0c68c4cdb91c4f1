"""The port's first slice end to end against the JAX package, on the CPU.

A reduced chai-llama-7b (2 layers, d=64, 8 heads, fp32) with the
reference's own ``init_params`` weights, moved across by
``params_from_numpy``. Teacher-forced (the same token fed to both at each
step, so one near-tie cannot cascade): ragged bucketed prefill, every
WARMUP step and its ``chai_scores`` buffer, membership from the
reference's buffer (exact), and STEADY steps through the fused decode at
``decode_ts=16``. Logits at atol = rtol = 1e-4. Then both cohort
``ServingEngine``s serve the same requests, and greedy tokens must agree
at every step where the reference's top-2 logit margin exceeds 1e-3.
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
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.launch import steps as tsteps
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3
B, S, DECODE_TS = 3, 64, 16


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("chai-llama-7b"), n_layers=2)
    tcfg = reduced(get_config("chai-llama-7b"), n_layers=2)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def test_slice_teacher_forced(models, rng):
    jcfg, tcfg, jparams, tparams = models
    lens = np.array([20, 13, 7], np.int32)          # one 32-token bucket
    toks = np.zeros((B, 32), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, jcfg.vocab_size, size=n)

    # ---- PREFILL (ragged, bucketed) ----
    jl, jst = jax.jit(jsteps.make_serve_prefill(jcfg, B, S))(
        jparams, {"tokens": jnp.asarray(toks), "true_lens": jnp.asarray(lens)})
    tl, tst = tsteps.make_serve_prefill(tcfg, B, S)(
        tparams, {"tokens": _t(toks), "true_lens": _t(lens)})
    _close(tl, jl)
    np.testing.assert_array_equal(tst["pos"].numpy(), lens)
    np.testing.assert_array_equal(np.asarray(jst["pos"]), lens)

    # ---- WARMUP: MHA decode accumulating clustering features ----
    jst = jcache.add_score_buffer(jst, jcfg, B)
    tst = tcache.add_score_buffer(tst, tcfg, B)
    jmha = jax.jit(jsteps.make_serve_step(jcfg, chai=False,
                                          decode_ts=DECODE_TS))
    tmha = tsteps.make_serve_step(tcfg, chai=False, decode_ts=DECODE_TS)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(jcfg.chai.warmup_tokens):
        jl, jst = jmha(jparams, {"tokens": jnp.asarray(nxt)}, jst)
        tl, tst = tmha(tparams, {"tokens": _t(nxt)}, tst)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    _close(tst["chai_scores"], jst["chai_scores"], atol=1e-5, rtol=1e-4)

    # ---- CLUSTER: membership from the reference's buffer, exactly ----
    jst, jscores = jcache.pop_score_buffer(jst)
    tst, _ = tcache.pop_score_buffer(tst)
    jctx = jax.jit(lambda sc: jclust.identify_membership(sc, jcfg))(jscores)
    tctx = tclust.identify_membership(_t(jscores), tcfg)
    for key in ("h2c", "reps"):
        np.testing.assert_array_equal(tctx[key].numpy(), np.asarray(jctx[key]))

    # ---- COMPACT + STEADY: clustered decode through the fused op ----
    jst = jcache.compact_kv(jst, jctx, jcfg)
    tst = tcache.compact_kv(tst, tctx, tcfg)
    _close(tst["kg_chai"], jst["kg_chai"], atol=1e-5, rtol=1e-5)
    jchai = jax.jit(jsteps.make_serve_step(jcfg, chai=True,
                                           decode_ts=DECODE_TS))
    tchai = tsteps.make_serve_step(tcfg, chai=True, decode_ts=DECODE_TS)
    for _ in range(3):
        jl, jst = jchai(jparams, {"tokens": jnp.asarray(nxt)}, jst, jctx)
        tl, tst = tchai(tparams, {"tokens": _t(nxt)}, tst, tctx)
        _close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def _recording(store, fn):
    def wrapped(x):
        out = fn(x)
        store.append((x, out))
        return out
    return wrapped


def _serve_port(tcfg, tparams, prompts, max_new, identify=None):
    teng = ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=2, max_seq=S, scheduler="cohort"), device="cpu")
    calls = []
    teng._identify = _recording(calls, identify or teng._identify)
    for i, p in enumerate(prompts):
        teng.submit(p, max_new_tokens=max_new, uid=i)
    return teng, {r.uid: r.generated for r in teng.run()}, calls


def _pair_tie(h2c, j, rep_a, rep_b):
    """Cluster j has exactly the two members rep_a and rep_b: they are at
    the same distance from their center, so rounding picks the rep."""
    members = set(np.flatnonzero(h2c == j).tolist())
    return members == {int(rep_a), int(rep_b)}


def test_cohort_engines_agree(models, rng):
    """Both cohort engines serve the same requests greedily.

    Membership: the two engines' WARMUP buffers differ in the last bits,
    and the two members of a two-head cluster are equidistant from its
    center, so rounding may pick the other one as representative (the
    reference's own ragged-cohort test trips on the same tie). The test
    holds that any difference is such a tie, that the port computes the
    reference's membership exactly from the reference's buffer, and then
    holds every margin-checked token of a port engine that clusters
    through the reference's decisions (STEADY decode included), plus the
    tokens of the unmodified port engine up to any tie-flipped cohort's
    CLUSTER step."""
    jcfg, tcfg, jparams, tparams = models
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in (11, 6, 17)]
    max_new, warm = 10, jcfg.chai.warmup_tokens
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(
        batch_slots=2, max_seq=S, scheduler="cohort"))
    ref_logits, jcalls = [], []
    jeng._argmax = _recording(ref_logits, jeng._argmax)
    jeng._identify = _recording(jcalls, jeng._identify)
    for i, p in enumerate(prompts):
        jeng.submit(p, max_new_tokens=max_new, uid=i)
    jdone = {r.uid: r.generated for r in jeng.run()}
    teng, tdone, tcalls = _serve_port(tcfg, tparams, prompts, max_new)
    assert sorted(tdone) == [0, 1, 2]
    assert all(len(tdone[u]) == max_new for u in tdone)
    assert teng.steps_executed == jeng.steps_executed == 2 * (max_new - 1)

    # ---- membership: exact from the same buffer; ties only otherwise ----
    flipped = set()                       # (cohort, row) with a tie flip
    for c, ((jsc, jctx), (tsc, tctx)) in enumerate(zip(jcalls, tcalls)):
        _close(tsc, jsc, atol=1e-5, rtol=1e-4)
        same_buf = tclust.identify_membership(_t(jsc), tcfg)
        for key in ("h2c", "reps"):
            np.testing.assert_array_equal(same_buf[key].numpy(),
                                          np.asarray(jctx[key]))
        jh, th = np.asarray(jctx["h2c"]), tctx["h2c"].numpy()
        jr, tr = np.asarray(jctx["reps"]), tctx["reps"].numpy()
        np.testing.assert_array_equal(th, jh)
        for layer, row, j in np.argwhere(jr != tr):
            assert _pair_tie(jh[layer, row], j, jr[layer, row, j],
                             tr[layer, row, j]), (c, layer, row, j)
            flipped.add((c, row))

    # ---- tokens: the reference's membership, all steps margin-held ----
    def ref_identify(sc):
        jctx = jcalls[len(forced)][1]
        forced.append(sc)
        return {k: _t(v) for k, v in jctx.items()}
    forced = []
    _, fdone, _ = _serve_port(tcfg, tparams, prompts, max_new, ref_identify)

    where = {0: (0, 0), 1: (0, 1), 2: (1, 0)}   # uid -> (cohort, row)
    checked = 0
    for uid, (cohort, row) in where.items():
        free_steps = warm + 1 if (cohort, row) in flipped else max_new
        for name, done, steps in (("forced", fdone, max_new),
                                  ("free", tdone, free_steps)):
            for step in range(steps):
                lg = np.asarray(ref_logits[cohort * max_new + step][0])[row]
                top2 = np.sort(lg)[-2:]
                if top2[1] - top2[0] <= MARGIN:
                    print(f"{name} uid {uid} step {step}: reference margin "
                          f"{top2[1] - top2[0]:.2e} <= {MARGIN}, not held")
                    if done[uid][step] != jdone[uid][step]:
                        break                # inputs differ from here on
                    continue
                assert done[uid][step] == jdone[uid][step], (name, uid, step)
                checked += 1
    if flipped:
        print(f"tie-flipped (cohort, row): {sorted(flipped)}; their free-run "
              f"tokens held through step {warm}")
    assert checked >= 40
    for chai in (True, False):
        assert teng.kv_bytes(chai=chai) == jeng.kv_bytes(chai=chai)
    assert teng.kv_bytes() == jeng.kv_bytes(chai=True)
