"""The port's continuous engine against the JAX package's, on the CPU.

A reduced chai-llama-7b (2 layers, d=64, 8 heads, fp32) with the
reference's own ``init_params`` weights. Both engines run
``scheduler="continuous"`` with 2 slots, max_seq 64 and page 16 over 5
requests of mixed prompt lengths and budgets, so slots are reused and
WARMUP and STEADY slots share mixed-phase steps; the reference runs its
Pallas ``paged_chai_fused_decode`` in interpret mode (its CPU default).

Held exactly: the page accounting at every step (``steps_executed``, the
``kv_bytes_history`` records, the pools' pages in use) and the
membership the port computes from the reference's WARMUP buffer. Greedy
tokens are held at every step where the reference's top-2 logit margin
exceeds 1e-3, with the same rule for pair ties in membership as
``test_torch_slice.py::test_cohort_engines_agree``. Inside the port: the
paged and dense layouts give identical tokens, the continuous and cohort
schedulers give identical tokens, the phase vector follows each slot's
lifecycle, and ``abort`` / ``run()`` return every page.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.sampling import SamplingParams
from repro_torch.weights import params_from_numpy

S, PAGE, SLOTS = 64, 16, 2
PROMPT_LENS = (11, 6, 17, 9, 14)
BUDGETS = (12, 7, 10, 4, 9)
MARGIN = 1e-3
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages", "n_warmup",
                "n_steady")


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("chai-llama-7b"), n_layers=2)
    tcfg = reduced(get_config("chai-llama-7b"), n_layers=2)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in PROMPT_LENS]
    return jcfg, tcfg, jparams, tparams, prompts


def _drive(eng, prompts):
    """Submit every request, then step to the end; returns ({uid:
    tokens}, per-step (steps_executed, dense pages, clustered pages))."""
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(p, max_new_tokens=m, uid=i)
    trace = []
    while eng.has_work():
        eng.step()
        trace.append((eng.steps_executed, eng.dense_pool.pages_in_use,
                      eng.chai_pool.pages_in_use))
    done = {r.uid: list(r.generated) for r in eng.done}
    assert sorted(done) == list(range(len(prompts)))
    assert [len(done[u]) for u in sorted(done)] == list(BUDGETS)
    return done, trace


def _clustering_slot(eng):
    """The slot whose CLUSTER transition is running (both engines set the
    host phase to CLUSTER just before the call)."""
    slots = np.flatnonzero(eng._phases == tcache.PHASE_CLUSTER)
    assert len(slots) == 1
    return int(slots[0])


def _port_engine(tcfg, tparams, kv_layout="paged", scheduler="continuous"):
    return ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=SLOTS, max_seq=S, page_size=PAGE, scheduler=scheduler,
        kv_layout=kv_layout), device="cpu")


@pytest.fixture(scope="module")
def reference_run(models):
    """The JAX engine's run, with every argmax input and every CLUSTER
    transition's (uid, scores, membership) recorded."""
    jcfg, _, jparams, _, prompts = models
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(
        batch_slots=SLOTS, max_seq=S, page_size=PAGE))
    calls, clusters = [], []
    argmax, cluster = jeng._argmax, jeng._cluster_fn()

    def rec_argmax(lg):
        calls.append((np.asarray(lg),
                      [r.uid if r is not None else None
                       for r in jeng._slot_req]))
        return argmax(lg)

    def rec_cluster(state, ctx, slot, *rest):
        i = _clustering_slot(jeng)
        assert i == int(slot)
        scores = np.array(state["chai_scores"][:, i])
        state, ctx = cluster(state, ctx, slot, *rest)
        clusters.append((jeng._slot_req[i].uid, scores,
                         {k: np.array(v[:, i]) for k, v in ctx.items()}))
        return state, ctx

    jeng._argmax = rec_argmax
    jeng._cluster_slot = rec_cluster
    done, trace = _drive(jeng, prompts)
    # Reference logits row behind every generated token, per uid: the
    # k-th prefill (batch-1 logits) is uid k's (FIFO admission), then one
    # row per decode step at the uid's slot.
    rows = {u: [] for u in range(len(prompts))}
    n_prefill = 0
    for lg, uids in calls:
        if lg.shape[0] == 1:
            rows[n_prefill].append(lg[0])
            n_prefill += 1
            continue
        for i, u in enumerate(uids):
            if u is not None:
                rows[u].append(lg[i])
    assert [len(rows[u]) for u in sorted(rows)] == list(BUDGETS)
    return jeng, done, trace, rows, clusters


@pytest.fixture(scope="module")
def port_run(models):
    """The port's paged run with every identification call recorded."""
    _, tcfg, _, tparams, prompts = models
    teng = _port_engine(tcfg, tparams)
    calls = []
    identify = teng._identify

    def rec_identify(sc):
        out = identify(sc)
        calls.append((teng._slot_req[_clustering_slot(teng)].uid,
                      sc[:, 0].numpy().copy(),
                      {k: v[:, 0].numpy().copy() for k, v in out.items()}))
        return out

    teng._identify = rec_identify
    done, trace = _drive(teng, prompts)
    return teng, done, trace, calls


def _pair_tie(h2c, j, rep_a, rep_b):
    """Cluster j has exactly the two members rep_a and rep_b: they are at
    the same distance from their center, so rounding picks the rep."""
    members = set(np.flatnonzero(h2c == j).tolist())
    return members == {int(rep_a), int(rep_b)}


def test_page_accounting_matches_reference(reference_run, port_run):
    jeng, _, jtrace, _, _ = reference_run
    teng, _, ttrace, _ = port_run
    assert teng.steps_executed == jeng.steps_executed
    assert ttrace == jtrace                # pages in use after every step
    assert len(teng.kv_bytes_history) == len(jeng.kv_bytes_history)
    for t, j in zip(teng.kv_bytes_history, jeng.kv_bytes_history):
        assert {k: t[k] for k in HISTORY_KEYS} == \
            {k: j[k] for k in HISTORY_KEYS}
    # the trajectory falls at a CLUSTER transition and ends empty
    assert any(b["kv_bytes"] < a["kv_bytes"] and b["step"] == a["step"]
               for a, b in zip(teng.kv_bytes_history,
                               teng.kv_bytes_history[1:]))
    assert teng.kv_bytes() == jeng.kv_bytes() == 0
    assert teng.kv_bytes_peak() == jeng.kv_bytes_peak()
    assert teng.kv_bytes_capacity() == jeng.kv_bytes_capacity()
    # every request but the 4-token one reaches STEADY
    assert teng.cluster_transitions == jeng.cluster_transitions == 4


def test_membership_and_greedy_tokens_match_reference(models, reference_run,
                                                       port_run):
    """Membership: the port computes the reference's membership exactly
    from the reference's buffer; its own buffer may differ in the last
    bits and flip the representative of a two-head cluster (a pair tie).
    Tokens: a port engine that clusters through the reference's decisions
    matches every margin-checked token; the unmodified port engine
    matches them too, except after the CLUSTER step of a request whose
    representative flipped."""
    jcfg, tcfg, _, tparams, prompts = models
    _, jdone, _, rows, jclusters = reference_run
    _, tdone, _, tcalls = port_run
    warm = jcfg.chai.warmup_tokens
    assert len(tcalls) == len(jclusters)
    flipped = set()
    for (juid, jsc, jctx), (tuid, tsc, tctx) in zip(jclusters, tcalls):
        assert juid == tuid
        np.testing.assert_allclose(tsc, jsc, atol=1e-5, rtol=1e-4)
        same_buf = tclust.identify_membership_slot(torch.from_numpy(jsc),
                                                   tcfg)
        for key in ("h2c", "reps"):
            np.testing.assert_array_equal(same_buf[key].numpy(), jctx[key])
        np.testing.assert_array_equal(tctx["h2c"], jctx["h2c"])
        for layer, j in np.argwhere(tctx["reps"] != jctx["reps"]):
            assert _pair_tie(jctx["h2c"][layer], j, jctx["reps"][layer, j],
                             tctx["reps"][layer, j]), (juid, layer, j)
            flipped.add(juid)

    # ---- the port clustering through the reference's decisions ----
    teng = _port_engine(tcfg, tparams)
    forced = iter(jclusters)

    def ref_identify(sc):
        uid, _, jctx = next(forced)
        assert teng._slot_req[_clustering_slot(teng)].uid == uid
        return {k: torch.from_numpy(v[:, None]) for k, v in jctx.items()}

    teng._identify = ref_identify
    fdone, _ = _drive(teng, prompts)

    checked = 0
    for uid in sorted(jdone):
        free_steps = warm + 1 if uid in flipped else BUDGETS[uid]
        for name, done, steps in (("forced", fdone, BUDGETS[uid]),
                                  ("free", tdone, free_steps)):
            for step in range(steps):
                top2 = np.sort(rows[uid][step])[-2:]
                if top2[1] - top2[0] <= MARGIN:
                    print(f"{name} uid {uid} step {step}: reference margin "
                          f"{top2[1] - top2[0]:.2e} <= {MARGIN}, not held")
                    if done[uid][step] != jdone[uid][step]:
                        break                # inputs differ from here on
                    continue
                assert done[uid][step] == jdone[uid][step], (name, uid, step)
                checked += 1
    if flipped:
        print(f"tie-flipped uids: {sorted(flipped)}; their free-run tokens "
              f"held through step {warm}")
    assert checked >= 50


def test_paged_and_dense_layouts_give_identical_tokens(models, port_run):
    """Same batch shapes, same bits: the dense layout's fused decode runs
    at tile = page, and masked positions contribute exact zeros."""
    _, tcfg, _, tparams, prompts = models
    _, paged_done, _, _ = port_run
    eng = _port_engine(tcfg, tparams, kv_layout="dense")
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(p, max_new_tokens=m, uid=i)
    dense_done = {r.uid: r.generated for r in eng.run()}
    assert dense_done == paged_done
    assert not eng.paged and "kg_chai" in eng._dev_state
    assert eng.kv_bytes() == tcache.unified_kv_bytes(tcfg, SLOTS, S)


def test_continuous_matches_cohort_tokens(models, port_run):
    """The reference's ``test_greedy_parity_continuous_vs_cohort``, inside
    the port: one request per slot prefill (batch 1, its own bucket) and
    the cohort's ragged prefill (batch 2, one bucket) give the same
    tokens on these inputs, exactly."""
    _, tcfg, _, tparams, prompts = models
    _, cont, _, _ = port_run
    eng = _port_engine(tcfg, tparams, scheduler="cohort")
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(p, max_new_tokens=m, uid=i)
    coh = {r.uid: r.generated for r in eng.run()}
    assert coh == cont
    # slot scheduling interleaved phases: fewer batched steps than tokens
    assert max(BUDGETS) < port_run[0].steps_executed < sum(BUDGETS)


def test_phase_vector_tracks_slot_lifecycle(models):
    """The device phase vector mirrors the host's after every step, and
    each slot goes FREE -> WARMUP -> STEADY -> FREE; a mixed-phase step
    (WARMUP and STEADY slots together) happens."""
    _, tcfg, _, tparams, prompts = models
    assert (tcache.PHASE_FREE < tcache.PHASE_PREFILL < tcache.PHASE_WARMUP
            < tcache.PHASE_CLUSTER < tcache.PHASE_STEADY)
    eng = _port_engine(tcfg, tparams)
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        eng.submit(p, max_new_tokens=m, uid=i)
    seen = {i: [tcache.PHASE_FREE] for i in range(SLOTS)}
    mixed = False
    while eng.has_work():
        eng.step()
        dev = eng._dev_state["phase"].numpy()
        np.testing.assert_array_equal(dev, eng._phases)
        mixed |= {tcache.PHASE_WARMUP, tcache.PHASE_STEADY} <= set(dev)
        for i in range(SLOTS):
            if seen[i][-1] != dev[i]:
                seen[i].append(int(dev[i]))
        for i in range(SLOTS):       # a FREE slot's tables are all null
            if dev[i] == tcache.PHASE_FREE:
                for key in ("bt_kg", "bt_vg", "bt_kc"):
                    assert not eng._dev_state[key][i].any()
    assert mixed
    # After every step a slot is FREE, WARMUP or STEADY; a request that
    # finishes within its warmup retires straight from WARMUP.
    free, warmup, steady = (tcache.PHASE_FREE, tcache.PHASE_WARMUP,
                            tcache.PHASE_STEADY)
    legal = {(free, warmup), (warmup, steady), (warmup, free),
             (steady, free)}
    moves = {m for path in seen.values() for m in zip(path, path[1:])}
    assert moves <= legal and moves == legal, moves
    assert all(path[-1] == free for path in seen.values())


def test_abort_returns_every_page(models):
    _, tcfg, _, tparams, prompts = models
    eng = _port_engine(tcfg, tparams)
    reqs = [eng.submit(p, max_new_tokens=m, uid=i)
            for i, (p, m) in enumerate(zip(prompts, BUDGETS))]
    for _ in range(7):               # slot 0 reaches STEADY (5 WARMUP steps)
        eng.step()
    assert eng.dense_pool.pages_in_use and eng.chai_pool.pages_in_use
    running = [r for r in eng._slot_req if r is not None]
    assert running and eng.abort(running[0].uid)
    assert running[0].finish_reason == "aborted"
    assert running[0].generated
    queued = eng.queue[-1]
    assert eng.abort(queued.uid) and queued.generated == []
    assert not eng.abort(queued.uid) and not eng.abort(999)
    for r in list(eng._slot_req):
        if r is not None:
            eng.abort(r.uid)
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    assert eng.dense_pool.counters()["refs"] == 0
    eng.run()                        # the rest still serves
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    assert {r.uid for r in eng.done} == {r.uid for r in reqs}


def test_exhausted_pool_queues_then_raises_when_impossible(models):
    """Page-budget admission: a pool that covers one request at a time
    serves them one after the other; a request no pool can cover raises
    once the engine is idle."""
    _, tcfg, _, tparams, prompts = models
    need = 2 * tcache.pages_needed(len(prompts[2]) + BUDGETS[2], PAGE)
    eng = ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=SLOTS, max_seq=S, page_size=PAGE, num_pages=need + 1),
        device="cpu")
    for i in (0, 2):
        eng.submit(prompts[i], max_new_tokens=BUDGETS[i], uid=i)
    eng.step()
    assert sum(r is not None for r in eng._slot_req) == 1
    done = eng.run()
    assert [len(r.generated) for r in done] == [BUDGETS[0], BUDGETS[2]]
    small = ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=SLOTS, max_seq=S, page_size=PAGE, num_pages=3),
        device="cpu")
    small.submit(prompts[2], max_new_tokens=BUDGETS[2])
    with pytest.raises(MemoryError, match="pages"):
        small.step()


@pytest.mark.parametrize("kw", [
    dict(sampling=SamplingParams(temperature=0.7)),
    dict(sampling=SamplingParams(stop=("x",))),
    dict(priority=1),
    dict(greedy_default_off=True),
], ids=["temperature", "stop_strings", "priority", "greedy_false"])
def test_unported_settings_raise(models, kw):
    """Settings the port once refused now serve and return every page:
    sampling with temperature > 0, stop strings (with the engine's
    detokenizer) and ``greedy=False`` since the front door and the sampler
    were ported, and a ``priority`` since preemption was (alone in the
    engine it preempts nothing)."""
    _, tcfg, _, tparams, prompts = models
    greedy = not kw.pop("greedy_default_off", False)
    eng = ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=SLOTS, max_seq=S, greedy=greedy),
        detokenizer=lambda ids: " ".join(map(str, ids)), device="cpu")
    req = eng.add_request(prompts[0], max_new_tokens=4, **kw)
    assert req.priority == kw.get("priority", 0)
    assert req.sampling.greedy == (bool(req.sampling.stop)
                                   or "priority" in kw)
    done = eng.run()
    assert done == [req] and len(req.generated) == 4
    assert req.finish_reason == "length"
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    assert eng.preemptions == req.preemptions == 0
