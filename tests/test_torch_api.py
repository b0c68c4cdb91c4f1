"""The port's front door (``serving.api``: ``LLM``, ``stream``,
``Session``) and its sampling engines, on the CPU.

A reduced chai-llama-7b (MHA, clustered K pool and CHAI snapshots) and
nemotron-4-15b (GQA; dense pages live to retirement) with 2 layers, d 32,
vocab 64, fp32, warmup 3 (``tests/test_api_stream.py``'s models), on the
reference's own ``init_params`` weights.

Held against the reference's ``LLM`` on the same weights: greedy
``generate``, ``stream`` and ``Session`` tokens and the prefix-cache split
of every turn; stop strings truncate at the same token (the first match,
also on ``test_api_stream.py``'s inputs, where it comes after 4 tokens).
The port clusters through the reference's membership after checking its
own differs at most by a two-head tie (ROADMAP, "Two-head cluster ties").
Held inside the port (the reference draws from ``jax.random``): seeded
tokens equal across a repeat, the paged and dense layouts and the cohort
scheduler; streams, aborts and abandoned streams return every page;
concurrent callers drop no token; uids stay monotonic.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.serving.api import LLM as JLLM
from repro.serving.api import Session as JSession
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.serving import (LLM, EngineConfig, EngineCore,
                                 SamplingParams, ServingEngine, Session)
from repro_torch.serving.faults import FaultInjector, FaultSpec
from repro_torch.serving.sampling import scan_finish
from repro_torch.weights import params_from_numpy

MHA, GQA = "chai-llama-7b", "nemotron-4-15b"
GREEDY = dict(max_new_tokens=10)
SEEDED = dict(temperature=0.8, top_k=16, top_p=0.95, seed=5,
              max_new_tokens=10)
ECFG = dict(batch_slots=2, max_seq=128, page_size=16)


def detok(ids):
    return " ".join(map(str, ids))


@pytest.fixture(scope="module", params=[MHA, GQA])
def models(request):
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
    jcfg = jreduced(jget_config(request.param), **kw).replace(
        dtype="float32").with_chai(enabled=True, warmup_tokens=3)
    tcfg = reduced(get_config(request.param), **kw).with_chai(
        enabled=True, warmup_tokens=3)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _port_llm(models, **kw):
    _, tcfg, _, tparams = models
    return LLM(tcfg, tparams, EngineConfig(**{**ECFG, **kw}), device="cpu")


def _pools(core):
    return (core.dense_pool.counters(),
            core.chai_pool.counters() if core.chai_pool else None)


def _pair_tie(assign, j, rep_a, rep_b):
    members = set(np.flatnonzero(assign == j).tolist())
    return members == {int(rep_a), int(rep_b)}


def _hold_membership(jcore, tcore):
    """Record the reference core's membership at every CLUSTER transition
    (by uid); the port core clusters through it, after checking its own
    from its own buffer equals it up to two-head ties."""
    ref = {}
    cluster = jcore._cluster_fn()

    def rec(state, ctx, slot, *rest):
        i = int(slot)
        uid = jcore._slot_req[i].uid
        state, ctx = cluster(state, ctx, slot, *rest)
        ref[uid] = {k: np.array(v[:, i]) for k, v in ctx.items()}
        return state, ctx

    jcore._cluster_slot = rec
    own = tcore._identify

    def forced(sc):
        i = int(np.flatnonzero(tcore._phases == tcache.PHASE_CLUSTER)[0])
        mine = {k: v[:, 0].numpy() for k, v in own(sc).items()}
        want = ref[tcore._slot_req[i].uid]
        key = "h2c" if "h2c" in want else "cluster_of"
        np.testing.assert_array_equal(mine[key], want[key])
        assign = want[key].reshape(-1, want[key].shape[-1])
        for row, (a, b) in enumerate(zip(
                mine["reps"].reshape(len(assign), -1),
                want["reps"].reshape(len(assign), -1))):
            for j in np.flatnonzero(a != b):
                assert _pair_tie(assign[row], j, a[j], b[j]), (row, j)
        return {k: torch.from_numpy(v)[:, None] for k, v in want.items()}

    tcore._identify = forced


def _pair(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    jllm = JLLM(jcfg, jparams, JEngineConfig(**{**ECFG, **kw}),
                detokenizer=kw.pop("_detok", None))
    tllm = _port_llm(models, **kw)
    _hold_membership(jllm.core, tllm.core)
    return jllm, tllm


def test_greedy_front_door_matches_reference(models):
    """generate (a batch, then one prompt again), stream and a 3-turn
    Session on the prefix cache: the reference's tokens, finish reasons
    and cached / prefilled splits."""
    jllm, tllm = _pair(models, prefix_cache=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=n) for n in (8, 11, 20)]
    jout = jllm.generate(prompts, JSamplingParams(**GREEDY))
    tout = tllm.generate(prompts, SamplingParams(**GREEDY))
    jout += jllm.generate(prompts[0], JSamplingParams(**GREEDY))
    tout += tllm.generate(prompts[0], SamplingParams(**GREEDY))
    for j, t in zip(jout, tout):
        assert t.token_ids == j.token_ids
        assert (t.finish_reason, t.cached_tokens, t.prefill_tokens) == \
            (j.finish_reason, j.cached_tokens, j.prefill_tokens)
    jchunks = list(jllm.stream(prompts[1], JSamplingParams(**GREEDY)))
    tchunks = list(tllm.stream(prompts[1], SamplingParams(**GREEDY)))
    assert [c.token_ids for c in tchunks] == [c.token_ids for c in jchunks]
    assert len(tchunks) > 1 and tchunks[-1].finished
    jses = JSession(jllm, JSamplingParams(max_new_tokens=8))
    tses = Session(tllm, SamplingParams(max_new_tokens=8))
    for n in (32, 6, 6):
        msg = rng.integers(0, 64, size=n)
        j, t = jses.send(msg), tses.send(msg)
        assert t.token_ids == j.token_ids
        assert (t.cached_tokens, t.prefill_tokens) == \
            (j.cached_tokens, j.prefill_tokens)
    assert tses.turns[1].cached_tokens > 0 and tses.turns[2].cached_tokens
    assert tses.history == jses.history
    for llm in (jllm, tllm):
        llm.core.prefix_cache.clear()
    assert tllm.core.dense_pool.pages_in_use == 0


def _seeded_subs(cfg):
    rng = np.random.default_rng(2)
    sps = [SamplingParams(temperature=0.8, top_k=16, top_p=0.95,
                          seed=100 + i, max_new_tokens=m)
           for i, m in enumerate((12, 5, 9, 7))]
    return [(rng.integers(0, cfg.vocab_size, size=8), sp) for sp in sps]


def _serve(models, subs, **kw):
    _, tcfg, _, tparams = models
    eng = ServingEngine(tcfg, tparams, EngineConfig(**{**ECFG, **kw}),
                        device="cpu")
    for i, (p, sp) in enumerate(subs):
        eng.submit(p, max_new_tokens=sp.max_new_tokens, uid=i, sampling=sp)
    done = {r.uid: r for r in eng.run()}
    assert sorted(done) == list(range(len(subs)))
    return done


def test_seeded_tokens_repeat_across_layouts_and_schedulers(models):
    """The same seeded requests give the same tokens on a second LLM, on
    the paged and dense layouts and on the cohort scheduler; other seeds
    give other tokens."""
    subs = _seeded_subs(models[1])
    prompts, sps = zip(*subs)
    first = [o.token_ids for o in _port_llm(models).generate(prompts, sps)]
    assert [o.token_ids for o in _port_llm(models).generate(prompts, sps)] \
        == first
    for kw in (dict(), dict(kv_layout="dense"), dict(scheduler="cohort")):
        done = _serve(models, subs, **kw)
        assert [done[i].generated for i in range(len(subs))] == first, kw
    assert [len(t) for t in first] == [sp.max_new_tokens for sp in sps]
    alt = [SamplingParams(**{**SEEDED, "seed": sp.seed + 1000,
                             "max_new_tokens": sp.max_new_tokens})
           for sp in sps]
    other = [o.token_ids for o in _port_llm(models).generate(prompts, alt)]
    assert other != first


@pytest.mark.parametrize("scheduler,layout", [("continuous", "paged"),
                                              ("continuous", "dense"),
                                              ("cohort", "paged")])
def test_sampling_stops_and_greedy_false_serve(models, scheduler, layout):
    """temperature > 0 with top-k and top-p, stop strings with a
    detokenizer, and EngineConfig(greedy=False) serve on both schedulers
    and both layouts, with the same tokens on each."""
    _, tcfg, _, tparams = models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=n) for n in (7, 12, 9)]
    probe = _serve(models, [(prompts[1], SamplingParams(max_new_tokens=10))])
    stop = detok(probe[0].generated[2:4])
    sps = [SamplingParams(**SEEDED), SamplingParams(stop=(stop,),
                                                    max_new_tokens=10),
           None]
    want = []
    for sched, lay in (("continuous", "paged"), (scheduler, layout)):
        eng = ServingEngine(tcfg, tparams, EngineConfig(
            batch_slots=2, max_seq=64, scheduler=sched, kv_layout=lay,
            greedy=False), detokenizer=detok, device="cpu")
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            eng.submit(p, max_new_tokens=10, uid=i, sampling=sp)
        done = {r.uid: r for r in eng.run()}
        want.append([(done[i].generated, done[i].finish_reason)
                     for i in range(3)])
    assert want[1] == want[0]
    (seeded, _), (stopped, reason), (default, _) = want[1]
    assert stopped == scan_finish(probe[0].generated, sps[1], 10,
                                  detok)[0]
    assert reason == "stop" and len(stopped) <= 4
    assert len(seeded) == len(default) == 10


def test_stop_strings_truncate_where_the_reference_does(models):
    """The first-match rule on ``test_api_stream.py``'s inputs (prompt
    from seed 6, stop string = tokens 3 and 4 of the probe): the port
    stops where the reference stops, at ``scan_finish`` of the unstopped
    tokens; a stop string without a detokenizer raises ValueError."""
    jcfg, tcfg, jparams, tparams = models
    jllm = JLLM(jcfg, jparams, JEngineConfig(batch_slots=2, max_seq=64),
                detokenizer=detok)
    tllm = LLM(tcfg, tparams, EngineConfig(batch_slots=2, max_seq=64),
               detokenizer=detok, device="cpu")
    _hold_membership(jllm.core, tllm.core)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, size=8)
    jprobe = jllm.generate(prompt, JSamplingParams(max_new_tokens=8))[0]
    probe = tllm.generate(prompt, SamplingParams(max_new_tokens=8))[0]
    assert probe.token_ids == jprobe.token_ids
    assert probe.text == detok(probe.token_ids)
    for lo in (3, 1, 5):
        stop = detok(probe.token_ids[lo:lo + 2])
        j = jllm.generate(prompt, JSamplingParams(max_new_tokens=8,
                                                  stop=(stop,)))[0]
        sp = SamplingParams(max_new_tokens=8, stop=(stop,))
        t = tllm.generate(prompt, sp)[0]
        assert (t.token_ids, t.finish_reason, t.text) == \
            (j.token_ids, j.finish_reason, j.text)
        assert (t.token_ids, t.finish_reason) == \
            scan_finish(probe.token_ids, sp, 8, detok)
        assert t.finish_reason == "stop" and len(t.token_ids) <= lo + 2
    if jcfg.name == MHA:
        # test_api_stream.py's case: "47 47" completes at token 3
        stop = detok(probe.token_ids[3:5])
        assert len(tllm.generate(prompt, SamplingParams(
            max_new_tokens=8, stop=(stop,)))[0].token_ids) == 4
    with pytest.raises(ValueError, match="detokenizer"):
        _port_llm(models).generate(prompt, SamplingParams(stop=("x",)))
    with pytest.raises(ValueError, match="detokenizer"):
        EngineCore(tcfg, tparams, EngineConfig(), device="cpu").add_request(
            prompt, SamplingParams(stop=("x",)))


@pytest.mark.parametrize("kw", [GREEDY, SEEDED], ids=["greedy", "seeded"])
def test_stream_abort_and_abandon_return_every_page(models, kw):
    """abort() after the first chunk ends the stream with an empty
    "aborted" chunk; abandoned streams (more than there are slots) abort
    their requests; a stream closed before its first __next__ enqueues
    nothing; every pool returns to its baseline and the engine serves on."""
    llm = _port_llm(models, prefix_cache=True)
    sp = SamplingParams(**kw)
    rng = np.random.default_rng(9)
    want = llm.generate(rng.integers(0, 64, size=8), sp)[0]
    llm.core.prefix_cache.clear()
    base = _pools(llm.core)
    it = llm.stream(rng.integers(0, 64, size=8), sp)
    first = next(it)
    assert not first.finished and first.token_ids
    assert llm.abort(first.uid) is True
    tail = list(it)
    assert len(tail) == 1 and tail[0].finished and tail[0].token_ids == []
    assert tail[0].finish_reason == "aborted"
    uids = []
    for _ in range(3):
        it = llm.stream(rng.integers(0, 64, size=8), sp)
        uids.append(next(it).uid)
        it.close()
    llm.stream(rng.integers(0, 64, size=8), sp).close()
    assert not llm.core.queue and not llm.core.has_work()
    aborted = [r for r in llm.core.reap_done() if r.uid in uids]
    assert [r.finish_reason for r in aborted] == ["aborted"] * 3
    llm.core.prefix_cache.clear()
    assert _pools(llm.core) == base
    out = llm.generate(rng.integers(0, 64, size=8), sp)[0]
    assert len(out.token_ids) == len(want.token_ids)


def test_stream_never_drops_tokens_under_concurrent_callers(models):
    """A generate() that runs the streamed request to its end before the
    stream is read, and two interleaved streams: every token arrives."""
    llm = _port_llm(models)
    rng = np.random.default_rng(8)
    p1, p2 = (rng.integers(0, 64, size=8) for _ in range(2))
    sp = SamplingParams(**SEEDED)
    want1 = llm.generate(p1, sp)[0].token_ids
    want2 = llm.generate(p2, sp)[0].token_ids
    it = llm.stream(p1, sp)
    first = next(it).token_ids
    llm.generate(p2, sp)
    assert first + [t for c in it for t in c.token_ids] == want1
    it1, it2 = llm.stream(p1, sp), llm.stream(p2, sp)
    got = {1: [], 2: []}
    live = {1: it1, 2: it2}
    while live:
        for key in list(live):
            c = next(live[key], None)
            if c is None:
                del live[key]
            else:
                got[key] += c.token_ids
    assert got == {1: want1, 2: want2}
    bg = llm.core.add_request(p1, sp)
    assert [t for c in llm.stream(p2, sp) for t in c.token_ids] == want2
    assert bg.finished and bg.generated == want1


def test_uids_stay_monotonic_and_front_door_refusals(models):
    llm = _port_llm(models)
    rng = np.random.default_rng(7)
    uids = [llm.generate(rng.integers(0, 64, size=8),
                         SamplingParams(max_new_tokens=2))[0].uid
            for _ in range(3)]
    assert len(set(uids)) == 3 and uids == sorted(uids)
    req = llm.core.add_request(rng.integers(0, 64, size=8),
                               SamplingParams(max_new_tokens=2), uid=50)
    nxt = llm.core.add_request(rng.integers(0, 64, size=8),
                               SamplingParams(max_new_tokens=2))
    assert (req.uid, nxt.uid) == (50, 51)
    assert llm.core.next_arrival() == req.t_arrival
    while llm.core.has_work():
        llm.core.step()
    assert llm.core.next_arrival() is None
    assert {r.uid for r in llm.core.reap_done()} == {50, 51}
    assert llm.core.done == []
    _, tcfg, _, tparams = models
    faulted = LLM(tcfg, tparams, EngineConfig(**ECFG), device="cpu",
                  faults=FaultInjector([FaultSpec("pool.alloc",
                                                  mode="transient")]))
    out = faulted.generate(rng.integers(0, 64, size=8),
                           SamplingParams(max_new_tokens=2))[0]
    assert out.finish_reason == "length" and len(out.token_ids) == 2
    assert [f["site"] for f in faulted.core.faults.fired] == ["pool.alloc"]
    with pytest.raises(ValueError, match="continuous"):
        LLM(tcfg, tparams, scheduler="cohort", device="cpu")
    out = llm.generate(rng.integers(0, 64, size=8), priority=1)[0]
    assert out.request.priority == 1 and out.finish_reason == "length"
