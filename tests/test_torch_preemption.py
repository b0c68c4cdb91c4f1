"""The port's priority preemption against the JAX package's, on the CPU.

The reduced fp32 models of ``tests/test_slo_serving.py`` (2 layers, d 32,
vocab 64, warmup 3; chai-llama-7b (MHA) and nemotron-4-15b (GQA)) with the
reference's own weights (``weights.params_from_numpy``), page 16 and
``num_pages`` / ``num_chai_pages`` 10: one request's worth of pages.

* The slot swap (``core.cache.save_slot_paged`` / ``load_slot_paged``) on
  one paged state made from a seed with numpy: every column and page bit
  for bit the reference's, MHA, GQA, int8, bf16 and ``share_values``.
* The engines in lockstep on the reference's storms
  (``test_preempt_resume_identical_output``, ``test_preempt_in_early_phase``,
  ``test_preemption_storm_pool_baseline``), the port taking the
  reference's tokens and memberships: after every step the preemption
  counts, the queue's uid order, each slot's uid and phase, the pool
  counters, ``tiers.tier_pages()``, every pool page but the null page 0,
  the tables, ``pos`` and the scores equal; live logits at 1e-4; the
  port's own greedy pick on every step whose reference top-2 margin
  exceeds 1e-3.
* Inside the port: a preempted request's tokens, greedy and seeded, equal
  its uninterrupted run's bit for bit (MHA, GQA, int8, ``share_values``,
  a WARMUP victim, a chunked mid-PREFILL victim), the pools return to
  their base and the deep audit passes after every step;
  ``preemption=False`` is FIFO; the dense layout serves priorities
  without preempting; the cohort forms its cohorts by priority as the
  reference's does.
* The reference's fault, tier and telemetry tests of preemption
  (``test_swap_corruption_fault_is_quarantined_at_swap_in``,
  ``test_offload_in_fault_at_swap_in_quarantines_victim``,
  ``test_preemption_swaps_through_host_pool``,
  ``test_timeline_preempt_and_resume_events``) on both packages, the same
  plan and seed: finish reasons, errors, tokens, every fault counter and
  firing, the tier transitions and, at "trace", every metric, span and
  timeline equal.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import EngineCore as JEngineCore
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.serving import LLM, invariants
from repro_torch.serving.engine import (EngineConfig, EngineCore,
                                        ServingEngine)
from repro_torch.serving.sampling import FINISH_ERROR, SamplingParams
from repro_torch.weights import params_from_numpy
from test_torch_faults import _cores, _drain, _prompts
from test_torch_telemetry import _counter_value, _hold_telemetry

MHA, GQA = "chai-llama-7b", "nemotron-4-15b"
STORM = dict(batch_slots=2, max_seq=128, page_size=16, num_pages=10,
             num_chai_pages=10, audit_level="deep")
MARGIN = 1e-3
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)

_models = {}


def _models_of(arch):
    if arch not in _models:
        kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
        jcfg = jreduced(jget_config(arch), **kw).replace(
            dtype="float32").with_chai(enabled=True, warmup_tokens=3)
        tcfg = reduced(get_config(arch), **kw).with_chai(enabled=True,
                                                         warmup_tokens=3)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _models[arch] = (jcfg, tcfg, jparams, tparams)
    return _models[arch]


def _pool_counters(core):
    out = {"dense": core.dense_pool.counters()}
    if core.chai_pool is not None:
        out["chai"] = core.chai_pool.counters()
    return out


def _bits(x):
    """A tensor's or array's values as integers of its width (bf16 and
    floats compared bit for bit)."""
    a = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) and \
        x.dtype == torch.bfloat16 else np.asarray(x)
    if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
        return a.view(np.dtype(f"int{a.dtype.itemsize * 8}"))
    return a


# ------------------------------------------------------------ slot swap ---
SWAP_S, SWAP_PAGE, SWAP_SLOTS, SWAP_DENSE, SWAP_CHAI = 64, 8, 3, 16, 13
SWAP_CASES = {
    "mha": (MHA, lambda c: c),
    "gqa": (GQA, lambda c: c),
    "int8": (MHA, lambda c: c.replace(kv_cache_dtype="int8")),
    "bf16": (MHA, lambda c: c.replace(dtype="bfloat16")),
    "share": (MHA, lambda c: c.with_chai(share_values=True)),
    "share_int8": (MHA, lambda c: c.with_chai(share_values=True).replace(
        kv_cache_dtype="int8")),
}


def _swap_cfgs(case):
    arch, edit = SWAP_CASES[case]
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
    jcfg = edit(jreduced(jget_config(arch), **kw).replace(
        dtype="float32").with_chai(enabled=True, warmup_tokens=3))
    tcfg = edit(reduced(get_config(arch), **kw).with_chai(
        enabled=True, warmup_tokens=3))
    return jcfg, tcfg


def _states(jcfg, tcfg, rng=None):
    """One paged state in each package, zeros, or (``rng``) the same
    values drawn with numpy (a bf16 entry rounded from fp32 by both)."""
    kw = dict(page_size=SWAP_PAGE, dense_pages=SWAP_DENSE,
              chai_pages=SWAP_CHAI)
    jstate = dict(jcache.init_paged_state(jcfg, SWAP_SLOTS, SWAP_S, **kw))
    tstate = tcache.init_paged_state(tcfg, SWAP_SLOTS, SWAP_S, **kw,
                                     device="cpu")
    assert set(jstate) == set(tstate)
    if rng is None:
        return jstate, tstate
    for k in sorted(tstate):
        t = tstate[k]
        if t.dtype.is_floating_point:
            x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        elif t.dtype == torch.int8:
            x = rng.integers(-127, 128, size=tuple(t.shape)).astype(np.int8)
        else:
            x = rng.integers(0, 5, size=tuple(t.shape)).astype(np.int32)
        tstate[k] = torch.from_numpy(x).to(t.dtype)
        jstate[k] = jnp.asarray(x).astype(jstate[k].dtype)
    return jstate, tstate


def _vecs(pages_by_kind):
    p = SWAP_S // SWAP_PAGE
    out = []
    for pages in pages_by_kind:
        v = np.zeros((p,), np.int32)
        v[:len(pages)] = pages
        out.append(v)
    return out


@pytest.mark.parametrize("case", list(SWAP_CASES))
def test_slot_swap_matches_reference(case):
    """``save_slot_paged`` of slot 1 (pages out of order, null-padded
    vectors) equals the reference's in every column and page bit for bit;
    ``load_slot_paged`` of that save onto fresh page ids in a zero state
    equals the reference's load bit for bit, and restores the slot's
    columns and the pages' contents exactly."""
    jcfg, tcfg = _swap_cfgs(case)
    jstate, tstate = _states(jcfg, tcfg, np.random.default_rng(7))
    slot = 1
    old = _vecs(([5, 9, 3], [7, 2, 11], [4, 6, 1], [8, 3, 2]))
    jcols, jpools = jcache.save_slot_paged(
        jstate, jnp.int32(slot), *[jnp.asarray(v) for v in old])
    tcols, tpools = tcache.save_slot_paged(
        tstate, slot, *[torch.from_numpy(v) for v in old])
    assert set(tcols) == set(jcols) and set(tpools) == set(jpools)
    for tree_t, tree_j in ((tcols, jcols), (tpools, jpools)):
        for k in tree_j:
            np.testing.assert_array_equal(_bits(tree_t[k]),
                                          _bits(tree_j[k]), err_msg=k)
    new = _vecs(([12, 1, 6], [10, 14, 4], [9, 11, 5], [3, 7, 12]))
    jdst, tdst = _states(jcfg, tcfg)
    jdst = jcache.load_slot_paged(
        jdst, jnp.int32(slot), jcols, jpools, *[jnp.asarray(v) for v in new],
        *[jnp.asarray(v) for v in new])
    tcache.load_slot_paged(tdst, slot, tcols, tpools,
                           *[torch.from_numpy(v) for v in new],
                           *[torch.from_numpy(v) for v in new])
    for k in jdst:
        np.testing.assert_array_equal(_bits(tdst[k]), _bits(jdst[k]),
                                      err_msg=k)
    for k in tcols:
        axis = 0 if tstate[k].ndim == 1 else 1
        assert torch.equal(tdst[k].select(axis, slot),
                           tstate[k].select(axis, slot)), k
    for (pool, kind), o, n in zip((("kvp", "kg"), ("kvp", "vg"),
                                   ("cp", "kc"), ("cp", "vc")), old, new):
        if kind not in tpools:
            continue
        for key in (pool, pool + "_scale"):
            if key in tstate:
                assert torch.equal(tdst[key][:, n[:3]],
                                   tstate[key][:, o[:3]]), (key, kind)


# --------------------------------------------------- engines in lockstep ---
class Lockstep:
    """The reference's ``EngineCore`` and the port's stepped in turns. The
    reference steps first, its argmax inputs and outputs and CLUSTER
    memberships recorded; the port takes the reference's tokens and
    memberships, so both decode the same sequences and their states stay
    comparable step by step."""

    def __init__(self, arch, **kw):
        jcfg, tcfg, jparams, tparams = _models_of(arch)
        self.j = JEngineCore(jcfg, jparams, JEngineConfig(**kw))
        self.t = EngineCore(tcfg, tparams, EngineConfig(**kw), device="cpu")
        self.calls, self.clusters, self.checked = [], [], 0
        self.steps = 0
        j, t = self.j, self.t
        jargmax, jcluster = j._argmax, j._cluster_fn()

        def rec_argmax(lg):
            live = ([True] if lg.shape[0] == 1 else
                    [r is not None and j._phases[i] != jcache.PHASE_PREFILL
                     for i, r in enumerate(j._slot_req)])
            tok = jargmax(lg)
            self.calls.append((np.asarray(lg), np.asarray(tok), live))
            return tok

        def rec_cluster(state, ctx, slot, *rest):
            state, ctx = jcluster(state, ctx, slot, *rest)
            self.clusters.append({k: np.array(v[:, int(slot)])
                                  for k, v in ctx.items()})
            return state, ctx

        def port_argmax(lg):
            jlg, jtok, live = self.calls.pop(0)
            assert tuple(lg.shape) == jlg.shape
            rows = [i for i, a in enumerate(live) if a]
            np.testing.assert_allclose(lg.numpy()[rows], jlg[rows],
                                       **LOGIT_TOL)
            own = torch.argmax(lg, dim=-1).numpy()
            for i in rows:
                top2 = np.sort(jlg[i])[-2:]
                if top2[1] - top2[0] > MARGIN:
                    assert own[i] == jtok[i]
                    self.checked += 1
            return torch.from_numpy(jtok.astype(np.int64))

        j._argmax, j._cluster_slot = rec_argmax, rec_cluster
        t._argmax = port_argmax
        t._identify = lambda sc: {k: torch.from_numpy(v[:, None])
                                  for k, v in self.clusters.pop(0).items()}

    def add(self, prompt, max_new, priority):
        jr = self.j.add_request(prompt, JSamplingParams(
            max_new_tokens=max_new), priority=priority)
        tr = self.t.add_request(prompt, SamplingParams(
            max_new_tokens=max_new), priority=priority)
        assert jr.uid == tr.uid
        return jr, tr

    def step(self):
        self.j.step()
        self.t.step()
        self.steps += 1
        assert not self.calls and not self.clusters
        j, t = self.j, self.t
        assert t.preemptions == j.preemptions
        assert [r.uid for r in t.queue] == [r.uid for r in j.queue]
        assert [r and r.uid for r in t._slot_req] == \
            [r and r.uid for r in j._slot_req]
        np.testing.assert_array_equal(t._phases, j._phases)
        assert _pool_counters(t) == _pool_counters(j)
        assert t.tiers.tier_pages() == j.tiers.tier_pages()
        assert t.tiers.transitions == j.tiers.transitions
        js, ts = j._dev_state, t._dev_state
        for key in ("kvp", "cp"):
            if key in js:
                np.testing.assert_allclose(ts[key][:, 1:].numpy(),
                                           np.asarray(js[key])[:, 1:],
                                           **POOL_TOL, err_msg=key)
        for key in ("pos", "phase", "bt_kg", "bt_vg", "bt_kc"):
            if key in js:
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]),
                                              err_msg=key)
        # a FREE slot's scores are garbage read through the null page 0,
        # whose contents the two packages' null-padded writes leave apart
        live = np.flatnonzero(t._phases != tcache.PHASE_FREE)
        np.testing.assert_allclose(
            ts["chai_scores"].numpy()[:, live],
            np.asarray(js["chai_scores"])[:, live], **POOL_TOL)

    def run(self, reqs):
        while not all(t.finished for _, t in reqs):
            self.step()
            assert self.steps < 400
        for jr, tr in reqs:
            assert (tr.finish_reason, tr.preemptions) == \
                (jr.finish_reason, jr.preemptions)
            assert list(tr.generated) == list(jr.generated)
        assert invariants.audit(self.t, deep=True) == []


def _storm_prompts(seed, n, size=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=size) for _ in range(n)]


@pytest.mark.parametrize("arch", [MHA, GQA], ids=["mha", "gqa"])
def test_preempt_resume_lockstep(arch):
    """The reference's ``test_preempt_resume_identical_output``: a
    priority-5 arrival evicts the running request mid-STEADY."""
    ls = Lockstep(arch, **STORM)
    p_low, p_high = _storm_prompts(0, 2)
    low = ls.add(p_low, 12, 0)
    for _ in range(6):
        ls.step()
    assert len(low[1].generated) >= 3 and not low[1].finished
    high = ls.add(p_high, 12, 5)
    ls.run([low, high])
    assert low[1].preemptions == 1 and high[1].preemptions == 0
    assert ls.t.preemptions == 1 and ls.checked >= 15
    assert _pool_counters(ls.t)["dense"]["refs"] == 0


@pytest.mark.parametrize("steps", [1, 0], ids=["warmup", "prefill"])
def test_preempt_in_early_phase_lockstep(steps):
    """The reference's ``test_preempt_in_early_phase``: a WARMUP victim
    swaps its score rows too; a victim preempted in the admission step of
    its monolithic prefill (steps 0) is already in WARMUP by then, as in
    the reference."""
    ls = Lockstep(MHA, **STORM)
    p1, p2 = _storm_prompts(2, 2)
    r1 = ls.add(p1, 12, 0)
    for _ in range(steps + 1):
        ls.step()
    r2 = ls.add(p2, 12, 9)
    ls.run([r1, r2])
    assert r1[1].preemptions >= 1


def test_preempt_mid_chunked_prefill_lockstep():
    """A victim caught between the chunks of its prefill saves nothing and
    prefills again (its chunk cursor dropped), in both packages."""
    ls = Lockstep(MHA, **STORM, prefill_chunk_tokens=16)
    p1, p2 = _storm_prompts(5, 2)
    r1 = ls.add(p1, 12, 0)
    ls.step()
    assert ls.t._phases[r1[1].slot] == tcache.PHASE_PREFILL
    r2 = ls.add(p2, 12, 9)
    ls.step()
    assert r1[1].preemptions == 1 and r1[1].resume_state is None
    assert r1[1].generated == []
    ls.run([r1, r2])


def test_preemption_storm_lockstep():
    """The reference's ``test_preemption_storm_pool_baseline``: five
    requests of rising priority on one request's page budget, a chain of
    evictions; everything finishes full length, the pools at base."""
    ls = Lockstep(MHA, **STORM)
    base = _pool_counters(ls.t)
    reqs = [ls.add(p, 10, k) for k, p in enumerate(_storm_prompts(3, 5))]
    ls.run(reqs)
    assert all(len(t.generated) == 10 for _, t in reqs)
    assert ls.t.preemptions >= 2
    assert _pool_counters(ls.t) == base
    assert not any(ls.t.tiers.tier_pages().values())


# ----------------------------------------------------- inside the port ---
PORT_CASES = {
    "mha_greedy": (MHA, {}, 0.0, 6),
    "mha_seeded": (MHA, {}, 0.8, 6),
    "gqa_greedy": (GQA, {}, 0.0, 6),
    "gqa_seeded": (GQA, {}, 0.8, 6),
    "int8": (MHA, {"int8": True}, 0.0, 6),
    "share_values": (MHA, {"share": True}, 0.8, 6),
    "warmup_victim": (MHA, {}, 0.0, 2),
    "chunked_prefill_victim": (MHA, {"prefill_chunk_tokens": 16}, 0.8, 1),
}


@pytest.mark.parametrize("case", list(PORT_CASES))
def test_preempt_resume_bitwise_inside_port(case):
    """Preempt-then-resume gives the victim's and the preemptor's
    uninterrupted tokens bit for bit (a seeded token n draws from (seed,
    n), whatever slot and step), the victim resumes on the kernels'
    path (the same step kinds), the deep audit passes after every step
    and the pools and host tier return to their base."""
    arch, mods, temp, steps = PORT_CASES[case]
    _, tcfg, _, tparams = _models_of(arch)
    if mods.get("int8"):
        tcfg = tcfg.replace(kv_cache_dtype="int8")
    if mods.get("share"):
        tcfg = tcfg.with_chai(share_values=True)
    kw = dict(STORM)
    if "prefill_chunk_tokens" in mods:
        kw["prefill_chunk_tokens"] = mods["prefill_chunk_tokens"]
    sps = [SamplingParams(max_new_tokens=12, temperature=temp, top_k=20,
                          top_p=0.9, seed=s) for s in (11, 12)]
    prompts = _storm_prompts(1, 2)
    want = []
    for p, sp in zip(prompts, sps):
        ref = LLM(tcfg, tparams, EngineConfig(**kw), device="cpu")
        want.append(ref.generate(p, sp)[0].token_ids)
    core = EngineCore(tcfg, tparams, EngineConfig(**kw), device="cpu")
    base = _pool_counters(core)
    low = core.add_request(prompts[0], sps[0], priority=0)
    for _ in range(steps):
        core.step()
    high = core.add_request(prompts[1], sps[1], priority=5)
    while not (low.finished and high.finished):
        core.step()
    assert low.preemptions == 1 and high.preemptions == 0
    assert core.preemptions == 1 and core.swap_checksum_failures == 0
    assert low.generated == want[0] and high.generated == want[1]
    core.reap_done()
    assert _pool_counters(core) == base
    assert all(p.pages_in_use == 0 for p in core.tiers.host.values()
               if p is not None)


def test_preemption_off_means_fifo():
    """The reference's ``test_preemption_off_means_fifo``: the arrival
    of priority 9 waits for the free slot instead of evicting."""
    _, tcfg, _, tparams = _models_of(MHA)
    core = EngineCore(tcfg, tparams, EngineConfig(
        batch_slots=1, max_seq=128, page_size=16, preemption=False),
        device="cpu")
    rng = np.random.default_rng(4)
    sp = SamplingParams(max_new_tokens=10)
    r1 = core.add_request(rng.integers(0, 64, size=24), sp, priority=0)
    core.step()
    r2 = core.add_request(rng.integers(0, 64, size=24), sp, priority=9)
    while not (r1.finished and r2.finished):
        core.step()
    assert core.preemptions == 0
    assert r1.preemptions == r2.preemptions == 0
    assert r2.admit_step > r1.retire_step - 1


def test_dense_layout_serves_priority_without_preemption():
    """Preemption is the paged layout's: on ``kv_layout="dense"`` a
    priority arrival waits its turn (as in the reference), and every
    request completes."""
    _, tcfg, _, tparams = _models_of(MHA)
    core = EngineCore(tcfg, tparams, EngineConfig(
        batch_slots=1, max_seq=128, page_size=16, kv_layout="dense"),
        device="cpu")
    sp = SamplingParams(max_new_tokens=6)
    p1, p2 = _storm_prompts(6, 2, size=20)
    r1 = core.add_request(p1, sp)
    core.step()
    r2 = core.add_request(p2, sp, priority=3)
    while not (r1.finished and r2.finished):
        core.step()
    assert core.preemptions == 0 and len(r2.generated) == 6


def test_cohort_forms_cohorts_by_priority():
    """The cohort scheduler's cohorts, highest priority first and FIFO
    within a class: the order requests finish in equals the reference's,
    and so do the tokens."""
    jcfg, tcfg, jparams, tparams = _models_of(MHA)
    prompts = _storm_prompts(8, 5, size=12)
    prios = [0, 0, 2, 1, 2]
    kw = dict(batch_slots=2, max_seq=64, scheduler="cohort")
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**kw))
    teng = ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    for p, pr in zip(prompts, prios):
        jeng.add_request(p, JSamplingParams(max_new_tokens=5), priority=pr)
        teng.add_request(p, SamplingParams(max_new_tokens=5), priority=pr)
    jdone, tdone = jeng.run(), teng.run()
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert [r.uid for r in tdone][:2] == [2, 4]


# ------------------------------------- faults, tiers and telemetry ---
def _victim_and_preemptor(cores, seed):
    """The reference's scenario: a 12-token victim decodes 4 steps on a
    one-slot engine, then a priority-1 preemptor arrives; both drained
    (the reference's core first: the port clusters through its
    membership)."""
    from repro.serving.sampling import SamplingParams as JSP
    out = []
    for core, sp in zip(cores, (JSP, SamplingParams)):
        rng = np.random.default_rng(seed)
        victim = core.add_request(rng.integers(1, 64, size=12).tolist(),
                                  sp(max_new_tokens=12))
        for _ in range(4):
            core.step()
        preemptor = core.add_request(rng.integers(1, 64, size=6).tolist(),
                                     sp(max_new_tokens=4), priority=1)
        _drain(core)
        out.append((victim, preemptor))
    (jv, jp), (tv, tp) = out
    for j, t in ((jv, tv), (jp, tp)):
        assert (t.uid, t.finish_reason, t.error, t.preemptions) == \
            (j.uid, j.finish_reason, j.error, j.preemptions)
        assert list(t.generated) == list(j.generated)
    jcore, tcore = cores
    assert tcore.fault_stats() == jcore.fault_stats()
    assert tcore.preemptions == jcore.preemptions == 1
    assert tcore.tier_stats()["transitions"] == \
        jcore.tier_stats()["transitions"]
    assert invariants.audit_leaks(tcore) == []
    return tv, tp


@pytest.mark.parametrize("plan,word", [
    ([dict(site="swap.corrupt", mode="corrupt")], "checksum mismatch"),
    ([dict(site="offload.in", uid=0)], "host-tier fetch failure"),
    ([dict(site="swap.in", uid=0)], "swap-in failure"),
], ids=["swap_corrupt", "offload_in", "swap_in"])
def test_swap_in_faults_quarantine_the_victim(plan, word):
    """The reference's ``test_swap_corruption_fault_is_quarantined_at_
    swap_in`` and ``test_offload_in_fault_at_swap_in_quarantines_victim``
    (and its ``swap.in`` arm): the victim alone is quarantined before its
    swap-in writes the device, the preemptor's tokens stand, the host
    pages return, and every counter equals the reference's."""
    cores = _cores(plan, batch_slots=1, prefix_cache=True)
    victim, preemptor = _victim_and_preemptor(cores, 4 if "swap.c" in
                                              plan[0]["site"] else 23)
    tcore = cores[1]
    assert preemptor.finish_reason == "length"
    assert victim.finish_reason == FINISH_ERROR and word in victim.error
    fs = tcore.fault_stats()
    assert fs["quarantined"] == 1
    assert fs["swap_checksum_failures"] == int(word == "checksum mismatch")
    assert [f["site"] for f in fs["injector"]["fired"]] == \
        [plan[0]["site"]]
    assert all(p.pages_in_use == 0 for p in tcore.tiers.host.values()
               if p is not None)


def test_preemption_swaps_through_host_pool():
    """The reference's test: the swapped-out slot lives in host-tier pages
    (the audit balances them), is freed at swap-in, and the victim
    resumes to its full length."""
    _, tcfg, _, tparams = _models_of(MHA)
    tcore = EngineCore(tcfg, tparams, EngineConfig(
        batch_slots=1, max_seq=64, page_size=8, prefix_cache=True,
        audit_level="deep"), device="cpu")
    rng = np.random.default_rng(10)
    victim = tcore.add_request(rng.integers(1, 64, size=12).tolist(),
                               SamplingParams(max_new_tokens=12))
    for _ in range(4):
        tcore.step()
    tcore.add_request(rng.integers(1, 64, size=6).tolist(),
                      SamplingParams(max_new_tokens=4), priority=1)
    tcore.step()
    rs = victim.resume_state
    assert rs is not None and rs["tier_pages"], "victim not swapped out"
    held = sum(p.pages_in_use for p in tcore.tiers.host.values()
               if p is not None)
    assert held == sum(len(v) for v in rs["tier_pages"].values()) > 0
    assert invariants.audit(tcore, deep=True) == []
    # a queued victim's host pages are counted by the audit: drop one
    # reference behind its back and the audit sees it
    kind = next(iter(rs["tier_pages"]))
    saved = rs["tier_pages"][kind]
    rs["tier_pages"][kind] = saved[1:]
    assert invariants.audit(tcore) != []
    rs["tier_pages"][kind] = saved
    _drain(tcore)
    assert victim.finish_reason == "length" and len(victim.generated) == 12
    ts = tcore.tier_stats()
    assert ts["transitions"].get("host->hot/chai", 0) > 0
    assert all(p.pages_in_use == 0 for pools in
               (tcore.tiers.host, tcore.tiers.comp)
               for p in pools.values() if p is not None)
    # and both packages agree on the whole run
    fresh = _cores(None, batch_slots=1, prefix_cache=True)
    _victim_and_preemptor(fresh, 10)


def test_timeline_preempt_and_resume_events():
    """The reference's test at "trace" on both packages: the victim's
    timeline holds ``preempt`` and ``resume`` events, ``preemptions_total``
    counts, the ``preempt.swap`` span is recorded, and every metric, span,
    timeline and Prometheus sample equals the reference's."""
    cores = _cores(None, batch_slots=2, telemetry="trace")
    reqs = []
    for core, sp in zip(cores, (JSamplingParams, SamplingParams)):
        low = [core.add_request(p, sp(max_new_tokens=10))
               for p in _prompts(2, seed=4)]
        core.step()
        core.step()
        hi = core.add_request(_prompts(1, seed=5)[0], sp(max_new_tokens=4),
                              priority=1)
        _drain(core)
        reqs.append((low, hi))
    (_, jhi), (tlow, thi) = reqs
    assert thi.finish_reason == jhi.finish_reason == "length"
    snap = _hold_telemetry(cores)
    tcore = cores[1]
    victim = next(r for r in tlow if r.preemptions > 0)
    tl = tcore.request_timeline(victim.uid)
    names = [e["ev"] for e in tl["events"]]
    assert "preempt" in names and "resume" in names
    assert tl["summary"]["preemptions"] == victim.preemptions
    assert _counter_value(snap, "preemptions_total") >= 1
    assert _counter_value(snap, "requests_admitted_total", kind="swap") >= 1
    assert any(sp["name"] == "preempt.swap" for sp in tcore.tel.spans)


def test_dataclass_fields_match_reference():
    """The request and engine-config fields of preemption carry the
    reference's names and defaults."""
    from repro.serving.engine import Request as JRequest
    from repro_torch.serving.engine import Request
    for cls, jcls in ((Request, JRequest),
                      (EngineConfig, JEngineConfig)):
        tf = {f.name: f.default for f in dataclasses.fields(cls)}
        jf = {f.name: f.default for f in dataclasses.fields(jcls)}
        for name in ("priority", "preemptions", "resume_state",
                     "preemption"):
            if name in jf:
                assert tf[name] == jf[name], name
    assert EngineConfig().preemption is True
