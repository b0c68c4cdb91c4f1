"""The port's failure model (``serving.faults``, ``serving.invariants``,
the engine's quarantine, audit and degraded decode) against the JAX
package's, on the CPU.

In the shape of ``tests/test_faults.py``: the taxonomy, the injector and
the payload checksum; then each injection site on a reduced chai-llama-7b
(2 layers, d 32, vocab 64, fp32, warmup 3; ``audit_level="deep"``, so
every step ends in the deep audit), the reference's engine and the port's
on the same weights (``weights.params_from_numpy``) and the same plan.
Held: finish reasons, quarantine messages, tokens (exact; the port
clusters through the reference's membership after checking its own
differs at most by a two-head tie, ROADMAP "Two-head cluster ties"), the
``fault_stats()`` counters and the injector's ``fired`` log.

Port only: healing, a real exception in the decode propagating (the one
deliberate divergence: only an injected ``kernel.decode`` fault degrades
the decode), every site served (the swap sites firing at a preemption),
and the deep audit
clean after every step of each engine path (paged, dense, chunked, prefix
with relay, int8, reduced nemotron-4-15b).
"""
import numpy as np
import pytest

import jax
import ml_dtypes
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.serving import faults as jfaults
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import EngineCore as JEngineCore
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.models.transformer import init_params
from repro_torch.serving import LLM, invariants
from repro_torch.serving.engine import EngineConfig, EngineCore
from repro_torch.serving.faults import (SITES, CapacityError,
                                        EngineFault, FaultInjector,
                                        FaultSpec,
                                        QuarantineError, RequestError,
                                        SnapshotRestoreError,
                                        ValidationError, checksum_arrays,
                                        corrupt_arrays)
from repro_torch.serving.sampling import FINISH_ERROR, SamplingParams
from repro_torch.weights import params_from_numpy
from test_torch_api import _hold_membership

ARCH = "chai-llama-7b"          # MHA+CHAI: snapshots and the kc/vc pool
GREEDY = dict(max_new_tokens=8)
ECFG = dict(batch_slots=2, max_seq=64, page_size=8, audit_level="deep")

_models = {}


def _model():
    if ARCH not in _models:
        kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
        jcfg = jreduced(jget_config(ARCH), **kw).replace(
            dtype="float32").with_chai(enabled=True, warmup_tokens=3)
        tcfg = reduced(get_config(ARCH), **kw).with_chai(enabled=True,
                                                         warmup_tokens=3)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _models[ARCH] = (jcfg, tcfg, jparams, tparams)
    return _models[ARCH]


def _prompts(n, length=(6, 14), seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=int(rng.integers(*length))).tolist()
            for _ in range(n)]


def _drain(core, max_steps=400):
    outs = []
    for _ in range(max_steps):
        if not core.has_work():
            return outs
        outs.extend(core.step())
    raise AssertionError(f"engine did not drain in {max_steps} steps")


def _injectors(plan, seed=0):
    """The same plan in both packages' ``FaultInjector`` (None: no plan)."""
    if plan is None:
        return None, None
    return (jfaults.FaultInjector([jfaults.FaultSpec(**a) for a in plan],
                                  seed=seed),
            FaultInjector([FaultSpec(**a) for a in plan], seed=seed))


def _cores(plan=None, **kw):
    """The reference's and the port's ``EngineCore`` on the same weights
    and plan; the port clusters through the reference's membership."""
    jcfg, tcfg, jparams, tparams = _model()
    jinj, tinj = _injectors(plan)
    ecfg = {**ECFG, **kw}
    jcore = JEngineCore(jcfg, jparams, JEngineConfig(**ecfg), faults=jinj)
    tcore = EngineCore(tcfg, tparams, EngineConfig(**ecfg), faults=tinj,
                       device="cpu")
    _hold_membership(jcore, tcore)
    tcore.held_membership = _recorded(tcore, tcore._identify)
    return jcore, tcore


def _slot_uid(core):
    i = int(np.flatnonzero(core._phases == tcache.PHASE_CLUSTER)[0])
    return core._slot_req[i].uid


def _recorded(core, identify, forced=None):
    """Route ``core``'s identification through ``identify`` (or, for a
    uid in ``forced``, its membership there) and record each uid's."""
    held = {}

    def ident(sc):
        uid = _slot_uid(core)
        held[uid] = (forced or {}).get(uid) or identify(sc)
        return held[uid]

    core._identify = ident
    return held


def _submit(cores, prompts, **sp):
    jcore, tcore = cores
    return ([jcore.add_request(p, JSamplingParams(**{**GREEDY, **sp}))
             for p in prompts],
            [tcore.add_request(p, SamplingParams(**{**GREEDY, **sp}))
             for p in prompts])


def _hold(cores, jreqs, treqs):
    """Finish reasons, quarantine messages, tokens and every fault
    counter and firing equal to the reference's."""
    jcore, tcore = cores
    for j, t in zip(jreqs, treqs):
        assert (t.uid, t.finish_reason, t.error) == \
            (j.uid, j.finish_reason, j.error)
        assert list(t.generated) == list(j.generated), t.uid
    assert tcore.fault_stats() == jcore.fault_stats()
    assert tcore.steps_executed == jcore.steps_executed
    assert invariants.audit_leaks(tcore) == []


def _run(prompts, plan=None, **kw):
    cores = _cores(plan, **kw)
    jreqs, treqs = _submit(cores, prompts)
    for core in cores:
        _drain(core)
    _hold(cores, jreqs, treqs)
    return cores, treqs


def _clean(faulted, *waves, **kw):
    """The port's fault-free run of ``waves`` of prompts, each drained
    before the next, clustering each request through its membership in
    the ``faulted`` port core (the reference's; a two-head tie could
    otherwise part the runs)."""
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(**{**ECFG, **kw}),
                      device="cpu")
    _recorded(core, core._identify, faulted.held_membership)
    reqs = []
    for wave in waves:
        reqs += [core.add_request(p, SamplingParams(**GREEDY))
                 for p in wave]
        _drain(core)
    assert core.fault_stats()["quarantined"] == 0
    return reqs


# ---------------------------------------------------------------------------
# taxonomy + injector + integrity helpers (pure units)
# ---------------------------------------------------------------------------
def test_fault_taxonomy_backcompat_bases():
    """The typed errors are still catchable as the historical types
    (MemoryError for the page budget, ValueError for add_request)."""
    cap = CapacityError("full", uid=7)
    assert isinstance(cap, MemoryError) and isinstance(cap, RequestError)
    assert cap.uid == 7
    val = ValidationError("bad", uid=3)
    assert isinstance(val, ValueError) and isinstance(val, RequestError)
    assert isinstance(QuarantineError("q"), RequestError)
    assert isinstance(SnapshotRestoreError("s"), RequestError)
    ef = EngineFault("broken", violations=["a", "b"])
    assert isinstance(ef, RuntimeError)
    assert not isinstance(ef, RequestError)
    assert "a" in str(ef) and "b" in str(ef)
    assert str(ef) == str(jfaults.EngineFault("broken",
                                              violations=["a", "b"]))


def test_faultspec_validates_site_mode_p():
    assert SITES == jfaults.SITES
    for site in SITES:               # every site, unported ones included
        FaultSpec(site)
    with pytest.raises(ValueError):
        FaultSpec("no.such.site")
    with pytest.raises(ValueError):
        FaultSpec("pool.alloc", mode="explode")
    with pytest.raises(ValueError):
        FaultSpec("pool.alloc", p=0.0)
    with pytest.raises(ValueError):
        FaultSpec("pool.alloc", p=1.5)


def test_fault_injector_is_deterministic_and_replayable():
    """Same (seed, plan, call sequence) => identical firing log, equal to
    the reference injector's; gating on step/uid/count as specified."""
    specs = [dict(site="pool.alloc", mode="transient", step=4),
             dict(site="swap.in", uid=9, count=2),
             dict(site="step.logits", mode="nan", p=0.4, count=-1)]
    calls = ([("pool.alloc", s, u) for s in range(6) for u in (1, 9)]
             + [("swap.in", 5, u) for u in (1, 9, 9, 9)]
             + [("step.logits", s, 2) for s in range(30)])

    def run(inj):
        log = []
        for site, step, uid in calls:
            spec = inj.fire(site, step=step, uid=uid)
            log.append(None if spec is None else spec.mode)
        return log, inj.report()

    log_a, rep_a = run(_injectors(specs, seed=11)[1])
    log_b, rep_b = run(_injectors(specs, seed=11)[1])
    log_j, rep_j = run(_injectors(specs, seed=11)[0])
    assert log_a == log_b == log_j
    assert rep_a == rep_b == rep_j
    pool = [f for f in rep_a["fired"] if f["site"] == "pool.alloc"]
    assert [f["step"] for f in pool] == [4]
    swap = [f for f in rep_a["fired"] if f["site"] == "swap.in"]
    assert len(swap) == 2 and all(f["uid"] == 9 for f in swap)
    nan = [f for f in rep_a["fired"] if f["site"] == "step.logits"]
    assert 0 < len(nan) < 30


def test_fault_payload_checksum_detects_corruption():
    """Corrupting any leaf changes the CRC; corruption is deterministic in
    the seed and works on read-only leaves and on tensors (which stay
    tensors of their dtype)."""
    def payload():
        a = np.arange(24, dtype=np.float32).reshape(4, 6)
        a.setflags(write=False)
        return {"cols": {"k": a},
                "pools": {"kg": np.ones((2, 3), np.float32)}}

    base = checksum_arrays(payload())
    assert base == checksum_arrays(payload())
    t1, t2 = payload(), payload()
    assert corrupt_arrays(t1, seed=5) and corrupt_arrays(t2, seed=5)
    assert checksum_arrays(t1) != base
    assert checksum_arrays(t1) == checksum_arrays(t2)
    j1 = payload()
    jfaults.corrupt_arrays(j1, seed=5)
    assert checksum_arrays(t1) == jfaults.checksum_arrays(j1)
    tt = {"k": torch.arange(6, dtype=torch.bfloat16)}
    crc = checksum_arrays(tt)
    assert corrupt_arrays(tt, seed=1)
    assert tt["k"].dtype == torch.bfloat16 and checksum_arrays(tt) != crc


def _payload(dtype, rng):
    x = rng.normal(0.0, 3.0, size=(2, 3, 5)).astype(np.float32)
    if dtype == "bfloat16":
        return (x.astype(ml_dtypes.bfloat16),
                torch.from_numpy(x).bfloat16())
    if dtype in ("int8", "int32"):
        x = np.clip(np.round(x * 20), -127, 127).astype(dtype)
    return x, torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["float32", "int8", "int32", "bfloat16"])
def test_checksum_equals_reference(dtype):
    """``checksum_arrays`` of a tensor (and of its numpy copy) equals the
    reference's over the same payload (a bf16 tensor against an
    ``ml_dtypes`` bf16 array), nested in a dict too, before and after a
    seeded corruption."""
    ref_arr, tensor = _payload(dtype, np.random.default_rng(0))
    assert checksum_arrays(tensor) == jfaults.checksum_arrays(ref_arr)
    tree = {"b": {"x": tensor}, "a": tensor[0]}
    jtree = {"b": {"x": ref_arr}, "a": ref_arr[0]}
    assert checksum_arrays(tree) == jfaults.checksum_arrays(jtree)
    assert corrupt_arrays(tree, seed=3) and jfaults.corrupt_arrays(jtree,
                                                                   seed=3)
    assert checksum_arrays(tree) == jfaults.checksum_arrays(jtree)


# ---------------------------------------------------------------------------
# engine quarantine paths, held against the reference
# ---------------------------------------------------------------------------
def test_validation_error_is_typed_and_catchable_as_valueerror():
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(**{**ECFG, "max_seq": 32}),
                      device="cpu")
    with pytest.raises(ValidationError):
        core.add_request(list(range(1, 30)), SamplingParams(**GREEDY),
                         max_new_tokens=20)
    with pytest.raises(ValueError):                   # legacy catch
        core.add_request(list(range(1, 30)), SamplingParams(**GREEDY),
                         max_new_tokens=20)
    with pytest.raises(ValidationError):
        core.add_request([1, 2], SamplingParams(stop=("x",)))
    assert not core.has_work()


def test_nan_logits_quarantine_isolates_one_request():
    """A poisoned logits row typed-fails ITS slot; the other slots keep
    decoding and produce the exact fault-free tokens."""
    prompts = _prompts(3, seed=1)
    (_, core), reqs = _run(prompts, [dict(site="step.logits", mode="nan",
                                          uid=1)], batch_slots=3)
    clean = _clean(core, prompts, batch_slots=3)
    assert reqs[1].finish_reason == FINISH_ERROR
    assert "non-finite logits" in reqs[1].error
    for k in (0, 2):
        assert reqs[k].finish_reason == clean[k].finish_reason
        assert list(reqs[k].generated) == list(clean[k].generated)
    fs = core.fault_stats()
    assert fs["quarantined"] == 1
    assert fs["injector"]["fired"][0]["site"] == "step.logits"


def test_pool_alloc_fault_quarantines_queued_request():
    """mode="error" at the admission planner typed-fails the queued
    request before it touches any device state."""
    cores = _cores([dict(site="pool.alloc", mode="error", uid=1)],
                   batch_slots=3)
    jreqs, reqs = _submit(cores, _prompts(3, seed=2))
    outs = [_drain(core) for core in cores]
    _hold(cores, jreqs, reqs)
    assert reqs[1].finish_reason == FINISH_ERROR and reqs[1].error
    assert all(r.finish_reason == "length" for r in (reqs[0], reqs[2]))
    terminal = [o for o in outs[1] if o.uid == reqs[1].uid and o.finished]
    assert terminal and terminal[0].finish_reason == FINISH_ERROR
    assert [(o.uid, o.token_ids, o.finish_reason) for o in outs[1]] == \
        [(o.uid, list(o.token_ids), o.finish_reason) for o in outs[0]]


def test_pool_alloc_transient_fault_only_delays_admission():
    """mode="transient" blocks the plan for a step; the request is
    retried, completes, and matches the fault-free tokens; no
    CapacityError."""
    prompts = _prompts(2, seed=3)
    (_, core), faulted = _run(prompts, [dict(site="pool.alloc",
                                             mode="transient", count=2)])
    clean = _clean(core, prompts)
    assert len(core.faults.fired) == 2
    for c, f in zip(clean, faulted):
        assert f.finish_reason == "length" == c.finish_reason
        assert list(f.generated) == list(c.generated)


def test_snapshot_restore_fault_recovers_by_replanning_cold():
    """An injected CHAI-snapshot restore failure drops the snapshot and
    re-plans the admission: the duplicate still completes with the exact
    tokens of a fault-free duplicate run; nothing is quarantined."""
    prompt = np.random.default_rng(5).integers(1, 64, size=16).tolist()

    def run(plan):
        cores = _cores(plan, prefix_cache=True)
        firsts = _submit(cores, [prompt])
        for core in cores:
            _drain(core)
            assert core.prefix_stats()["snapshots"] >= 1
        dups = _submit(cores, [prompt])
        for core in cores:
            _drain(core)
        _hold(cores, firsts[0] + dups[0], firsts[1] + dups[1])
        return cores[1], dups[1][0]

    core, dup = run([dict(site="snapshot.restore", count=1)])
    dup_clean = _clean(core, [prompt], [prompt], prefix_cache=True)[1]
    assert [f["site"] for f in core.faults.fired] == ["snapshot.restore"]
    assert dup.finish_reason == "length"
    assert list(dup.generated) == list(dup_clean.generated)
    assert core.fault_stats()["quarantined"] == 0


@pytest.mark.parametrize("site", ["kernel.prefill", "kernel.cluster"])
def test_request_sites_quarantine_one_request(site):
    """An injected prefill (the slot just entered PREFILL) or CLUSTER
    failure quarantines that request only, its pages returned; the others
    keep the fault-free tokens."""
    prompts = _prompts(3, seed=16)
    (_, core), reqs = _run(prompts, [dict(site=site, uid=1)],
                           batch_slots=2, prefix_cache=True)
    clean = _clean(core, prompts, batch_slots=2, prefix_cache=True)
    assert reqs[1].finish_reason == FINISH_ERROR and "injected" in \
        reqs[1].error
    for k in (0, 2):
        assert list(reqs[k].generated) == list(clean[k].generated)
    assert core.fault_stats()["quarantined"] == 1
    # a quarantined sequence never seeds the prefix cache
    assert core.prefix_cache.snapshot_for(prompts[1]) is None


def test_kernel_fault_degrades_to_plain_decode_with_parity():
    """An injected decode failure, raised before any launch, moves the
    engine onto its kernels' plain versions for the rest of its life (no
    healing by default); greedy tokens are identical."""
    prompts = _prompts(2, seed=6)
    (_, core), reqs = _run(prompts, [dict(site="kernel.decode", count=1)])
    clean = _clean(core, prompts)
    fs = core.fault_stats()
    assert fs["degraded_decode"] is True
    assert fs["decode_fallbacks"] == 1
    assert fs["quarantined"] == 0
    for c, f in zip(clean, reqs):
        assert list(f.generated) == list(c.generated)


def test_relay_residency_fault_dissolves_groups_not_requests():
    """A relay-formation fault falls back to the per-request decode for
    that step; nobody fails and tokens match the relay-free run."""
    rng = np.random.default_rng(7)
    shared = rng.integers(1, 64, size=16).tolist()
    prompts = [shared + rng.integers(1, 64, size=3).tolist()
               for _ in range(2)]

    def run(plan, relay):
        cores = _cores(plan, prefix_cache=True, relay_decode=relay)
        seeds = _submit(cores, [shared + [1, 2]])
        for core in cores:
            _drain(core)
        reqs = _submit(cores, prompts)
        for core in cores:
            _drain(core)
        _hold(cores, seeds[0] + reqs[0], seeds[1] + reqs[1])
        return cores[1], reqs[1]

    core, reqs = run([dict(site="relay.residency", count=-1)], relay=True)
    clean = _clean(core, [shared + [1, 2]], prompts, prefix_cache=True)[1:]
    assert core.fault_stats()["relay_dissolved"] >= 1
    assert core.relay_steps == 0
    for c, f in zip(clean, reqs):
        assert f.finish_reason == "length"
        assert list(f.generated) == list(c.generated)


def test_degraded_decode_heals_after_clean_steps():
    """``decode_heal_steps=3``: the fault step and the 3 clean steps after
    it run on the plain steps, the engine then returns to the kernels'
    steps (``decode_heals == 1``); every counter and token as the
    reference's, and the tokens the fault-free run's."""
    prompts = _prompts(2, seed=6)
    cores = _cores([dict(site="kernel.decode", step=2)],
                   decode_heal_steps=3)
    tcore = cores[1]
    calls = {"plain": 0, "kernel": 0}

    def counted(fn, kind):
        def wrapped(*args):
            calls[kind] += 1
            return fn(*args)
        return wrapped

    steps = tcore._plain_decode_steps()
    for key in steps:
        steps[key] = counted(steps[key], "plain")
    for attr in ("_mha_step", "_chai_step", "_mixed_step"):
        setattr(tcore, attr, counted(getattr(tcore, attr), "kernel"))
    jreqs, treqs = _submit(cores, prompts)
    for core in cores:
        _drain(core)
    _hold(cores, jreqs, treqs)
    clean = _clean(tcore, prompts)
    fs = tcore.fault_stats()
    assert (fs["decode_fallbacks"], fs["decode_heals"]) == (1, 1)
    assert fs["degraded_decode"] is False
    assert calls["plain"] == 1 + 3
    assert calls["kernel"] + calls["plain"] == tcore.steps_executed
    for c, f in zip(clean, treqs):
        assert list(f.generated) == list(c.generated)


def test_real_decode_exception_propagates():
    """Only an injected fault degrades the decode: a RuntimeError raised
    inside the clean decode step leaves ``step()`` raising it, with no
    fallback counted and the engine not degraded."""
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(**ECFG), device="cpu")
    for p in _prompts(2, seed=17):
        core.add_request(p, SamplingParams(**GREEDY))

    def broken(*args):
        raise RuntimeError("illegal memory access")

    core._mha_step = broken
    with pytest.raises(RuntimeError, match="illegal memory access"):
        core.step()
    fs = core.fault_stats()
    assert fs["decode_fallbacks"] == 0 and fs["degraded_decode"] is False
    assert core._plain_steps is None


@pytest.mark.parametrize("site,item", [("swap.corrupt", "#9"),
                                       ("swap.in", "#9"),
                                       ("offload.out", "#13"),
                                       ("offload.in", "#13")])
def test_unported_sites_are_refused(site, item):
    """No site is refused any more: the KV tiers' sites (#13) and, since
    preemption (#9) was ported, the swap sites are served. The engine
    takes a plan arming any of them, and a swap arm fires at its site when
    a priority-1 arrival preempts a running request (``swap.corrupt`` at
    the swap-out, ``swap.in`` at the swap-in), quarantining the victim
    alone."""
    _, tcfg, _, tparams = _model()
    inj = FaultInjector([FaultSpec("pool.alloc", mode="transient"),
                         FaultSpec(site, mode="corrupt"
                                   if site == "swap.corrupt" else "error")])
    if site.startswith("offload."):
        core = EngineCore(tcfg, tparams, EngineConfig(
            **ECFG, prefix_cache=True, kv_offload=True), faults=inj,
            device="cpu")
        assert core.faults is inj and core.tiers is not None
        return
    core = EngineCore(tcfg, tparams, EngineConfig(**{**ECFG,
                                                     "batch_slots": 1}),
                      faults=inj, device="cpu")
    rng = np.random.default_rng(4)
    victim = core.add_request(rng.integers(1, 64, size=12).tolist(),
                              SamplingParams(max_new_tokens=12))
    for _ in range(4):
        core.step()
    preemptor = core.add_request(rng.integers(1, 64, size=6).tolist(),
                                 SamplingParams(max_new_tokens=4),
                                 priority=1)
    _drain(core)
    assert [f["site"] for f in core.faults.fired] == ["pool.alloc", site]
    assert core.preemptions == 1
    assert preemptor.finish_reason == "length"
    assert victim.finish_reason == FINISH_ERROR
    assert core.fault_stats()["swap_checksum_failures"] == int(
        site == "swap.corrupt")


# ---------------------------------------------------------------------------
# invariant auditor
# ---------------------------------------------------------------------------
def test_invariant_audit_clean_on_live_and_idle_engine():
    (_, core), _ = _run(_prompts(2, seed=8), prefix_cache=True)
    assert invariants.audit(core, deep=True) == []
    assert invariants.audit_leaks(core) == []
    assert core.fault_stats()["audit_steps"] >= core.steps_executed > 0


@pytest.mark.no_leak_gate
def test_invariant_audit_detects_pool_corruption():
    """A page both free and referenced: the next step() raises
    EngineFault naming the violation instead of decoding on corrupt
    state, as the reference's does."""
    cores = _cores()
    _submit(cores, _prompts(1, seed=9))
    faults = []
    for core in cores:
        core.step()
        page = next(iter(core.dense_pool._rc))
        core.dense_pool._free.append(page)
        with pytest.raises((EngineFault, jfaults.EngineFault)) as ei:
            core.step()
        faults.append(ei.value.violations)
    assert faults[1] == faults[0]
    assert any("dense_pool" in v for v in faults[1])


@pytest.mark.no_leak_gate
def test_invariant_audit_detects_leaked_reference():
    """A page reference nothing accounts for is caught by the refcount
    audit, with the reference's message."""
    cores = _cores()
    _submit(cores, _prompts(1, seed=10))
    found = []
    for core in cores:
        core.step()
        core.dense_pool.alloc(1)               # held by nobody
        found.append([v for v in invariants.audit(core)
                      if "outstanding references" in v])
        with pytest.raises((EngineFault, jfaults.EngineFault)):
            core.step()
    assert found[1] and found[1] == found[0]


def _path_engine(path):
    """A port engine on one of its paths, deep-audited, with requests that
    exercise the path."""
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=64)
    arch = "nemotron-4-15b" if path == "nemotron" else ARCH
    cfg = reduced(get_config(arch), **kw).with_chai(enabled=True,
                                                    warmup_tokens=3)
    ecfg = dict(batch_slots=2, max_seq=64, page_size=8, audit_level="deep")
    if path == "dense":
        ecfg["kv_layout"] = "dense"
    elif path == "chunked":
        ecfg["prefill_chunk_tokens"] = 8
    elif path == "prefix_relay":
        ecfg.update(prefix_cache=True, relay_decode=True)
    elif path == "int8":
        cfg = cfg.replace(kv_cache_dtype="int8")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    core = EngineCore(cfg, params, EngineConfig(**ecfg), device="cpu")
    rng = np.random.default_rng(18)
    shared = rng.integers(1, 64, size=16).tolist()
    if path == "prefix_relay":
        return core, [[shared + [1, 2]]] + [[
            shared + rng.integers(1, 64, size=3).tolist()
            for _ in range(2)]]
    return core, [_prompts(3, length=(6, 30), seed=19)]


@pytest.mark.parametrize("path", ["paged", "dense", "chunked",
                                  "prefix_relay", "int8", "nemotron"])
def test_deep_audit_clean_on_every_engine_path(path):
    """Every step of each engine path ends in a clean deep audit (a
    violation would raise EngineFault), and the drained engine leaks
    nothing."""
    core, waves = _path_engine(path)
    calls = 0
    for wave in waves:
        for p in wave:
            core.add_request(p, SamplingParams(max_new_tokens=8))
        while core.has_work():
            core.step()
            calls += 1
    assert core.fault_stats()["audit_steps"] == calls > 0
    assert invariants.audit(core, deep=True) == []
    assert invariants.audit_leaks(core) == []
    assert all(r.finish_reason == "length" for r in core.done)
    if path == "prefix_relay":
        assert core.relay_steps > 0
    if path == "chunked":
        assert any(len(r.prompt) > 8 for r in core.done)


def test_llm_stream_quarantine_ends_typed():
    """``LLM(faults=...)``: a stream quarantined by NaN logits ends in a
    terminal chunk with ``finish_reason="error"``; the concurrent stream
    gets a fault-free ``LLM``'s tokens."""
    _, tcfg, _, tparams = _model()
    prompts = _prompts(2, seed=15)
    sp = SamplingParams(max_new_tokens=6)
    want = LLM(tcfg, tparams, EngineConfig(**ECFG),
               device="cpu").generate(prompts, sp)
    llm = LLM(tcfg, tparams, EngineConfig(**ECFG), device="cpu",
              faults=FaultInjector([FaultSpec("step.logits", mode="nan",
                                              uid=0)]))
    streams = [llm.stream(p, sp) for p in prompts]
    chunks = [[next(s)] for s in streams]     # both submitted
    for s, got in zip(streams, chunks):
        got.extend(s)
    assert chunks[0][-1].finished
    assert chunks[0][-1].finish_reason == FINISH_ERROR
    assert chunks[1][-1].finish_reason == "length"
    assert [t for c in chunks[1] for t in c.token_ids] == want[1].token_ids
    assert llm.core.fault_stats()["quarantined"] == 1
    assert invariants.audit_leaks(llm.core) == []


# ---------------------------------------------------------------------------
# KV-tier offload faults (the reference's three, in lockstep)
# ---------------------------------------------------------------------------
OFFLOAD = dict(batch_slots=1, prefix_cache=True, kv_offload=True,
               num_pages=12, host_pages=64, tier_prefetch=False)


def _family_workload(rng):
    """The reference's: prefix-family prompts, then extensions of two of
    them whose matches run through demoted suffix leaves."""
    prefix = rng.integers(1, 64, size=16).tolist()
    base = [prefix + rng.integers(1, 64, size=8).tolist()
            for _ in range(4)]
    ext = [p + rng.integers(1, 64, size=8).tolist() for p in base[:2]]
    return base + ext


def _offload_run(plan, workload):
    """The workload one request at a time through the reference's and the
    port's cores under ``plan``; every finish, token, ``fault_stats()``,
    ``tier_stats()`` and ``prefix_stats()`` held equal."""
    cores = _cores(plan, **OFFLOAD)
    jreqs, treqs = [], []
    for p in workload:
        j, t = _submit(cores, [p])
        for core in cores:
            _drain(core)
        jreqs += j
        treqs += t
    _hold(cores, jreqs, treqs)
    jcore, tcore = cores
    assert tcore.tier_stats() == jcore.tier_stats()
    assert tcore.prefix_stats() == jcore.prefix_stats()
    assert all(r.finish_reason == "length" for r in treqs)
    return cores, treqs


def test_offload_corruption_is_caught_at_promotion_and_replanned():
    """``offload.out`` mode="corrupt" damages the host copy after its CRC
    stamp; promotion catches the mismatch, drops only that entry and
    re-plans cold: nothing quarantined, no promotion, the tokens of a
    fault-free run, and the reference's counters."""
    workload = _family_workload(np.random.default_rng(20))
    (_, core), treqs = _offload_run(
        [dict(site="offload.out", mode="corrupt", count=-1)], workload)
    assert any(f["site"] == "offload.out" for f in core.faults.fired)
    assert core.tier_stats()["offload_checksum_failures"] > 0
    st = core.prefix_stats()
    assert st["promoted_blocks"] == 0 and st["promoted_snapshots"] == 0
    assert core.fault_stats()["quarantined"] == 0
    clean = _clean(core, *[[p] for p in workload],
                   batch_slots=1, prefix_cache=True)
    assert [r.generated for r in treqs] == [r.generated for r in clean]


def test_offload_out_noncorrupt_mode_declines_demotion():
    """Any other ``offload.out`` mode declines the demotion: the victim
    drops, nothing reaches the host tier. The dropped entries re-plan with
    less of their prefix cached, so the tokens are held against the
    reference's under the same plan (its own test's comparison with an
    unpressured run fails since the seed: cached != cold, ROADMAP
    "Reference caveats")."""
    workload = _family_workload(np.random.default_rng(21))
    (_, core), _ = _offload_run(
        [dict(site="offload.out", mode="error", count=-1)], workload)
    st = core.prefix_stats()
    assert st["demoted_blocks"] == 0 and st["demoted_snapshots"] == 0
    assert st["evicted_blocks"] + st["evicted_snapshots"] > 0
    assert core.tiers.tier_pages() == {
        k: 0 for k in core.tiers.tier_pages()}


def test_offload_in_fault_at_promotion_replans_cold():
    """An injected ``offload.in`` failure at promotion drops the entry and
    re-plans cold: tokens of a fault-free run, nothing quarantined."""
    workload = _family_workload(np.random.default_rng(22))
    (_, core), treqs = _offload_run([dict(site="offload.in", count=1)],
                                    workload)
    assert [f["site"] for f in core.faults.fired] == ["offload.in"]
    assert core.fault_stats()["quarantined"] == 0
    clean = _clean(core, *[[p] for p in workload],
                   batch_slots=1, prefix_cache=True)
    assert [r.generated for r in treqs] == [r.generated for r in clean]
