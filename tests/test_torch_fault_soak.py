"""The port's seeded fault-injection soak (``serving.soak``) against the
JAX package's, on the CPU.

``tests/test_fault_soak.py``'s setting (a reduced fp32 chai-llama-7b, 2
layers, d 32, vocab 128, warmup 3; 3 slots, page 8, the prefix cache and
relay decode on, ``audit_level="deep"``) and its 24-request workload of
seed 3 (shared-prefix families, snapshot duplicates, priority-1 arrivals
that preempt, scripted aborts), on the same weights. The plan arms every site the port
serves but ``kernel.decode``: an allocator failure (transient and error),
a failed snapshot restore, a relay-residency fault, a prefill and a
CLUSTER failure, NaN logits.

The reference's faulted run goes first; the port's engines then cluster
each request through the reference's membership of it, after checking
their own differs at most by a two-head tie (ROADMAP "Two-head cluster
ties").

Held: the port's workload is the reference's; the port's clean and faulted
runs drain (every request typed-terminal, no leak, a deep audit after
every step); untouched completed requests keep the clean run's tokens;
and the faulted run gives the reference's ``run_soak`` outcome under the
same plan (each request's finish reason, tokens, error and cache hit, the
step count, the prefix-cache counters, every fault counter and the
injector's firing log).
"""
import numpy as np
import torch

import jax

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.serving import faults as jfaults
from repro.serving import soak as jsoak
from repro.serving import engine as jengine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.serving import engine as tengine
from repro_torch.serving import soak
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.faults import FaultSpec
from repro_torch.weights import params_from_numpy
from test_torch_api import _pair_tie

TERMINAL = {"length", "stop", "aborted", "error"}
ECFG = dict(batch_slots=3, max_seq=64, page_size=8, prefix_cache=True,
            relay_decode=True, audit_level="deep")
PLAN = [
    dict(site="pool.alloc", mode="transient", count=1),
    dict(site="pool.alloc", mode="error", uid=5, count=1),
    dict(site="snapshot.restore", mode="error", count=1),
    dict(site="relay.residency", mode="error", count=1),
    dict(site="kernel.prefill", mode="error", uid=9, count=1),
    dict(site="kernel.cluster", mode="error", uid=13, count=1),
    dict(site="step.logits", mode="nan", uid=16, count=1),
]


def _workload(build):
    return build(3, 24, page_size=8, vocab=128)


def _record_reference(monkeypatch):
    """{uid: membership} of every CLUSTER transition of the reference
    engines built from here on."""
    held = {}
    init = jengine.EngineCore.__init__

    def patched(self, *args, **kw):
        init(self, *args, **kw)
        cluster = self._cluster_fn()

        def rec(state, ctx, slot, *rest):
            i = int(slot)
            uid = self._slot_req[i].uid
            state, ctx = cluster(state, ctx, slot, *rest)
            held[uid] = {k: np.array(v[:, i]) for k, v in ctx.items()}
            return state, ctx
        self._cluster_slot = rec

    monkeypatch.setattr(jengine.EngineCore, "__init__", patched)
    return held


def _force_membership(monkeypatch, held):
    """The port engines built from here on cluster each request through
    its membership in ``held``, after checking their own differs at most
    by two-head ties (a request ``held`` lacks keeps its own)."""
    init = tengine.EngineCore.__init__

    def patched(self, *args, **kw):
        init(self, *args, **kw)
        own = self._identify

        def forced(sc):
            i = int(np.flatnonzero(self._phases == tcache.PHASE_CLUSTER)[0])
            mine = own(sc)
            want = held.get(self._slot_req[i].uid)
            if want is None:
                return mine
            np.testing.assert_array_equal(mine["h2c"][:, 0], want["h2c"])
            for row, (a, b) in enumerate(zip(mine["reps"][:, 0].numpy(),
                                             want["reps"])):
                for j in np.flatnonzero(a != b):
                    assert _pair_tie(want["h2c"][row], j, a[j], b[j])
            return {k: torch.from_numpy(v)[:, None]
                    for k, v in want.items()}
        self._identify = forced

    monkeypatch.setattr(tengine.EngineCore, "__init__", patched)


def test_fault_soak_matches_reference(monkeypatch):
    kw = dict(n_layers=2, d_model=32, d_ff=64, vocab=128)
    jcfg = jreduced(jget_config("chai-llama-7b"), **kw).replace(
        dtype="float32").with_chai(enabled=True, warmup_tokens=3)
    tcfg = reduced(get_config("chai-llama-7b"), **kw).with_chai(
        enabled=True, warmup_tokens=3)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    wl = _workload(soak.build_workload)
    assert wl == _workload(jsoak.build_workload)
    assert any(w["abort_at"] is not None for w in wl)
    assert any(w["priority"] == 1 for w in wl)

    held = _record_reference(monkeypatch)
    jfaulted = jsoak.run_soak(
        jcfg, jparams, JEngineConfig(**ECFG),
        faults=jfaults.FaultInjector([jfaults.FaultSpec(**a)
                                      for a in PLAN]),
        workload=[dict(w) for w in wl], seed=3)
    _force_membership(monkeypatch, held)

    out = soak.run_soak_pair(tcfg, tparams, EngineConfig(**ECFG),
                             specs=[FaultSpec(**a) for a in PLAN],
                             workload=wl, seed=3, device="cpu")
    clean, faulted = out["clean"], out["faulted"]
    assert clean["unfinished"] == [] and clean["leaks"] == []
    assert clean["fault_stats"]["quarantined"] == 0
    assert clean["fault_stats"]["audit_steps"] == clean["steps"]
    assert clean["prefix_stats"]["snapshot_hits"] > 0
    assert faulted["unfinished"] == [] and faulted["leaks"] == []
    finishes = {uid: r["finish"] for uid, r in faulted["requests"].items()}
    assert set(finishes.values()) <= TERMINAL, finishes
    for uid, r in faulted["requests"].items():
        if r["finish"] == "error":
            assert r["error"], f"uid {uid} typed-failed without a message"
    fs = faulted["fault_stats"]
    fired = {f["site"] for f in fs["injector"]["fired"]}
    assert {a["site"] for a in PLAN} == fired, fired
    assert fs["quarantined"] >= 3 and fs["relay_dissolved"] >= 1
    assert fs["audit_steps"] == faulted["steps"]
    assert out["parity"] and out["mismatches"] == []
    assert faulted["requests"] == jfaulted["requests"]
    for key in ("steps", "unfinished", "leaks", "fault_stats",
                "preemptions"):
        assert faulted[key] == jfaulted[key], key
    assert faulted["preemptions"] >= 1 and clean["preemptions"] >= 1
    # the prefix stats count the KV tiers' demotions and promotions too,
    # all 0 here (no kv_offload)
    assert faulted["prefix_stats"] == jfaulted["prefix_stats"]
    tiers = {k: v for k, v in faulted["prefix_stats"].items()
             if k.startswith(("demoted_", "promoted_"))}
    assert len(tiers) == 4 and not any(tiers.values())
