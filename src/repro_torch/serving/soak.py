"""Deterministic fault-injection soak over the step-driven engine.

The soak drives ``EngineCore.step()`` through a SCRIPTED workload: every
request's arrival, priority and abort are keyed to an engine step number,
never wall clock, so two runs over the same (workload seed, fault plan
seed) take identical paths. The workload mixes what the robustness layer
must survive at once:

* shared-prefix families (radix hits; relay groups when ``relay_decode``)
  and exact-duplicate greedy prompts (CHAI snapshot capture, restore and
  host-side replay),
* priority-1 arrivals into a full slot pool (preemption: the KV swap-out
  and swap-in, the ``swap.corrupt`` / ``swap.in`` fault sites),
* scripted aborts mid-flight,
* an optional ``FaultInjector`` plan threaded through every engine site.

``run_soak`` returns a JSON-ready report: per-request outcomes (every
request must end completed or typed-failed), the pool counters, the
idle-engine leak audit, and the engine's fault stats including the
injector's replayable firing log, and, when the engine's telemetry is on,
a ``"telemetry"`` section (the metrics snapshot, the Chrome trace and the
request timelines; wall-clock-dependent, so no parity check reads it).

``run_soak_pair`` runs the SAME workload fault-free and under a plan and
computes the token-parity set: completed requests not named by any
injector firing must generate identical tokens in both runs (greedy
tokens are schedule-invariant, so quarantines perturbing the batch
composition never perturb surviving requests' outputs).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.serving import invariants as invariants_mod
from repro_torch.serving.engine import EngineConfig, EngineCore
from repro_torch.serving.faults import CapacityError, FaultInjector
from repro_torch.serving.sampling import SamplingParams

_MAX_STEPS = 20_000


def build_workload(seed: int = 0, n_requests: int = 24, *,
                   page_size: int = 8, vocab: int = 128,
                   arrival_span: int = 40) -> List[dict]:
    """Scripted request list: dicts of {step, prompt, max_new, priority,
    abort_at}, the JAX package's draws for the same arguments. Two
    shared-prefix families (2 whole pages each) seed the radix tree /
    relay groups; every 6th request duplicates the family-A base prompt
    exactly (snapshot capture on the first, restore/replay on the rest);
    every 5th arrives at priority 1 (slot preemption); every 7th is
    aborted a few steps after arrival."""
    rng = np.random.default_rng(seed)
    fam_a = rng.integers(1, vocab, size=2 * page_size).tolist()
    fam_b = rng.integers(1, vocab, size=2 * page_size).tolist()
    dup = fam_a + rng.integers(1, vocab, size=3).tolist()
    wl = []
    for j in range(n_requests):
        if j % 6 == 2:
            prompt = list(dup)              # exact duplicate: snapshot
        else:
            fam = [fam_a, fam_b, None][j % 3]
            suffix = rng.integers(1, vocab, size=int(rng.integers(2, 7)))
            prompt = ((fam or []) + suffix.tolist()
                      if fam is not None else
                      rng.integers(1, vocab,
                                   size=int(rng.integers(4, 12))).tolist())
        w = {"step": int(rng.integers(0, arrival_span)),
             "prompt": prompt,
             "max_new": int(rng.integers(6, 14)),
             "priority": 1 if j % 5 == 4 else 0,
             "abort_at": None}
        if j % 7 == 3:
            w["abort_at"] = w["step"] + int(rng.integers(3, 9))
        wl.append(w)
    wl.sort(key=lambda w: w["step"])
    return wl


def run_soak(cfg, params, ecfg: EngineConfig, *,
             faults: Optional[FaultInjector] = None,
             workload: Optional[List[dict]] = None,
             seed: int = 0, n_requests: int = 24, device=None) -> dict:
    """Drive one engine through the scripted workload to drain; returns
    the JSON-ready soak report. Raises if the engine fails to drain within
    ``_MAX_STEPS`` (a stuck scheduler is a soak failure). ``device``: the
    engine's (``None`` = CUDA)."""
    core = EngineCore(cfg, params, ecfg, faults=faults, device=device)
    wl = workload if workload is not None else build_workload(
        seed, n_requests, page_size=ecfg.page_size, vocab=cfg.vocab_size)
    pending = deque(wl)
    aborts: List[tuple] = []
    tracked: dict = {}
    step_no = 0
    while pending or core.has_work() or aborts:
        while pending and pending[0]["step"] <= step_no:
            w = pending.popleft()
            r = core.add_request(
                w["prompt"],
                SamplingParams(max_new_tokens=w["max_new"]),
                priority=w["priority"])
            tracked[r.uid] = r
            if w["abort_at"] is not None:
                aborts.append((w["abort_at"], r.uid))
        for s, uid in list(aborts):
            if s <= step_no:
                core.abort(uid)
                aborts.remove((s, uid))
        try:
            core.step()
        except CapacityError as err:
            # The head can never fit: typed-fail it, keep draining.
            core.abort(err.uid)
        step_no += 1
        if step_no > _MAX_STEPS:
            raise RuntimeError(
                f"soak did not drain in {_MAX_STEPS} steps: "
                f"{len(pending)} pending, queue {len(core.queue)}, "
                f"active {core.has_active}")
    counters = {"dense": core.dense_pool.counters() if core.dense_pool
                else None,
                "chai": core.chai_pool.counters() if core.chai_pool
                else None}
    report = {
        "workload_seed": seed,
        "steps": step_no,
        "requests": {
            int(uid): {"finish": r.finish_reason,
                       "tokens": [int(t) for t in r.generated],
                       "error": r.error,
                       "preemptions": r.preemptions,
                       "cache_hit": r.cache_hit}
            for uid, r in sorted(tracked.items())},
        "unfinished": [int(u) for u, r in tracked.items()
                       if not r.finished],
        "counters": counters,
        "leaks": invariants_mod.audit_leaks(core),
        "fault_stats": core.fault_stats(),
        "prefix_stats": core.prefix_stats(),
        "preemptions": core.preemptions,
    }
    if core.tel.enabled:
        # Wall-clock-dependent, so a section of its own: the replay and
        # parity comparisons read only "requests" and the injector log.
        report["telemetry"] = {
            "metrics": core.metrics(),
            "chrome_trace": core.step_trace(),
            "timelines": core.tel.timelines(),
        }
    return report


def affected_uids(report: dict) -> set:
    """Requests a fault plan touched directly: every uid named by an
    injector firing, plus everything that ended quarantined. (Aborted
    requests are schedule-dependent by construction and sit outside the
    parity contract.)"""
    inj = report["fault_stats"]["injector"] or {"fired": []}
    named = {f["uid"] for f in inj["fired"] if f["uid"] >= 0}
    named |= {uid for uid, r in report["requests"].items()
              if r["finish"] == "error"}
    return named


def run_soak_pair(cfg, params, ecfg: EngineConfig, *, specs,
                  fault_seed: int = 0, seed: int = 0,
                  n_requests: int = 24, workload=None, device=None) -> dict:
    """Fault-free run against the same workload under ``specs``; returns
    {"clean", "faulted", "parity", "mismatches"}: parity lists every uid
    that was required to match token for token, mismatches any that
    failed to. ``workload``: the scripted requests (default
    ``build_workload(seed, n_requests, ...)``); each run gets its own
    copy."""
    wl = workload if workload is not None else build_workload(
        seed, n_requests, page_size=ecfg.page_size, vocab=cfg.vocab_size)
    clean = run_soak(cfg, params, ecfg, workload=[dict(w) for w in wl],
                     seed=seed, device=device)
    faulted = run_soak(cfg, params, ecfg,
                       faults=FaultInjector(list(specs), seed=fault_seed),
                       workload=[dict(w) for w in wl], seed=seed,
                       device=device)
    touched = affected_uids(faulted)
    done = ("length", "stop")
    parity = [uid for uid, r in faulted["requests"].items()
              if uid not in touched and r["finish"] in done
              and clean["requests"][uid]["finish"] in done]
    mismatches = [uid for uid in parity
                  if faulted["requests"][uid]["tokens"]
                  != clean["requests"][uid]["tokens"]]
    return {"clean": clean, "faulted": faulted,
            "parity": sorted(parity), "mismatches": sorted(mismatches)}
