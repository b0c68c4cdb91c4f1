"""The port's telemetry (``serving.telemetry``, ``serving.exporters`` and the
engine's hooks) against the JAX package's, on the CPU.

In the shape of ``tests/test_telemetry.py``: the registry, its merge,
``summarize_timeline`` and the tiers, each run through the reference's
functions and the port's on the same inputs (snapshots, Prometheus text
and Chrome-trace JSON equal); the off tier adding no torch op to a decode
step (the reference's "jaxpr-identical" check, here a
``TorchDispatchMode`` record of one step at off and at trace); the spans
covering every stage; then the reference's ``EngineCore`` and the port's on
the same weights (``weights.params_from_numpy``) and workload, the port
clustering through the reference's membership: every counter, gauge and
histogram count equal (sums and buckets are timing and are left out), each
step's span names and args, each request's timeline events (times left
out), and the Prometheus samples; decode healing, the ``kernel.prefill``
and ``kernel.cluster`` quarantines with their timeline events, and the
soak report's telemetry section.

The preemption's telemetry is held in ``tests/test_torch_preemption.py``
and ``AsyncLLM``'s accessors in ``tests/test_torch_async.py``.
"""
import json

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from repro.serving import exporters as jexporters
from repro.serving import soak as jsoak
from repro.serving import telemetry as jtelemetry
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.serving import exporters, soak
from repro_torch.serving.engine import EngineConfig, EngineCore
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.telemetry import (DEFAULT_BUCKETS, TIERS,
                                           MetricsRegistry, NullTelemetry,
                                           Telemetry, make_telemetry,
                                           summarize_timeline)
from test_torch_faults import (ECFG, _cores, _drain, _model, _prompts,
                               _submit)

TEL_ECFG = {**ECFG, "telemetry": "trace"}


def _counter_value(snap, name, **labels):
    total = 0.0
    for s in snap["counters"].get(name, {"series": []})["series"]:
        if all(s["labels"].get(k) == v for k, v in labels.items()):
            total += s["value"]
    return total


def _both(fn):
    """``fn(module)`` on the port's telemetry module and the reference's."""
    from repro_torch.serving import telemetry
    return fn(telemetry), fn(jtelemetry)


# ---------------------------------------------------------------------------
# registry semantics, held against the reference's
# ---------------------------------------------------------------------------
def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("req_total", 2, labels={"kind": "cold"}, help="h")
    reg.counter("req_total", labels={"kind": "cold"})
    reg.counter("req_total", labels={"kind": "warm"})
    reg.gauge("depth", 4)
    reg.gauge("depth", 7)                     # gauges overwrite
    reg.observe("lat_seconds", 0.003, buckets=(0.001, 0.01, 0.1))
    reg.observe("lat_seconds", 5.0, buckets=(0.001, 0.01, 0.1))
    reg.observe("lat_seconds", float("nan"), buckets=(0.001, 0.01, 0.1))
    reg.observe("step_seconds", 0.02, labels={"kind": "x"})
    return reg


def test_registry_counter_gauge_histogram_series():
    got, want = _both(lambda m: _fill(m).snapshot())
    assert got == want
    assert _counter_value(got, "req_total", kind="cold") == 3
    assert _counter_value(got, "req_total", kind="warm") == 1
    assert got["gauges"]["depth"]["series"][0]["value"] == 7
    h = got["histograms"]["lat_seconds"]["series"][0]
    assert h["count"] == 2 and h["sum"] == pytest.approx(5.003)
    assert h["counts"] == [0, 1, 0, 1]        # NaN dropped, 5.0 -> +Inf
    assert got["histograms"]["step_seconds"]["buckets"] == \
        list(DEFAULT_BUCKETS)
    json.dumps(got)
    with pytest.raises(ValueError):
        MetricsRegistry().counter("neg_total", -1)
    with pytest.raises(ValueError):
        MetricsRegistry().observe("x", 1.0, buckets=(2.0, 1.0))


def test_registry_merge_adds_counters_and_buckets():
    def merged(mod):
        a, b = mod.MetricsRegistry(), mod.MetricsRegistry()
        for reg, n in ((a, 2), (b, 5)):
            reg.counter("req_total", n, labels={"kind": "x"})
            reg.observe("lat_seconds", 0.002, buckets=(0.001, 0.01))
            reg.gauge("depth", n)
        a.merge(b.snapshot())
        c = mod.MetricsRegistry()
        c.counter("other_total", 4, labels={"site": "s"})
        c.observe("lat_seconds", 0.5, labels={"kind": "y"},
                  buckets=(0.001, 0.01))
        a.merge(c.snapshot())
        return a.snapshot()
    got, want = _both(merged)
    assert got == want
    assert _counter_value(got, "req_total", kind="x") == 7
    assert _counter_value(got, "other_total", site="s") == 4
    h = got["histograms"]["lat_seconds"]["series"]
    assert [s["count"] for s in h] == [2, 1]
    assert h[0]["counts"][1] == 2 and h[1]["counts"][2] == 1
    # merged gauges read as cross-shard totals
    assert got["gauges"]["depth"]["series"][0]["value"] == 7
    bad = MetricsRegistry()
    bad.observe("lat_seconds", 0.002, buckets=(0.5,))
    reg = MetricsRegistry()
    reg.observe("lat_seconds", 0.002, buckets=(0.001, 0.01))
    with pytest.raises(ValueError):
        reg.merge(bad.snapshot())


def test_summarize_timeline_derivations():
    evs = [
        {"uid": 1, "ev": "enqueue", "t": 10.0},
        {"uid": 1, "ev": "admit", "t": 10.5},
        {"uid": 1, "ev": "phase", "t": 10.5, "phase": "PREFILL"},
        {"uid": 1, "ev": "first_token", "t": 11.0},
        {"uid": 1, "ev": "tokens", "t": 11.0, "n": 1},
        {"uid": 1, "ev": "tokens", "t": 11.2, "n": 1},
        {"uid": 1, "ev": "preempt", "t": 11.3},
        {"uid": 1, "ev": "tokens", "t": 11.6, "n": 2},
        {"uid": 1, "ev": "finish", "t": 11.7, "reason": "length"},
    ]
    s = summarize_timeline(evs)
    assert s == jtelemetry.summarize_timeline(evs)
    assert s["queue_s"] == pytest.approx(0.5)
    assert s["ttft_s"] == pytest.approx(1.0)
    assert s["latency_s"] == pytest.approx(1.7)
    assert s["n_tokens"] == 4 and s["preemptions"] == 1
    assert s["phases"] == ["PREFILL"] and s["finish_reason"] == "length"


def test_make_telemetry_tiers():
    assert TIERS == jtelemetry.TIERS
    assert DEFAULT_BUCKETS == jtelemetry.DEFAULT_BUCKETS
    assert isinstance(make_telemetry("off"), NullTelemetry)
    assert not make_telemetry("off").enabled
    assert isinstance(make_telemetry("basic"), Telemetry)
    assert make_telemetry("trace").tracing
    assert not make_telemetry("basic").tracing
    off = make_telemetry("off")
    with off.span("step", step=0) as cm:
        assert cm is off.span("x")            # the shared null CM
    assert off.snapshot() is None and off.timeline(1) is None
    with pytest.raises(ValueError):
        make_telemetry("verbose")
    with pytest.raises(ValueError):
        Telemetry("off")
    _, tcfg, _, tparams = _model()
    with pytest.raises(ValueError):
        EngineCore(tcfg, tparams, EngineConfig(**{**ECFG,
                                                  "telemetry": "loud"}),
                   device="cpu")


def test_telemetry_bounds_spans_and_timelines():
    got, want = _both(lambda m: m.Telemetry("trace", max_spans=2,
                                            max_timelines=1))
    for tel in (got, want):
        for k in range(3):
            with tel.span("s", step=k, slot=k):
                pass
        for uid in (1, 2):
            tel.event(uid, "enqueue", t=1.0)
            tel.token(uid, t=2.0)
            tel.token(uid, t=2.5)
            tel.finish(uid)
    assert got.spans_dropped == want.spans_dropped == 1
    assert [(s["name"], s["step"], s["args"]) for s in got.spans] == \
        [(s["name"], s["step"], s["args"]) for s in want.spans]
    assert got.timeline(1) is None and got.timeline(2) == want.timeline(2)
    snap, jsnap = got.snapshot(), want.snapshot()
    assert snap["meta"] == jsnap["meta"]
    assert snap["histograms"] == jsnap["histograms"]


# ---------------------------------------------------------------------------
# exporters, held against the reference's
# ---------------------------------------------------------------------------
def test_prometheus_text_equals_reference_and_parses():
    reg = MetricsRegistry()
    reg.counter("req_total", 3, labels={"kind": "cold"}, help="requests")
    reg.counter("odd_total", 1.5, labels={"q": 'a"b\\c\nd'})
    reg.gauge("depth", 2, help="queue depth")
    reg.observe("lat_seconds", 0.002, buckets=(0.001, 0.01), help="lat")
    text = exporters.to_prometheus(reg.snapshot())
    assert text == jexporters.to_prometheus(reg.snapshot())
    parsed = exporters.parse_prometheus(text)
    assert parsed == jexporters.parse_prometheus(text)
    samples = {(n, tuple(sorted(l.items()))): v
               for n, l, v in parsed["samples"]}
    assert samples[("req_total", (("kind", "cold"),))] == 3
    assert samples[("odd_total", (("q", 'a"b\\c\nd'),))] == 1.5
    assert samples[("depth", ())] == 2
    assert parsed["types"]["lat_seconds"] == "histogram"
    assert samples[("lat_seconds_bucket", (("le", "0.001"),))] == 0
    assert samples[("lat_seconds_bucket", (("le", "+Inf"),))] == 1
    assert samples[("lat_seconds_count", ())] == 1
    for bad in ("not a metric line at all{", "# TYPE x flavour",
                'x{a=b} 1', "bad-name 1"):
        with pytest.raises(ValueError):
            exporters.parse_prometheus(bad)


def test_chrome_trace_equals_reference_and_roundtrips():
    spans = [{"name": "step", "step": 3, "t0": 1.0, "t1": 1.5,
              "args": {"slots": 2}},
             {"name": "sample", "step": 3, "t0": 1.1, "t1": 1.2,
              "error": True},
             {"name": "free", "step": -1, "t0": 2.0, "t1": 1.0}]
    obj = exporters.to_chrome_trace(spans)
    assert json.dumps(obj) == json.dumps(jexporters.to_chrome_trace(spans))
    evs = exporters.from_chrome_trace(json.dumps(obj))
    assert evs == jexporters.from_chrome_trace(obj)
    assert [e["name"] for e in evs] == ["step", "sample", "free"]
    assert evs[0]["dur"] == pytest.approx(5e5) and evs[2]["dur"] == 0.0
    assert evs[0]["args"] == {"slots": 2, "step": 3}
    assert evs[1]["args"]["error"] is True and "step" not in evs[2]["args"]
    with pytest.raises(ValueError):
        exporters.from_chrome_trace('{"no": "traceEvents"}')
    with pytest.raises(ValueError):
        exporters.from_chrome_trace(
            {"traceEvents": [{"ph": "X", "ts": 0, "pid": 0, "tid": 0}]})
    with pytest.raises(ValueError):
        exporters.from_chrome_trace({"traceEvents": [
            {"name": "a", "ph": "X", "ts": 0, "pid": 0, "tid": 0}]})


def test_jsonl_events_roundtrip():
    evs = [{"uid": 2, "ev": "enqueue", "t": 5.0},
           {"uid": 1, "ev": "enqueue", "t": 4.0, "n": 3}]
    text = exporters.events_jsonl(evs)
    assert text == jexporters.events_jsonl(evs)
    back = exporters.read_jsonl(text)
    assert back == jexporters.read_jsonl(text)
    assert [e["uid"] for e in back] == [1, 2]     # globally time-ordered
    assert exporters.events_jsonl([]) == ""


# ---------------------------------------------------------------------------
# the off tier: a no-op that adds no torch op
# ---------------------------------------------------------------------------
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _steady_step_ops(tier, audit):
    """The torch ops of one all-STEADY decode ``step()`` of a port engine
    at telemetry ``tier`` (prefix cache and relay on, two slots)."""
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(
        **{**ECFG, "telemetry": tier, "audit_level": audit},
        prefix_cache=True, relay_decode=True), device="cpu")
    rng = np.random.default_rng(4)
    shared = rng.integers(1, 64, size=16).tolist()
    core.add_request(shared + [1], SamplingParams(max_new_tokens=2))
    _drain(core)
    for _ in range(2):
        core.add_request(shared + rng.integers(1, 64, size=3).tolist(),
                         SamplingParams(max_new_tokens=12))
    while not (core.has_active and (core._phases == 4).all()):
        core.step()
    n0 = core.steps_executed
    with _Ops() as rec:
        core.step()
    assert core.steps_executed == n0 + 1 and core.relay_steps
    return rec.ops


@pytest.mark.parametrize("audit", ["basic", "deep"])
def test_off_tier_adds_no_torch_op(audit):
    """The same aten ops, in the same order, in one all-STEADY relay
    decode step at off, basic and trace: the tier never reaches the
    device program (the reference's jaxpr-identity check)."""
    off = _steady_step_ops("off", audit)
    assert off and any("copy" in op for op in off)
    assert _steady_step_ops("basic", audit) == off
    assert _steady_step_ops("trace", audit) == off


def test_off_tier_is_noop():
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(**ECFG), device="cpu")
    reqs = [core.add_request(p, SamplingParams(max_new_tokens=8))
            for p in _prompts(2)]
    _drain(core)
    assert all(r.finish_reason == "length" for r in reqs)
    assert core.metrics() is None and core.metrics_text() is None
    assert core.request_timeline(reqs[0].uid) is None
    assert core.step_trace()["traceEvents"] == []
    assert isinstance(core.tel, NullTelemetry)


def test_trace_tier_step_spans_cover_stages():
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(**TEL_ECFG), device="cpu")
    for p in _prompts(2):
        core.add_request(p, SamplingParams(max_new_tokens=8))
    _drain(core)
    by_step = {}
    for sp in core.tel.spans:
        by_step.setdefault(sp["step"], []).append(sp["name"])
    decode_steps = {s: n for s, n in by_step.items()
                    if "decode.dispatch" in n}
    assert len(decode_steps) == core.steps_executed
    for names in decode_steps.values():
        assert names.count("admit") >= 1
        for stage in ("cluster", "relay.form", "decode.dispatch", "sample",
                      "retire", "step", "audit"):
            assert names.count(stage) == 1, (stage, names)
    steps = sorted(by_step)
    assert steps == list(range(steps[0], steps[0] + len(steps)))
    trace = core.step_trace()
    assert len(exporters.from_chrome_trace(json.dumps(trace))) == \
        len(core.tel.spans)
    core2 = EngineCore(tcfg, tparams, EngineConfig(
        **{**ECFG, "telemetry": "basic"}), device="cpu")
    core2.add_request(_prompts(1)[0], SamplingParams(max_new_tokens=8))
    _drain(core2)
    assert core2.tel.spans == []


# ---------------------------------------------------------------------------
# the engines in lockstep with the reference's
# ---------------------------------------------------------------------------
def _metric_values(snap):
    """Counters and gauges by (name, labels); histograms by (name, labels)
    with their observation count only (sums and buckets are timing)."""
    out = {}
    for kind in ("counters", "gauges"):
        for name, m in snap[kind].items():
            for s in m["series"]:
                key = (kind, name, tuple(sorted(s["labels"].items())))
                out[key] = s["value"]
    for name, m in snap["histograms"].items():
        for s in m["series"]:
            out[("histograms", name,
                 tuple(sorted(s["labels"].items())))] = s["count"]
    return out


def _span_steps(tel):
    """[(step, [(name, args), ...]), ...] in recording order."""
    by = {}
    for sp in tel.spans:
        by.setdefault(sp["step"], []).append(
            (sp["name"], sp.get("args"), sp.get("error", False)))
    return sorted(by.items())


def _events(tel):
    """{uid: [event without its time]}: the timelines' content."""
    return {tl["uid"]: [{k: v for k, v in ev.items() if k != "t"}
                        for ev in tl["events"]]
            for tl in tel.timelines()}


def _prom(text):
    """Prometheus samples but the timing ones (histogram sums and
    buckets), as {(name, labels): value}."""
    parsed = exporters.parse_prometheus(text)
    return {(n, tuple(sorted(l.items()))): v
            for n, l, v in parsed["samples"]
            if not n.endswith(("_sum", "_bucket"))}, parsed["types"]


def _hold_telemetry(cores):
    """Every metric value and count, span sequence, timeline and
    Prometheus sample of the port's core equal to the reference's."""
    jcore, tcore = cores
    got, want = tcore.metrics(), jcore.metrics()
    assert _metric_values(got) == _metric_values(want)
    assert got["meta"] == want["meta"]
    assert _events(tcore.tel) == _events(jcore.tel)
    assert _span_steps(tcore.tel) == _span_steps(jcore.tel)
    jt = jcore.step_trace()["traceEvents"]
    tt = exporters.from_chrome_trace(json.dumps(tcore.step_trace()))
    assert [(e["name"], e["args"]) for e in tt] == \
        [(e["name"], e["args"]) for e in jt]
    assert _prom(tcore.metrics_text()) == _prom(jcore.metrics_text())
    for r in tcore.done:
        assert tcore.request_timeline(r.uid)["summary"]["n_tokens"] == \
            len(r.generated)
    return got


def _prefix_workload():
    """A shared 16-token prefix warmed by one request, three suffix
    requests, then the first suffix request's prompt again (a snapshot
    hit) and once more with a budget its warmup tokens cover (a replay)."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 64, size=16).tolist()
    suffixed = [shared + rng.integers(1, 64, size=n).tolist()
                for n in (3, 5, 9)]
    return ([[shared + [1]], suffixed, [suffixed[0]]],
            [8, 8, 8], [(suffixed[0], 3)])


@pytest.mark.parametrize("path", ["paged", "prefix_relay", "kv_offload"])
def test_engine_telemetry_matches_reference(path):
    """Request flow, TTFT / ITL / queue / latency counts, the CHAI gauges
    and counters, the relay and KV-tier counters and the occupancy gauges
    at "trace", on the same workload as the reference's core."""
    kw = {"telemetry": "trace"}
    if path == "prefix_relay":
        kw.update(prefix_cache=True, relay_decode=True)
    if path == "kv_offload":
        kw.update(batch_slots=1, prefix_cache=True, kv_offload=True,
                  num_pages=12, host_pages=64)
    cores = _cores(**kw)
    if path == "paged":
        _submit(cores, _prompts(3, seed=2))
        for core in cores:
            _drain(core)
    elif path == "prefix_relay":
        waves, _, replays = _prefix_workload()
        for wave in waves:
            _submit(cores, wave)
            for core in cores:
                _drain(core)
        for prompt, new in replays:
            _submit(cores, [prompt], max_new_tokens=new)
            for core in cores:
                _drain(core)
    else:
        rng = np.random.default_rng(9)
        prefix = rng.integers(1, 64, size=16).tolist()
        base = [prefix + rng.integers(1, 64, size=8).tolist()
                for _ in range(4)]
        for p in base + [base[0] + rng.integers(1, 64, size=8).tolist()]:
            _submit(cores, [p])
            for core in cores:
                _drain(core)
    jcore, tcore = cores
    assert [r.generated for r in tcore.done] == \
        [r.generated for r in jcore.done]
    snap = _hold_telemetry(cores)
    n_req = len(tcore.done)
    assert _counter_value(snap, "requests_finished_total",
                          reason="length") == n_req
    assert _counter_value(snap, "tokens_generated_total") == \
        sum(len(r.generated) for r in tcore.done)
    assert snap["histograms"]["request_ttft_seconds"]["series"][0][
        "count"] == n_req
    assert "chai_clusters" in snap["gauges"]
    if path == "prefix_relay":
        assert _counter_value(snap, "relay_groups_formed_total") > 0
        assert _counter_value(snap, "requests_admitted_total",
                              kind="replay") == 1
        assert _counter_value(snap, "snapshot_hit_tokens_total") > 0
    if path == "kv_offload":
        assert _counter_value(snap, "tier_transitions_total",
                              **{"from": "hot", "to": "host"}) > 0
        assert "promote_wait_seconds" in snap["histograms"]
        assert _counter_value(snap, "prefetch_hits_total") + \
            _counter_value(snap, "prefetch_misses_total") > 0


def test_request_timeline_lifecycle():
    cores = _cores(telemetry="basic", prefix_cache=True)
    _, treqs = _submit(cores, _prompts(3, seed=2))
    for core in cores:
        _drain(core)
    tcore = cores[1]
    for r in treqs:
        tl = tcore.request_timeline(r.uid)
        names = [e["ev"] for e in tl["events"]]
        assert names[0] == "enqueue" and names[-1] == "finish"
        assert "admit" in names and "first_token" in names
        s = tl["summary"]
        assert s["n_tokens"] == len(r.generated) == 8
        assert s["finish_reason"] == "length"
        assert 0 <= s["queue_s"] and 0 <= s["ttft_s"] <= s["latency_s"]
        assert len(s["itl_s"]) == 7
        assert [p for p in s["phases"]] == ["PREFILL", "WARMUP", "CLUSTER",
                                            "STEADY"]
    snap = _hold_telemetry(cores)
    assert _counter_value(snap, "cluster_transitions_total") == 3
    assert snap["gauges"]["engine_active_slots"]["series"][0]["value"] == 0
    parsed = exporters.parse_prometheus(tcore.metrics_text())
    assert parsed["types"]["request_ttft_seconds"] == "histogram"
    assert tcore.request_timeline(10**9) is None


# ---------------------------------------------------------------------------
# faults: healing and the kernel sites' quarantines
# ---------------------------------------------------------------------------
def test_decode_heal_counters_and_retry_span():
    """An injected ``kernel.decode`` fault: the step's decode.dispatch
    span is re-entered with ``retry=True``, the fallback and heal counters
    and the degraded gauge follow the reference's."""
    cores = _cores([dict(site="kernel.decode", count=1)],
                   telemetry="trace", decode_heal_steps=3)
    _submit(cores, _prompts(2, seed=6), max_new_tokens=12)
    for core in cores:
        _drain(core)
    snap = _hold_telemetry(cores)
    tcore = cores[1]
    assert _counter_value(snap, "decode_heals_total") == 1
    assert _counter_value(snap, "decode_fallbacks_total") == 1
    assert _counter_value(snap, "faults_injected_total",
                          site="kernel.decode") == 1
    assert snap["gauges"]["engine_degraded_decode"]["series"][0][
        "value"] == 0
    retried = [sp for sp in tcore.tel.spans
               if sp["name"] == "decode.dispatch"
               and (sp.get("args") or {}).get("retry")]
    assert len(retried) == 1 and retried[0]["args"]["degraded"] is True


@pytest.mark.parametrize("site,uid,word", [("kernel.prefill", 0, "prefill"),
                                           ("kernel.cluster", 1, "cluster")])
def test_kernel_fault_quarantine_on_timeline(site, uid, word):
    cores = _cores([dict(site=site, uid=uid, count=1)], telemetry="basic")
    _, treqs = _submit(cores, _prompts(2, seed=8 if uid == 0 else 9))
    for core in cores:
        _drain(core)
    snap = _hold_telemetry(cores)
    tcore = cores[1]
    assert treqs[uid].finish_reason == "error" and word in treqs[uid].error
    assert _counter_value(snap, "faults_injected_total", site=site) == 1
    assert _counter_value(snap, "requests_quarantined_total") == 1
    assert _counter_value(snap, "requests_finished_total",
                          reason="error") == 1
    tl = tcore.request_timeline(treqs[uid].uid)
    assert "quarantine" in [e["ev"] for e in tl["events"]]
    assert tl["summary"]["finish_reason"] == "error"


def test_soak_report_carries_telemetry_section():
    """The soak report's telemetry section at "trace", on the workload
    with its priority-1 arrival; the schedule (steps, each request's
    finish and preemptions) is the reference's ``run_soak``'s."""
    jcfg, tcfg, jparams, tparams = _model()
    ecfg = {**ECFG, "batch_slots": 3, "prefix_cache": True}
    wl = soak.build_workload(3, 8, page_size=8, vocab=64)
    assert any(w["priority"] == 1 for w in wl)
    report = soak.run_soak(tcfg, tparams, EngineConfig(**ecfg,
                                                       telemetry="trace"),
                           workload=[dict(w) for w in wl], device="cpu")
    tel = report["telemetry"]
    assert tel["metrics"]["counters"]["engine_steps_total"]["series"][0][
        "value"] == report["steps"]
    assert tel["chrome_trace"]["traceEvents"]
    assert len(tel["timelines"]) == len(report["requests"])
    json.dumps(report, default=float)
    off = soak.run_soak(tcfg, tparams, EngineConfig(**ecfg),
                        workload=[dict(w) for w in wl], device="cpu")
    assert "telemetry" not in off
    assert off["requests"] == report["requests"]
    assert off["steps"] == report["steps"]
    ref = jsoak.run_soak(jcfg, jparams, JEngineConfig(**ecfg),
                         workload=[dict(w) for w in wl])
    for key in ("steps", "preemptions", "unfinished", "leaks"):
        assert off[key] == ref[key], key
    assert {u: (r["finish"], r["preemptions"], len(r["tokens"]))
            for u, r in off["requests"].items()} == \
        {u: (r["finish"], r["preemptions"], len(r["tokens"]))
         for u, r in ref["requests"].items()}
