"""Engine-wide telemetry: metrics registry, step traces, request timelines.

Zero-dependency observability substrate for the serving engine, tiered by
``EngineConfig.telemetry``:

  off    null object; every hook is a no-op behind the engine's
         ``tel.enabled`` guard, so the off tier adds no device work and no
         torch op to any step (``tests/test_torch_telemetry.py`` records
         the ops of a decode step at off and at trace and holds them
         equal).
  basic  MetricsRegistry counters/gauges/histograms + per-request
         lifecycle timelines (enqueue -> admit -> phase transitions ->
         first token -> finish).  No spans.
  trace  everything in basic, plus structured spans for every
         ``EngineCore.step()`` stage, exportable as a Chrome trace.

Spans and timeline events are stamped on the host clock
(``time.perf_counter`` / ``time.time``). On an asynchronous device a span
measures the host time of its stage: ``decode.dispatch`` is the time to
enqueue the decode's kernels, and ``sample`` absorbs the wait for them,
since its device-to-host copy of the tokens is the step's one
synchronization.

The registry is snapshot-able (JSON-ready dict) and mergeable so a
sharded engine can aggregate per-shard registries into one scrape.
Export formats (Prometheus text, Chrome trace JSON, JSONL event logs)
live in ``serving/exporters.py``. This module is pure Python.

All instrumentation hooks that allocate or format are guarded engine-side
by ``tel.enabled`` / handed a shared null context manager, so the "off"
tier costs at most a handful of attribute reads per step.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

TIERS = ("off", "basic", "trace")

# Default histogram buckets (seconds scale — covers sub-ms CPU decode
# steps through multi-second prefill/queue waits).  +Inf is implicit.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Counters, gauges and bounded-bucket histograms with label sets.

    Names follow Prometheus conventions (``snake_case``, counters end in
    ``_total``, timings in ``_seconds``).  A (name, label-set) pair is one
    series.  ``snapshot()`` returns a plain JSON-ready dict; ``merge()``
    folds another snapshot in (counters and histogram buckets add;
    gauges add too, i.e. merged gauges read as cross-shard totals).
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"help": str, "series": {lkey: float}}
        self._counters: Dict[str, Dict[str, Any]] = {}
        self._gauges: Dict[str, Dict[str, Any]] = {}
        # name -> {"help", "buckets": tuple, "series":
        #          {lkey: {"counts": [int]*(nb+1), "sum": f, "count": n}}}
        self._histograms: Dict[str, Dict[str, Any]] = {}

    # -- write side ------------------------------------------------------
    def counter(self, name: str, value: float = 1.0,
                labels: Optional[Dict[str, Any]] = None, help: str = ""):
        if value < 0:
            raise ValueError(f"counter {name} increment must be >= 0")
        key = _label_key(labels)
        with self._lock:
            m = self._counters.setdefault(name, {"help": help, "series": {}})
            m["series"][key] = m["series"].get(key, 0.0) + value

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, Any]] = None, help: str = ""):
        key = _label_key(labels)
        with self._lock:
            m = self._gauges.setdefault(name, {"help": help, "series": {}})
            m["series"][key] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, Any]] = None,
                buckets: Optional[Tuple[float, ...]] = None, help: str = ""):
        key = _label_key(labels)
        with self._lock:
            m = self._histograms.get(name)
            if m is None:
                bks = tuple(buckets) if buckets else DEFAULT_BUCKETS
                if list(bks) != sorted(bks):
                    raise ValueError(f"histogram {name} buckets not sorted")
                m = self._histograms[name] = {
                    "help": help, "buckets": bks, "series": {}}
            s = m["series"].get(key)
            if s is None:
                s = m["series"][key] = {
                    "counts": [0] * (len(m["buckets"]) + 1),
                    "sum": 0.0, "count": 0}
            v = float(value)
            if math.isnan(v):
                return
            # First bucket whose upper bound >= v; last slot is +Inf.
            idx = len(m["buckets"])
            for i, ub in enumerate(m["buckets"]):
                if v <= ub:
                    idx = i
                    break
            s["counts"][idx] += 1
            s["sum"] += v
            s["count"] += 1

    # -- read side -------------------------------------------------------
    @staticmethod
    def _series_list(series, render):
        return [{"labels": dict(k), **render(v)} for k, v in
                sorted(series.items())]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": {
                    n: {"help": m["help"],
                        "series": self._series_list(
                            m["series"], lambda v: {"value": v})}
                    for n, m in sorted(self._counters.items())},
                "gauges": {
                    n: {"help": m["help"],
                        "series": self._series_list(
                            m["series"], lambda v: {"value": v})}
                    for n, m in sorted(self._gauges.items())},
                "histograms": {
                    n: {"help": m["help"], "buckets": list(m["buckets"]),
                        "series": self._series_list(
                            m["series"],
                            lambda s: {"counts": list(s["counts"]),
                                       "sum": s["sum"],
                                       "count": s["count"]})}
                    for n, m in sorted(self._histograms.items())},
            }

    def merge(self, snap: Dict[str, Any]) -> None:
        """Fold another registry's ``snapshot()`` into this one."""
        for name, m in snap.get("counters", {}).items():
            for s in m["series"]:
                self.counter(name, s["value"], labels=s["labels"],
                             help=m.get("help", ""))
        for name, m in snap.get("gauges", {}).items():
            for s in m["series"]:
                key = _label_key(s["labels"])
                with self._lock:
                    g = self._gauges.setdefault(
                        name, {"help": m.get("help", ""), "series": {}})
                    g["series"][key] = g["series"].get(key, 0.0) + s["value"]
        for name, m in snap.get("histograms", {}).items():
            bks = tuple(m["buckets"])
            with self._lock:
                h = self._histograms.setdefault(
                    name, {"help": m.get("help", ""), "buckets": bks,
                           "series": {}})
                if tuple(h["buckets"]) != bks:
                    raise ValueError(
                        f"histogram {name}: bucket mismatch on merge")
                for s in m["series"]:
                    key = _label_key(s["labels"])
                    t = h["series"].get(key)
                    if t is None:
                        t = h["series"][key] = {
                            "counts": [0] * (len(bks) + 1),
                            "sum": 0.0, "count": 0}
                    for i, c in enumerate(s["counts"]):
                        t["counts"][i] += c
                    t["sum"] += s["sum"]
                    t["count"] += s["count"]


class _Span:
    """Context manager recording one closed span into the telemetry sink."""

    __slots__ = ("_tel", "name", "step", "args", "t0")

    def __init__(self, tel, name, step, args):
        self._tel, self.name, self.step, self.args = tel, name, step, args
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self._tel._add_span(self.name, self.step, self.t0, t1,
                            self.args, error=exc_type is not None)
        return False


class _NullCM:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CM = _NullCM()


def summarize_timeline(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Derive TTFT / queue time / ITL / counts from a raw event list."""
    first = {}
    for ev in events:
        first.setdefault(ev["ev"], ev["t"])
    t_enq = first.get("enqueue")
    t_admit = first.get("admit")
    t_first = first.get("first_token")
    t_fin = first.get("finish")
    tok_ts = [ev["t"] for ev in events if ev["ev"] == "tokens"]
    itl = [b - a for a, b in zip(tok_ts, tok_ts[1:])]
    out: Dict[str, Any] = {
        "n_events": len(events),
        "n_tokens": sum(int(ev.get("n", 1)) for ev in events
                        if ev["ev"] == "tokens"),
        "preemptions": sum(1 for ev in events if ev["ev"] == "preempt"),
        "phases": [ev["phase"] for ev in events if ev["ev"] == "phase"],
        "itl_s": itl,
    }
    if t_enq is not None and t_admit is not None:
        out["queue_s"] = t_admit - t_enq
    if t_enq is not None and t_first is not None:
        out["ttft_s"] = t_first - t_enq
    if t_enq is not None and t_fin is not None:
        out["latency_s"] = t_fin - t_enq
    fin = [ev for ev in events if ev["ev"] == "finish"]
    if fin:
        out["finish_reason"] = fin[-1].get("reason")
    return out


class Telemetry:
    """Live telemetry sink for one EngineCore (basic and trace tiers).

    Spans (trace tier) are bounded: once ``max_spans`` are held, further
    spans are counted in ``spans_dropped`` instead of stored.  Finished
    request timelines are kept in an LRU of ``max_timelines``; in-flight
    timelines are unbounded but naturally small (≤ queue + slots).
    """

    def __init__(self, tier: str = "basic", *, max_spans: int = 1 << 16,
                 max_timelines: int = 1024):
        if tier not in TIERS or tier == "off":
            raise ValueError(f"Telemetry tier must be basic|trace, got {tier}")
        self.tier = tier
        self.enabled = True
        self.tracing = tier == "trace"
        self.registry = MetricsRegistry()
        self.max_spans = max_spans
        self.max_timelines = max_timelines
        self.spans: List[Dict[str, Any]] = []
        self.spans_dropped = 0
        self._active: Dict[str, List[Dict[str, Any]]] = {}
        self._finished: "collections.OrderedDict[str, List[Dict[str, Any]]]" \
            = collections.OrderedDict()
        self._last_token_t: Dict[str, float] = {}

    # -- metrics passthrough --------------------------------------------
    def counter(self, name, value=1.0, help="", **labels):
        self.registry.counter(name, value, labels=labels or None, help=help)

    def gauge(self, name, value, help="", **labels):
        self.registry.gauge(name, value, labels=labels or None, help=help)

    def observe(self, name, value, help="", buckets=None, **labels):
        self.registry.observe(name, value, labels=labels or None,
                              buckets=buckets, help=help)

    # -- spans -----------------------------------------------------------
    def span(self, name: str, step: int = -1, **args):
        if not self.tracing:
            return _NULL_CM
        return _Span(self, name, step, args or None)

    def _add_span(self, name, step, t0, t1, args, error=False):
        if len(self.spans) >= self.max_spans:
            self.spans_dropped += 1
            return
        sp = {"name": name, "step": step, "t0": t0, "t1": t1}
        if args:
            sp["args"] = args
        if error:
            sp["error"] = True
        self.spans.append(sp)

    # -- request timelines ----------------------------------------------
    def event(self, uid: str, name: str, t: Optional[float] = None, **data):
        ev = {"uid": uid, "ev": name,
              "t": time.time() if t is None else t}
        if data:
            ev.update(data)
        tl = self._active.get(uid)
        if tl is None:
            if name == "enqueue":
                # Re-submitted uid: restart its timeline rather than
                # append to a sealed one.
                self._finished.pop(uid, None)
            tl = self._active[uid] = []
        tl.append(ev)

    def token(self, uid: str, n: int = 1, t: Optional[float] = None):
        """Record n tokens emitted for uid; feeds the ITL histogram."""
        now = time.time() if t is None else t
        last = self._last_token_t.get(uid)
        if last is not None and n == 1:
            self.observe("request_itl_seconds", now - last,
                         help="Inter-token latency (per decode token)")
        self._last_token_t[uid] = now
        self.event(uid, "tokens", t=now, n=n)

    def finish(self, uid: str):
        """Seal uid's timeline (moves it to the bounded finished LRU)."""
        self._last_token_t.pop(uid, None)
        tl = self._active.pop(uid, None)
        if tl is None:
            return
        self._finished[uid] = tl
        self._finished.move_to_end(uid)
        while len(self._finished) > self.max_timelines:
            self._finished.popitem(last=False)

    def timeline(self, uid: str) -> Optional[Dict[str, Any]]:
        tl = self._active.get(uid) or self._finished.get(uid)
        if tl is None:
            return None
        return {"uid": uid, "events": list(tl),
                "summary": summarize_timeline(tl)}

    def timelines(self) -> List[Dict[str, Any]]:
        out = [self.timeline(uid) for uid in
               list(self._finished) + list(self._active)]
        return [t for t in out if t is not None]

    def iter_events(self) -> Iterable[Dict[str, Any]]:
        for tl in list(self._finished.values()) + list(self._active.values()):
            for ev in tl:
                yield ev

    # -- snapshots -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        snap = self.registry.snapshot()
        snap["meta"] = {"tier": self.tier, "spans": len(self.spans),
                        "spans_dropped": self.spans_dropped,
                        "timelines": len(self._active) + len(self._finished)}
        return snap


class NullTelemetry:
    """The "off" tier: every hook is a no-op; ``enabled`` gates all
    engine-side formatting/allocation so the hot path is untouched."""

    tier = "off"
    enabled = False
    tracing = False
    registry = None
    spans: List[Dict[str, Any]] = []
    spans_dropped = 0

    def counter(self, *a, **k):
        pass

    def gauge(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def span(self, *a, **k):
        return _NULL_CM

    def event(self, *a, **k):
        pass

    def token(self, *a, **k):
        pass

    def finish(self, *a, **k):
        pass

    def timeline(self, uid):
        return None

    def timelines(self):
        return []

    def iter_events(self):
        return iter(())

    def snapshot(self):
        return None


def make_telemetry(tier: str):
    """Factory: ``off`` → shared-shape NullTelemetry, else a live sink."""
    if tier not in TIERS:
        raise ValueError(f"telemetry tier must be one of {TIERS}, got {tier!r}")
    if tier == "off":
        return NullTelemetry()
    return Telemetry(tier)
