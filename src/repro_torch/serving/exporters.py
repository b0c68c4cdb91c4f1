"""Export formats for serving telemetry: Prometheus text, Chrome trace,
JSONL event logs — plus the matching loaders used by tests and benches.

Everything here is pure data-to-text (and back); the live sinks are in
``serving/telemetry.py``.  No third-party dependencies.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Union

# ---------------------------------------------------------------------------
# Prometheus text exposition format (version 0.0.4)
# ---------------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def _fmt_labels(labels: Dict[str, str], extra: Dict[str, str] = None) -> str:
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(items.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if isinstance(v, float) and math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus(snapshot: Dict[str, Any]) -> str:
    """Render a ``MetricsRegistry.snapshot()`` as Prometheus text."""
    lines: List[str] = []
    for name, m in snapshot.get("counters", {}).items():
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} counter")
        for s in m["series"]:
            lines.append(f"{name}{_fmt_labels(s['labels'])} "
                         f"{_fmt_value(s['value'])}")
    for name, m in snapshot.get("gauges", {}).items():
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} gauge")
        for s in m["series"]:
            lines.append(f"{name}{_fmt_labels(s['labels'])} "
                         f"{_fmt_value(s['value'])}")
    for name, m in snapshot.get("histograms", {}).items():
        if m.get("help"):
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} histogram")
        bounds = list(m["buckets"]) + [math.inf]
        for s in m["series"]:
            cum = 0
            for ub, c in zip(bounds, s["counts"]):
                cum += c
                le = "+Inf" if math.isinf(ub) else _fmt_value(ub)
                lines.append(
                    f"{name}_bucket{_fmt_labels(s['labels'], {'le': le})} "
                    f"{cum}")
            lines.append(f"{name}_sum{_fmt_labels(s['labels'])} "
                         f"{_fmt_value(s['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(s['labels'])} "
                         f"{s['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Minimal Prometheus text parser (for selftests and claim checks).

    Returns ``{"types": {name: type}, "samples": [(name, labels, value)]}``
    and raises ``ValueError`` on lines that are not valid exposition
    format.
    """
    types: Dict[str, str] = {}
    samples: List[tuple] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    raise ValueError(f"line {lineno}: bad TYPE {parts[3]}")
                types[parts[2]] = parts[3]
            elif len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                pass
            else:
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            continue
        # sample: name{labels} value
        if "{" in line:
            name, rest = line.split("{", 1)
            lab_str, val_str = rest.rsplit("}", 1)
            labels = {}
            for item in _split_labels(lab_str):
                if not item:
                    continue
                k, v = item.split("=", 1)
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"line {lineno}: unquoted label {item!r}")
                labels[k.strip()] = (v[1:-1].replace('\\"', '"')
                                     .replace("\\n", "\n")
                                     .replace("\\\\", "\\"))
        else:
            parts = line.split()
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: bad sample {line!r}")
            name, val_str, labels = parts[0], parts[1], {}
        name = name.strip()
        val_str = val_str.strip().split()[0]
        if val_str == "+Inf":
            value = math.inf
        elif val_str == "-Inf":
            value = -math.inf
        else:
            value = float(val_str)
        if not name or not all(c.isalnum() or c in "_:" for c in name):
            raise ValueError(f"line {lineno}: bad metric name {name!r}")
        samples.append((name, labels, value))
    return {"types": types, "samples": samples}


def _split_labels(s: str) -> List[str]:
    out, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
        elif ch == "\\":
            cur.append(ch)
            esc = True
        elif ch == '"':
            cur.append(ch)
            in_q = not in_q
        elif ch == "," and not in_q:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


# ---------------------------------------------------------------------------
# Chrome trace (chrome://tracing / Perfetto "trace event" JSON)
# ---------------------------------------------------------------------------

def to_chrome_trace(spans: Iterable[Dict[str, Any]],
                    pid: int = 0) -> Dict[str, Any]:
    """Render telemetry spans as a Chrome trace-event JSON object.

    Span times are perf_counter seconds; Chrome wants microseconds.
    Every span becomes one complete ("ph": "X") event on pid/tid 0 with
    the step number and any args attached.
    """
    events = []
    for sp in spans:
        args = dict(sp.get("args") or {})
        if sp.get("step", -1) >= 0:
            args["step"] = sp["step"]
        if sp.get("error"):
            args["error"] = True
        events.append({
            "name": sp["name"], "cat": "engine", "ph": "X",
            "ts": sp["t0"] * 1e6,
            "dur": max(0.0, (sp["t1"] - sp["t0"]) * 1e6),
            "pid": pid, "tid": 0, "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def from_chrome_trace(obj: Union[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Load + validate a Chrome trace; returns the span-like event list.

    Accepts the JSON text or the already-decoded object and raises
    ``ValueError`` if required trace-event keys are missing.
    """
    if isinstance(obj, (str, bytes)):
        obj = json.loads(obj)
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing traceEvents")
    out = []
    for i, ev in enumerate(obj["traceEvents"]):
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"traceEvents[{i}]: missing {key!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"traceEvents[{i}]: complete event missing dur")
        out.append(ev)
    return out


# ---------------------------------------------------------------------------
# JSONL event logs (request lifecycle events, one JSON object per line)
# ---------------------------------------------------------------------------

def events_jsonl(events: Iterable[Dict[str, Any]]) -> str:
    """Serialize lifecycle events as JSONL, globally ordered by time."""
    evs = sorted(events, key=lambda e: e.get("t", 0.0))
    return "\n".join(json.dumps(e, sort_keys=True) for e in evs) + (
        "\n" if evs else "")


def read_jsonl(text: str) -> List[Dict[str, Any]]:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out
