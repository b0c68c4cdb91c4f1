"""OpenAI-style HTTP completions server over ``AsyncLLM``, stdlib only.

``python -m repro_torch.launch.serve_http [--reduced] [--device cuda]
[--host 127.0.0.1] [--port 8080] [--selftest]``

POST /v1/completions with a JSON body::

    {"prompt": [3, 14, 15, 9], "max_tokens": 16, "temperature": 0.0,
     "stream": false, "priority": 0, "timeout_s": 0}

``prompt`` is a list of token ids (the repo ships no tokenizer; the demo
detokenizer renders ids as space-joined integers). A non-streaming request
gets one JSON object; ``"stream": true`` gets Server-Sent Events
(``data: {...}\\n\\n`` a chunk, ``data: [DONE]`` at the end), each chunk
carrying the tokens that step produced. GET /v1/stats returns engine
counters (steps, preemptions, pool occupancy).

Observability routes (live when ``EngineConfig.telemetry`` != "off", 404
otherwise):

* ``GET /v1/metrics``: the Prometheus text exposition (format 0.0.4) of
  the engine's metrics registry, the driver's restarts folded in.
* ``GET /v1/requests/<uid>/timeline``: one request's lifecycle timeline as
  JSON; completion responses carry the ``uid`` to query.

The typed failures of ``serving.faults`` map onto HTTP status codes:

=====  =====================================================
400    ``ValidationError`` or a malformed body: the request
       itself is wrong (never admitted, nothing to clean up)
408    the request's wall-clock ``timeout_s`` expired: it is
       ABORTED engine-side (pages returned) and its partial
       tokens come back with ``finish_reason="timeout"``
429    ``CapacityError``: the request can never fit the page
       pools; retry smaller or elsewhere
500    a quarantine (a ``finish_reason="error"`` terminal
       chunk or a raised ``QuarantineError``): ONE request
       failed mid-flight; the batch keeps serving
503    ``EngineFault`` or a dead driver: the engine itself is
       suspect; every stream gets this until a restart
=====  =====================================================

Every connection shares ONE continuous batch (the server rides
``AsyncLLM``): concurrent requests are scheduled together by the engine
(chunked prefill bounds the stalls of a long prompt; ``priority`` classes
preempt under page pressure).

Full-width chai-llama-7b by default (random weights from a seed, bf16; a
GPU with ~20 GB free); ``--reduced`` serves the reference demo's shapes (2
layers, d_model 64, d_ff 128, vocab 256, warmup 8). ``--selftest`` starts
the server in-process on a port the OS picks, runs a scripted client
against it and exits.
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as tfm
from repro_torch.serving import exporters
from repro_torch.serving.async_api import AsyncLLM
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.faults import (CapacityError, EngineFault,
                                        FaultInjector, FaultSpec,
                                        RequestError, ValidationError)
from repro_torch.serving.sampling import FINISH_ERROR, SamplingParams

ARCH = "chai-llama-7b"
LOOPBACK = "127.0.0.1"


def detok(ids) -> str:
    return " ".join(map(str, ids))


def demo_ecfg(telemetry: str = "basic") -> EngineConfig:
    """The demo engine: ``num_pages`` deliberately below the automatic
    worst case, so an oversized (but max_seq-legal) request meets the
    page-budget ``CapacityError`` (429) instead of always fitting."""
    return EngineConfig(batch_slots=4, max_seq=256, page_size=16,
                        prefix_cache=True, prefill_chunk_tokens=32,
                        telemetry=telemetry,
                        num_pages=17)       # 16 usable: 128 tokens a request


def build_llm(*, reduced_model: bool = False, device=None, faults=None,
              telemetry: str = "basic") -> AsyncLLM:
    """A demo model (random weights from a seed) behind the whole serving
    stack: full-width chai-llama-7b, or the reference demo's reduced
    shapes."""
    device = resolve_device(device)
    cfg = get_config(ARCH)
    if reduced_model:
        cfg = reduced(cfg, n_layers=2, d_model=64, d_ff=128,
                      vocab=256).with_chai(enabled=True, warmup_tokens=8)
    else:
        cfg = cfg.with_chai(enabled=True)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    return AsyncLLM(cfg, params, demo_ecfg(telemetry), detokenizer=detok,
                    faults=faults, device=device)


def twin(llm: AsyncLLM, *, faults=None, telemetry: str = "off") -> AsyncLLM:
    """A second front door on the same model and weights (``llm``'s
    engine settings, another telemetry tier and fault plan)."""
    core = llm.core
    return AsyncLLM(core.cfg, core.params,
                    dataclasses.replace(core.ecfg, telemetry=telemetry),
                    detokenizer=core.detokenizer, faults=faults,
                    device=core.device)


def _code_of(err: BaseException) -> int:
    """Typed failure -> HTTP status (see the module docstring)."""
    if isinstance(err, CapacityError):
        return 429
    if isinstance(err, (ValidationError, ValueError, KeyError, TypeError)):
        return 400
    if isinstance(err, RequestError):
        return 500                          # quarantined mid-flight
    if isinstance(err, (EngineFault, RuntimeError)):
        return 503                          # the engine / driver is suspect
    return 500


def _params_of(body: dict) -> SamplingParams:
    return SamplingParams(
        max_new_tokens=int(body.get("max_tokens", 16)),
        temperature=float(body.get("temperature", 0.0)),
        top_k=int(body.get("top_k", 0)),
        top_p=float(body.get("top_p", 1.0)),
        seed=int(body.get("seed", 0)))


async def _read_request(reader) -> tuple:
    """A minimal HTTP/1.1 parse: (method, path, body bytes)."""
    line = await reader.readline()
    if not line:
        return None, None, b""
    method, path, _ = line.decode("latin1").split(" ", 2)
    length = 0
    while True:
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, val = h.decode("latin1").partition(":")
        if name.strip().lower() == "content-length":
            length = int(val.strip())
    body = await reader.readexactly(length) if length else b""
    return method, path, body


def _response(code: int, payload: bytes, ctype: str = "application/json"
              ) -> bytes:
    reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
              408: "Request Timeout", 429: "Too Many Requests",
              500: "Internal Server Error", 503: "Service Unavailable"}[code]
    return (f"HTTP/1.1 {code} {reason}\r\nContent-Type: {ctype}\r\n"
            f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
            ).encode("latin1") + payload


class Server:
    def __init__(self, llm: AsyncLLM):
        self.llm = llm

    async def handle(self, reader, writer):
        try:
            method, path, raw = await _read_request(reader)
            if method is None:
                return
            if method == "GET" and path == "/v1/stats":
                await self._stats(writer)
            elif method == "GET" and path == "/v1/metrics":
                await self._metrics(writer)
            elif (method == "GET" and path.startswith("/v1/requests/")
                    and path.endswith("/timeline")):
                await self._timeline(writer, path)
            elif method == "POST" and path == "/v1/completions":
                await self._completions(writer, raw)
            else:
                writer.write(_response(404, b'{"error": "not found"}'))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception as err:  # noqa: BLE001: report, keep serving
            msg = json.dumps({"error": str(err),
                              "type": type(err).__name__}).encode()
            with contextlib.suppress(Exception):
                writer.write(_response(_code_of(err), msg))
        finally:
            with contextlib.suppress(Exception):
                await writer.drain()
                writer.close()

    async def _stats(self, writer):
        core = self.llm.core
        stats = {"steps": core.steps_executed,
                 "preemptions": core.preemptions,
                 "cluster_transitions": core.cluster_transitions,
                 "dense_pages_in_use": core.dense_pool.pages_in_use,
                 "prefix_cache": core.prefix_stats()}
        writer.write(_response(200, json.dumps(stats).encode()))

    async def _metrics(self, writer):
        """Prometheus text; 404 at telemetry "off"."""
        text = await self.llm.metrics_text()
        if text is None:
            writer.write(_response(404, b'{"error": "telemetry is off"}'))
            return
        writer.write(_response(200, text.encode(),
                               ctype=exporters.PROMETHEUS_CONTENT_TYPE))

    async def _timeline(self, writer, path: str):
        """GET /v1/requests/<uid>/timeline -> lifecycle event JSON."""
        try:
            uid = int(path.split("/")[3])
        except (IndexError, ValueError):
            raise ValidationError(f"bad timeline path {path!r}")
        tl = await self.llm.timeline(uid)
        if tl is None:
            writer.write(_response(404, json.dumps(
                {"error": f"no timeline for uid {uid} (unknown uid or "
                          "telemetry off)"}).encode()))
            return
        writer.write(_response(200, json.dumps(tl).encode()))

    async def _completions(self, writer, raw: bytes):
        body = json.loads(raw or b"{}")
        if "prompt" not in body:
            raise ValidationError("body is missing 'prompt'")
        prompt = np.asarray(body["prompt"], np.int32)
        sp = _params_of(body)
        priority = int(body.get("priority", 0))
        timeout_s = float(body.get("timeout_s", 0) or 0)
        if body.get("stream"):
            head = ("HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                    "Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
            writer.write(head.encode("latin1"))
            await writer.drain()
            async for chunk in self.llm.stream(prompt, sp,
                                               priority=priority):
                data = {"uid": chunk.uid, "tokens": chunk.token_ids,
                        "finished": chunk.finished,
                        "finish_reason": chunk.finish_reason or None}
                writer.write(f"data: {json.dumps(data)}\n\n".encode())
                await writer.drain()
            writer.write(b"data: [DONE]\n\n")
            return
        tokens, finish, timed_out, uid = await self._collect(
            prompt, sp, priority, timeout_s)
        if timed_out:
            payload = {"uid": uid, "tokens": tokens,
                       "finish_reason": "timeout",
                       "error": f"request exceeded timeout_s={timeout_s}"}
            writer.write(_response(408, json.dumps(payload).encode()))
            return
        code = 500 if finish == FINISH_ERROR else 200
        payload = {"uid": uid, "tokens": tokens, "finish_reason": finish}
        if code == 200:
            payload["text"] = (self.llm.core.detokenizer(tokens)
                               if self.llm.core.detokenizer else "")
        writer.write(_response(code, json.dumps(payload).encode()))

    async def _collect(self, prompt, sp, priority, timeout_s):
        """Drain one request's stream under an optional wall-clock
        deadline. On expiry the stream is closed, which aborts the request
        ENGINE-side (its pages return refcount-exactly); the partial
        tokens still go to the client."""
        tokens, finish, uid = [], None, None
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        agen = self.llm.stream(prompt, sp, priority=priority)
        try:
            while True:
                if deadline is None:
                    chunk = await agen.__anext__()
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return tokens, finish, True, uid
                    try:
                        chunk = await asyncio.wait_for(agen.__anext__(),
                                                       left)
                    except asyncio.TimeoutError:
                        return tokens, finish, True, uid
                uid = chunk.uid
                tokens.extend(chunk.token_ids)
                finish = chunk.finish_reason
                if chunk.finished:
                    return tokens, finish, False, uid
        except StopAsyncIteration:          # defensive: the stream drained
            return tokens, finish, False, uid
        finally:
            await agen.aclose()             # a no-op once finished


async def serve(host: str = LOOPBACK, port: int = 8080, llm=None,
                ready=None, *, reduced_model: bool = False, device=None):
    """Serve until cancelled. ``llm``: the front door to serve (default:
    ``build_llm``); it is closed on exit. ``ready``: a future that gets
    the bound (host, port), so port 0 lets the OS pick one."""
    llm = llm or build_llm(reduced_model=reduced_model, device=device)
    async with llm:
        server = await asyncio.start_server(Server(llm).handle, host, port)
        addr = server.sockets[0].getsockname()
        print(f"serving on http://{addr[0]}:{addr[1]}  (POST "
              "/v1/completions, GET /v1/stats, /v1/metrics, "
              "/v1/requests/<uid>/timeline)", flush=True)
        if ready is not None:
            ready.set_result(addr)
        async with server:
            await server.serve_forever()


async def _exchange(port, request: bytes) -> tuple:
    reader, writer = await asyncio.open_connection(LOOPBACK, port)
    writer.write(request)
    await writer.drain()
    data = await reader.read()
    writer.close()
    head, _, tail = data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), head, tail


async def _get(port, path) -> tuple:
    """GET ``path``; returns (status code, content type, raw body)."""
    code, head, tail = await _exchange(
        port, f"GET {path} HTTP/1.1\r\nHost: {LOOPBACK}\r\n\r\n".encode())
    ctype = ""
    for ln in head.split(b"\r\n"):
        if ln.lower().startswith(b"content-type:"):
            ctype = ln.partition(b":")[2].strip().decode("latin1")
    return code, ctype, tail


async def _client(port, body) -> tuple:
    """POST /v1/completions; returns (status code, parsed body)."""
    payload = json.dumps(body).encode()
    code, head, tail = await _exchange(
        port, (f"POST /v1/completions HTTP/1.1\r\nHost: {LOOPBACK}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    if b"text/event-stream" in head:
        chunks = [json.loads(ln[6:]) for ln in tail.split(b"\n")
                  if ln.startswith(b"data: ") and b"[DONE]" not in ln]
        return code, {"stream": chunks}
    return code, json.loads(tail)


async def _start(loop, llm) -> tuple:
    """Serve ``llm`` on a loopback port the OS picks: (task, port)."""
    ready = loop.create_future()
    task = loop.create_task(serve(LOOPBACK, 0, llm=llm, ready=ready))
    _, port = await ready
    return task, port


async def _stop(task):
    task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await task


async def selftest(llm: AsyncLLM = None, *, reduced_model: bool = False,
                   device=None) -> dict:
    """Serve in-process on loopback ports the OS picks (parallel runs
    never collide) and drive a scripted client: greedy and SSE tokens
    equal, two concurrent requests (one at priority 1), the typed failures
    400 / 429 / 408, the observability routes, then a second front door on
    the same weights (telemetry off, a NaN fault armed) for 500, the 404
    of the routes at "off", and 503 once its engine is dead. ``llm``: the
    front door to test (default ``build_llm``); it is closed on return.
    Returns what was observed."""
    loop = asyncio.get_running_loop()
    llm = llm or build_llm(reduced_model=reduced_model, device=device)
    task, port = await _start(loop, llm)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, size=24).tolist()
    try:
        code, out = await _client(port, {"prompt": prompt, "max_tokens": 8})
        assert code == 200 and len(out["tokens"]) == 8, (code, out)
        code, srm = await _client(port, {"prompt": prompt, "max_tokens": 8,
                                         "stream": True})
        got = [t for c in srm["stream"] for t in c["tokens"]]
        assert code == 200 and got == out["tokens"], (got, out)
        both = await asyncio.gather(
            _client(port, {"prompt": prompt, "max_tokens": 8}),
            _client(port, {"prompt": rng.integers(0, 256, size=16).tolist(),
                           "max_tokens": 8, "priority": 1}))
        assert both[0][0] == 200 and both[0][1]["tokens"] == out["tokens"]
        assert both[1][0] == 200 and len(both[1][1]["tokens"]) == 8, both
        # -- typed failures -> HTTP codes -------------------------------
        code, body = await _client(port, {"max_tokens": 4})
        assert code == 400, (code, body)
        code, body = await _client(port, {"prompt": prompt,
                                          "max_tokens": 300})
        assert code == 400 and body["type"] == "ValidationError", body
        # legal in length but beyond the (deliberately small) pool
        code, body = await _client(
            port, {"prompt": rng.integers(0, 256, size=150).tolist(),
                   "max_tokens": 8})
        assert code == 429 and body["type"] == "CapacityError", (code, body)
        # the wall-clock timeout aborts engine-side, returns the partial
        code, body = await _client(port, {"prompt": prompt,
                                          "max_tokens": 100,
                                          "timeout_s": 0.15})
        assert code == 408 and body["finish_reason"] == "timeout", body
        assert len(body["tokens"]) < 100, body
        timeout_tokens = len(body["tokens"])
        # the engine kept serving through all of the above
        code, out2 = await _client(port, {"prompt": prompt, "max_tokens": 8})
        assert code == 200 and out2["tokens"] == out["tokens"], (code, out2)
        code, _, raw = await _get(port, "/v1/stats")
        stats = json.loads(raw)
        assert code == 200 and stats["steps"] > 0, (code, stats)
        # -- observability: /v1/metrics and the timelines ---------------
        code, ctype, raw = await _get(port, "/v1/metrics")
        assert code == 200, (code, raw)
        assert ctype == exporters.PROMETHEUS_CONTENT_TYPE, ctype
        parsed = exporters.parse_prometheus(raw.decode())
        names = {s[0] for s in parsed["samples"]}
        for want in ("requests_finished_total", "engine_steps_total",
                     "tokens_generated_total", "request_ttft_seconds_count",
                     "driver_restarts"):
            assert want in names, (want, sorted(names))
        finished = sum(v for n, _, v in parsed["samples"]
                       if n == "requests_finished_total")
        assert finished >= 6, parsed["samples"]
        code, _, raw = await _get(
            port, f"/v1/requests/{out2['uid']}/timeline")
        assert code == 200, (code, raw)
        tl = json.loads(raw)
        events = [e["ev"] for e in tl["events"]]
        assert "enqueue" in events and "finish" in events, events
        assert tl["summary"]["n_tokens"] == 8, tl["summary"]
        assert tl["summary"]["ttft_s"] is not None, tl["summary"]
        code, _, _ = await _get(port, "/v1/requests/999999/timeline")
        assert code == 404, code
    finally:
        await _stop(task)
    # -- quarantine (500) and a dead driver (503) on a faulted twin ------
    llm2 = twin(llm, faults=FaultInjector(
        [FaultSpec("step.logits", mode="nan", count=1)]))
    task2, port2 = await _start(loop, llm2)
    try:
        code, body = await _client(port2, {"prompt": prompt,
                                           "max_tokens": 8})
        assert code == 500 and body["finish_reason"] == "error", body
        code, _, raw = await _get(port2, "/v1/metrics")
        assert code == 404, (code, raw)     # telemetry off on this one
        code, _, raw = await _get(port2, "/v1/requests/0/timeline")
        assert code == 404, (code, raw)

        def dead_step():
            raise RuntimeError("injected persistent engine failure")

        llm2.core.step = dead_step
        code, body = await _client(port2, {"prompt": prompt,
                                           "max_tokens": 8})
        assert code == 503, (code, body)
        if llm2._driver is not None and llm2._driver.done():
            llm2._driver.exception()    # retrieved: no unhandled-task log
    finally:
        await _stop(task2)
    print(f"selftest OK (200 SSE / 400 / 408 / 429 / 500 / 503, "
          f"{len(parsed['samples'])} metric samples): {out['tokens']}",
          flush=True)
    return {"tokens": out["tokens"], "stats": stats,
            "metric_samples": len(parsed["samples"]),
            "timeout_tokens": timeout_tokens}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reduced", action="store_true",
                    help="serve the reference demo's reduced config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host", default=LOOPBACK)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--selftest", action="store_true",
                    help="serve in-process on a port the OS picks, run a "
                         "scripted client, exit")
    args = ap.parse_args(argv)
    if args.selftest:
        asyncio.run(selftest(reduced_model=args.reduced,
                             device=args.device))
        return 0
    with contextlib.suppress(KeyboardInterrupt):
        asyncio.run(serve(args.host, args.port, reduced_model=args.reduced,
                          device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
