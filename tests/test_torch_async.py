"""The port's asyncio front door (``serving.async_api.AsyncLLM``) and its
HTTP server (``launch.serve_http``), on the CPU.

In the shape of the reference's ``tests/test_slo_serving.py::test_async_*``,
``tests/test_faults.py::test_async_*`` and
``tests/test_telemetry.py::test_async_metrics_and_timeline_accessors``, on
the reduced fp32 chai-llama-7b of those tests (2 layers, d 32, vocab 64,
warmup 3) with weights from a seed. The synchronous ``LLM`` the async
streams are held against is held against the reference's own ``LLM`` in
``tests/test_torch_api.py``.

* 32 concurrent streams on one engine, 8 aborted after their first chunk:
  the survivors' tokens equal the synchronous ``LLM``'s, the aborted
  streams end in an empty ``"aborted"`` chunk, every page comes back.
* An abandoned stream (``aclose()``) frees its slot and pages.
* Supervision: a request that can never fit fails its own stream with
  ``CapacityError``; transient step failures are retried; exhausted
  retries broadcast ``EngineFault``; a ``MemoryError`` with no queue head
  is an ``EngineFault``; a quarantine reaches its stream as a typed
  terminal chunk; priority preemption under the async driver.
* Telemetry accessors, and the worker thread that runs every core call.
* The HTTP server's ``selftest`` on the reduced demo model, on ports the
  OS picks.
"""
import asyncio
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import serve_http
from repro_torch.models.transformer import init_params
from repro_torch.serving import LLM, EngineConfig, SamplingParams
from repro_torch.serving import exporters
from repro_torch.serving.async_api import AsyncLLM
from repro_torch.serving.faults import (CapacityError, EngineFault,
                                        FaultInjector, FaultSpec)
from repro_torch.serving.sampling import FINISH_ABORT, FINISH_ERROR

_model = {}


def _cfg_params():
    if not _model:
        cfg = reduced(get_config("chai-llama-7b"), n_layers=2, d_model=32,
                      d_ff=64, vocab=64).with_chai(enabled=True,
                                                   warmup_tokens=3)
        _model["m"] = (cfg, init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
    return _model["m"]


def _pool_counters(core):
    out = {"dense": core.dense_pool.counters()}
    if core.chai_pool is not None:
        out["chai"] = core.chai_pool.counters()
    return out


def _prompts(n, length=(6, 14), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 64, size=int(rng.integers(*length))).tolist()
            for _ in range(n)]


def _async(cfg, params, **kw):
    ecfg = kw.pop("ecfg", None) or EngineConfig(**{
        "batch_slots": 2, "max_seq": 64, "page_size": 8,
        "audit_level": "deep", **kw.pop("ecfg_kw", {})})
    return AsyncLLM(cfg, params, ecfg, device="cpu", **kw)


# ---------------------------------------------- streams, aborts, slots ---
def test_async_concurrent_streams_with_aborts():
    """32 concurrent ``stream()`` coroutines share one continuous batch; 8
    abort after their first chunk. The survivors equal the synchronous
    ``LLM``'s tokens; an aborted stream ends in an empty ``"aborted"``
    chunk (the driver runs ahead of the consumers, so earlier chunks may
    carry tokens), and every page comes back."""
    cfg, params = _cfg_params()
    sp = SamplingParams(max_new_tokens=8)
    kw = dict(batch_slots=4, max_seq=128, page_size=16)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, size=8) for _ in range(32)]
    sync = LLM(cfg, params, EngineConfig(**kw), device="cpu")
    want = [o.token_ids for o in sync.generate(prompts, sp)]

    async def _stream(llm, i):
        abort_me = i % 4 == 3
        chunks = []
        async for c in llm.stream(prompts[i], sp):
            chunks.append(c)
            if abort_me and len(chunks) == 1:
                assert await llm.abort(c.uid)
        toks = [t for c in chunks for t in c.token_ids]
        assert chunks[-1].finished
        if abort_me:
            assert chunks[-1].finish_reason == FINISH_ABORT
            assert not chunks[-1].token_ids
            assert len(toks) < sp.max_new_tokens
        else:
            assert toks == want[i], (i, toks, want[i])
        return toks

    async def main():
        async with AsyncLLM(cfg, params, EngineConfig(**kw),
                            device="cpu") as llm:
            base = _pool_counters(llm.core)
            await asyncio.gather(*[_stream(llm, i)
                                   for i in range(len(prompts))])
            assert not llm.core.has_work()
            assert _pool_counters(llm.core) == base

    asyncio.run(main())


def test_async_abandoned_stream_releases_slot():
    """Leaving a stream (closing the generator) aborts its request: a
    dropped connection never pins a slot or its pages, and the engine
    serves fresh work after it."""
    cfg, params = _cfg_params()
    sp = SamplingParams(max_new_tokens=8)
    prompt = np.random.default_rng(1).integers(0, 64, size=8)

    async def main():
        async with AsyncLLM(cfg, params, EngineConfig(
                batch_slots=2, max_seq=128, page_size=16),
                device="cpu") as llm:
            base = _pool_counters(llm.core)
            it = llm.stream(prompt, sp)
            first = await it.__anext__()
            assert not first.finished
            await it.aclose()
            for _ in range(50):
                if not llm.core.has_work():
                    break
                await asyncio.sleep(0.01)
            assert not llm.core.has_work()
            assert _pool_counters(llm.core) == base
            out = await llm.generate(prompt, sp)
            assert len(out.token_ids) == sp.max_new_tokens

    asyncio.run(main())


def test_async_priority_preempts_and_resumes():
    """Priority preemption under the async driver: a priority-5 stream
    arriving on a one-request page budget evicts the running stream,
    whose chunks then continue with its uninterrupted tokens; the
    resumption emits no duplicate chunk."""
    cfg, params = _cfg_params()
    kw = dict(batch_slots=2, max_seq=128, page_size=16, num_pages=10,
              num_chai_pages=10)
    sp = SamplingParams(max_new_tokens=12)
    rng = np.random.default_rng(0)
    p_low, p_high = (rng.integers(0, 64, size=40) for _ in range(2))
    sync = LLM(cfg, params, EngineConfig(**kw), device="cpu")
    want_low = sync.generate(p_low, sp)[0].token_ids
    want_high = sync.generate(p_high, sp)[0].token_ids

    async def main():
        async with AsyncLLM(cfg, params, EngineConfig(**kw),
                            device="cpu") as llm:
            low_chunks = []
            high = None
            async for c in llm.stream(p_low, sp):
                low_chunks.append(c)
                if len(low_chunks) == 5:
                    high = asyncio.ensure_future(
                        llm.generate(p_high, sp, priority=5))
            out = await high
            return low_chunks, out, llm.core.preemptions

    chunks, high_out, preemptions = asyncio.run(main())
    assert preemptions == 1
    assert [t for c in chunks for t in c.token_ids] == want_low
    assert high_out.token_ids == want_high


# ----------------------------------------------------------- supervision ---
def test_async_capacity_fault_fails_only_its_stream():
    """A request that can NEVER fit fails its own stream with
    ``CapacityError`` (a ``MemoryError``); a concurrent small request
    completes."""
    cfg, params = _cfg_params()
    rng = np.random.default_rng(11)
    big = rng.integers(1, 64, size=40).tolist()
    small = rng.integers(1, 64, size=6).tolist()

    async def main():
        async with _async(cfg, params, ecfg_kw=dict(
                num_pages=8, num_chai_pages=16)) as llm:
            async def run(p, n):
                try:
                    return await llm.generate(p, max_new_tokens=n)
                except MemoryError as err:
                    return err
            return await asyncio.gather(run(big, 8), run(small, 4))

    r_big, r_small = asyncio.run(main())
    assert isinstance(r_big, CapacityError)
    assert r_small.finish_reason == "length" and len(r_small.token_ids) == 4


def test_async_supervised_restart_recovers_from_transient_faults():
    """Untyped ``step()`` failures are retried with backoff; the stream
    lives on and the request completes."""
    cfg, params = _cfg_params()
    prompt = _prompts(1, seed=12)[0]

    async def main():
        async with _async(cfg, params, restart_backoff=0.001) as llm:
            real = llm.core.step
            calls = {"n": 0}

            def flaky():
                calls["n"] += 1
                if calls["n"] <= 2:
                    raise RuntimeError("transient executor glitch")
                return real()

            llm.core.step = flaky
            out = await llm.generate(prompt, max_new_tokens=5)
            return out, calls["n"], llm.restarts

    out, n_calls, restarts = asyncio.run(main())
    assert out.finish_reason == "length" and len(out.token_ids) == 5
    assert n_calls >= 3 and restarts == 2


def test_async_exhausted_retries_broadcast_engine_fault():
    cfg, params = _cfg_params()
    prompt = _prompts(1, seed=13)[0]

    async def main():
        llm = _async(cfg, params, max_restarts=1, restart_backoff=0.001)
        try:
            def dead():
                raise RuntimeError("persistent engine failure")
            llm.core.step = dead
            with pytest.raises(EngineFault, match="exhausted"):
                await llm.generate(prompt, max_new_tokens=4)
            assert llm.restarts == 2        # 1 retry + the fatal attempt
            with pytest.raises(RuntimeError, match="driver died"):
                await llm.generate(prompt, max_new_tokens=4)
        finally:
            await llm.close()

    asyncio.run(main())


def test_async_unattributable_memoryerror_is_engine_fault():
    """A bare ``MemoryError`` with NO queue head cannot be pinned on a
    request: it escalates to an ``EngineFault`` broadcast."""
    cfg, params = _cfg_params()
    prompt = _prompts(1, seed=14)[0]

    async def main():
        llm = _async(cfg, params)
        try:
            real = llm.core.step
            state = {"fired": False}

            def spurious():
                if (not state["fired"] and not llm.core.queue
                        and llm.core.has_active):
                    state["fired"] = True
                    raise MemoryError("spurious allocator failure")
                return real()

            llm.core.step = spurious
            with pytest.raises(EngineFault, match="no queue head"):
                await llm.generate(prompt, max_new_tokens=6)
            assert state["fired"]
        finally:
            await llm.close()

    asyncio.run(main())


def test_async_quarantine_stream_gets_typed_terminal_output():
    """An in-flight quarantine (NaN logits) is no driver failure: its
    stream gets a terminal ``finish_reason="error"`` chunk and the other
    stream completes."""
    cfg, params = _cfg_params()
    prompts = _prompts(2, seed=15)
    inj = FaultInjector([FaultSpec("step.logits", mode="nan", uid=0)],
                        seed=0)

    async def main():
        async with _async(cfg, params, faults=inj) as llm:
            outs = await asyncio.gather(
                llm.generate(prompts[0], max_new_tokens=6),
                llm.generate(prompts[1], max_new_tokens=6))
            return outs, llm.core.fault_stats()

    (o0, o1), fs = asyncio.run(main())
    assert o0.finish_reason == FINISH_ERROR
    assert o1.finish_reason == "length" and len(o1.token_ids) == 6
    assert fs["quarantined"] == 1


# ------------------------------------------------ telemetry, the worker ---
def test_async_metrics_and_timeline_accessors():
    cfg, params = _cfg_params()
    prompt = np.random.default_rng(3).integers(1, 64, size=8).tolist()
    sp = SamplingParams(max_new_tokens=8)

    async def main():
        async with _async(cfg, params,
                          ecfg_kw=dict(telemetry="trace")) as llm:
            out = await llm.generate(prompt, sp)
            assert len(out.token_ids) == 8
            parsed = exporters.parse_prometheus(await llm.metrics_text())
            names = {s[0] for s in parsed["samples"]}
            assert {"requests_finished_total", "driver_restarts",
                    "tokens_generated_total"} <= names
            snap = await llm.metrics()
            assert snap["gauges"]["driver_restarts"]["series"][0][
                "value"] == 0
            tl = await llm.timeline(out.uid)
            assert tl["summary"]["n_tokens"] == 8
            assert await llm.timeline(10**9) is None
            trace = await llm.step_trace()
            assert any(e["name"] == "decode.dispatch"
                       for e in trace["traceEvents"])
            ts = await llm.tier_stats()
            assert ts is not None and "transitions" in ts
        async with _async(cfg, params) as llm_off:
            await llm_off.generate(prompt, sp)
            assert await llm_off.metrics() is None
            assert await llm_off.metrics_text() is None

    asyncio.run(main())


def test_every_core_call_runs_on_the_one_worker_thread():
    """Submission, steps, aborts and reaps all run on the executor's one
    worker thread, never on the event loop's."""
    cfg, params = _cfg_params()
    seen = set()

    async def main():
        async with _async(cfg, params) as llm:
            for name in ("step", "add_request", "abort", "reap_done"):
                fn = getattr(llm.core, name)

                def wrapped(*a, _fn=fn, **kw):
                    seen.add(threading.current_thread().name)
                    return _fn(*a, **kw)
                setattr(llm.core, name, wrapped)
            it = llm.stream(_prompts(1, seed=16)[0],
                            SamplingParams(max_new_tokens=6))
            await it.__anext__()
            await it.aclose()
            await llm.generate(_prompts(1, seed=17)[0],
                               SamplingParams(max_new_tokens=3))
        return threading.current_thread().name

    loop_thread = asyncio.run(main())
    assert len(seen) == 1 and loop_thread not in seen
    assert next(iter(seen)).startswith("engine")


# ------------------------------------------------------------------ HTTP ---
def test_serve_http_selftest_reduced():
    """The HTTP server's scripted client on the reduced demo model (ports
    the OS picks): 200 with SSE equal to the plain response, a priority-1
    request beside another, 400 / 408 / 429 / 500 / 503, the metrics and
    timeline routes and their 404 at telemetry "off"."""
    llm = serve_http.build_llm(reduced_model=True, device="cpu")
    seen = asyncio.run(serve_http.selftest(llm))
    assert len(seen["tokens"]) == 8
    assert 0 <= seen["timeout_tokens"] < 100
    assert seen["stats"]["steps"] > 0 and seen["metric_samples"] > 0
    assert llm._closed


def test_serve_http_main_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_http.main(["--reduced", "--selftest"])
