"""Asyncio front door over the step-driven ``EngineCore``.

``AsyncLLM`` owns one core and ONE background driver task that loops
``EngineCore.step()``; each step's ``StepOutput``s fan out to per-request
``asyncio.Queue``s, so any number of concurrent ``generate()`` /
``stream()`` coroutines share the same continuous batch. The engine is not
thread-safe and a step blocks its caller, so every core call (submit,
step, abort, reap) runs on a single-worker executor thread: engine access
is serialized as in the synchronous front door, while the event loop stays
responsive between steps (an HTTP server keeps accepting connections
during a long prefill).

The worker thread runs on the engine's device and on the CUDA stream that
was current where the ``AsyncLLM`` was built, the stream the engine's
state was written on (the executor's initializer sets both: PyTorch keeps
the current device and stream per thread), so a host wait inside a step
orders against every earlier write.

Lifecycle of a request:

* ``stream()``/``generate()`` pick a uid and register the fan-out queue
  BEFORE the request reaches the engine, so the admission chunk (which
  carries the first token) can never be dropped.
* The driver pushes every ``StepOutput`` for that uid; the terminal chunk
  has ``finished=True``.
* ``abort(uid)`` cancels the request on the engine (pages return
  refcount-exactly) and pushes the empty terminal chunk itself: the
  engine's abort emits no StepOutput of its own.

The driver is SUPERVISED (the failure taxonomy of ``serving.faults``):

* A ``RequestError`` from ``step()`` goes to the named request's queue (or
  the queue head's, for a bare ``MemoryError``) and is raised from that
  coroutine; the driver and every other request keep running. Engine-side
  quarantines never raise: they arrive as ordinary terminal chunks with
  ``finish_reason="error"``.
* Any other ``Exception`` from ``step()`` is retried with bounded
  exponential backoff (``max_restarts``); only when the retries run out is
  it escalated to an ``EngineFault``.
* An ``EngineFault`` (an invariant breach, exhausted retries, a
  ``MemoryError`` with no queue head to blame) is broadcast to ALL open
  queues and ends the driver: the engine state itself is suspect.

``AsyncLLM`` assumes it is the only front door driving its core (it picks
the uids; direct ``core.add_request`` calls beside it may collide).
"""
from __future__ import annotations

import asyncio
import concurrent.futures
import time
from typing import AsyncIterator, Callable, Optional

import torch

from repro_torch.serving.api import RequestOutput
from repro_torch.serving.engine import (EngineConfig, EngineCore, Request,
                                        StepOutput)
from repro_torch.serving.faults import (EngineFault, FaultInjector,
                                        RequestError)
from repro_torch.serving.sampling import FINISH_ABORT, SamplingParams


class AsyncLLM:
    """Asyncio front door owning one ``EngineCore`` (mirrors ``LLM``).

    ``device``: where the core runs (``None`` = CUDA; ``params`` must live
    there). Use as an async context manager, or call ``close()``::

        async with AsyncLLM(cfg, params, ecfg) as llm:
            out = await llm.generate(prompt, SamplingParams())
            async for chunk in llm.stream(prompt):
                ...
    """

    def __init__(self, cfg, params, ecfg: Optional[EngineConfig] = None, *,
                 detokenizer: Optional[Callable] = None,
                 faults: Optional[FaultInjector] = None, device=None,
                 max_restarts: int = 3, restart_backoff: float = 0.05,
                 **ecfg_kw):
        if ecfg is None:
            ecfg = EngineConfig(**ecfg_kw)
        elif ecfg_kw:
            raise ValueError(f"pass ecfg OR EngineConfig kwargs, not both "
                             f"({sorted(ecfg_kw)})")
        if ecfg.scheduler != "continuous":
            raise ValueError("AsyncLLM drives EngineCore.step(): "
                             "continuous scheduler only")
        self.core = EngineCore(cfg, params, ecfg, detokenizer=detokenizer,
                               faults=faults, device=device)
        self._max_restarts = int(max_restarts)
        self._restart_backoff = float(restart_backoff)
        self.restarts = 0                 # cumulative supervised retries
        self.detokenizer = detokenizer
        dev = self.core.device
        stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                  else None)

        def bind():
            if stream is not None:
                torch.cuda.set_device(dev)
                torch.cuda.set_stream(stream)

        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine", initializer=bind)
        self._queues: dict = {}           # uid -> asyncio.Queue
        self._uid = 0
        self._driver: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._error: Optional[BaseException] = None
        self._closed = False

    # -- engine access (single-worker executor = serialized) ---------------
    async def _call(self, fn, *args, **kw):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._exec,
                                          lambda: fn(*args, **kw))

    # -- driver ------------------------------------------------------------
    def _ensure_driver(self):
        if self._error is not None:
            raise RuntimeError("AsyncLLM driver died") from self._error
        if self._closed:
            raise RuntimeError("AsyncLLM is closed")
        if self._wake is None:
            self._wake = asyncio.Event()
        if self._driver is None or self._driver.done():
            self._driver = asyncio.get_running_loop().create_task(
                self._drive_forever(), name="asyncllm-driver")

    def _step_once(self):
        """On the executor thread: one engine step and the scheduler facts
        the driver needs, read while no other engine call can
        interleave."""
        outs = self.core.step()
        return outs, self.core.has_active, self.core.next_arrival()

    async def _drive_forever(self):
        retries = 0
        try:
            while True:
                self._wake.clear()
                try:
                    outs, active, arrival = await self._call(
                        self._step_once)
                    retries = 0
                except EngineFault:
                    raise          # engine state suspect: broadcast, end
                except RequestError as err:
                    # Request-isolatable: fail THAT request, keep serving.
                    if err.uid is not None:
                        await self._fail_uid(err.uid, err)
                    elif isinstance(err, MemoryError):
                        await self._fail_head(err)
                    else:
                        raise EngineFault(
                            "request-isolatable failure named no "
                            f"request: {err!r}") from err
                    continue
                except MemoryError as err:    # a bare page-budget failure
                    await self._fail_head(err)
                    continue
                except Exception as err:      # noqa: BLE001: supervised
                    retries += 1
                    self.restarts += 1
                    if retries > self._max_restarts:
                        raise EngineFault(
                            f"driver exhausted {self._max_restarts} step "
                            f"retries; last failure: {err!r}") from err
                    await asyncio.sleep(
                        self._restart_backoff * (1 << (retries - 1)))
                    continue
                for out in outs:
                    q = self._queues.get(out.uid)
                    if q is None:
                        continue
                    q.put_nowait(out)
                    if out.finished:
                        del self._queues[out.uid]
                if outs or active:
                    await asyncio.sleep(0)      # yield to the consumers
                    continue
                # Idle: wait for the next open-loop arrival or a new
                # submission, whichever comes first (every submission sets
                # the wake event AFTER its add_request lands, and it was
                # cleared BEFORE the step, so a submission racing this
                # check still wakes the driver).
                timeout = (max(1e-4, arrival - time.time())
                           if arrival is not None else None)
                try:
                    await asyncio.wait_for(self._wake.wait(),
                                           timeout=timeout)
                except asyncio.TimeoutError:
                    pass
        except asyncio.CancelledError:
            raise
        except BaseException as err:  # noqa: BLE001: broadcast, re-raise
            self._error = err
            for q in self._queues.values():
                q.put_nowait(err)
            self._queues.clear()
            raise

    async def _fail_uid(self, uid, err: BaseException):
        """Typed-fail ONE request: abort it on the engine and deliver the
        error to its stream; the driver and every other request keep
        running."""
        def _abort():
            self.core.abort(uid)
            self.core.reap_done()

        await self._call(_abort)
        q = self._queues.pop(uid, None)
        if q is not None:
            q.put_nowait(err)

    async def _fail_head(self, err: MemoryError):
        """``step()`` proved the queue head can never fit: fail THAT
        request and keep serving the rest. A ``MemoryError`` with NO queue
        head cannot be pinned on a request: the allocator state itself is
        suspect, so it escalates to an ``EngineFault`` (broadcast by the
        driver)."""
        def _head_uid():
            return self.core.queue[0].uid if self.core.queue else None

        uid = await self._call(_head_uid)
        if uid is None:
            raise EngineFault(
                "step() raised MemoryError with no queue head to attribute "
                f"it to; the allocator state is suspect: {err}") from err
        await self._fail_uid(uid, err)

    # -- submission --------------------------------------------------------
    async def _submit(self, prompt, params, max_new_tokens, priority):
        self._ensure_driver()
        self._uid = max(self._uid, self.core._uid_counter)
        uid, self._uid = self._uid, self._uid + 1
        q: asyncio.Queue = asyncio.Queue()
        self._queues[uid] = q             # registered BEFORE the engine
        try:                              # sees the request
            req = await self._call(
                self.core.add_request, prompt, params, uid=uid,
                max_new_tokens=max_new_tokens, priority=priority)
        except BaseException:
            self._queues.pop(uid, None)
            raise
        self._wake.set()
        return req, q

    async def _drain(self, req: Request,
                     q: asyncio.Queue) -> AsyncIterator[StepOutput]:
        try:
            while True:
                item = await q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
                if item.finished:
                    await self._call(self.core.reap_done)
                    return
        finally:
            if (not req.finished and self._error is None
                    and not self._closed):
                await self.abort(req.uid)

    # -- public API --------------------------------------------------------
    async def generate(self, prompt,
                       params: Optional[SamplingParams] = None, *,
                       max_new_tokens: Optional[int] = None,
                       priority: int = 0) -> RequestOutput:
        """Submit ONE prompt and await its completion (concurrency comes
        from ``asyncio.gather`` over many calls: they share the batch)."""
        req, q = await self._submit(prompt, params, max_new_tokens,
                                    priority)
        async for _ in self._drain(req, q):
            pass
        return self._output_of(req)

    def stream(self, prompt, params: Optional[SamplingParams] = None, *,
               max_new_tokens: Optional[int] = None,
               priority: int = 0) -> AsyncIterator[StepOutput]:
        """Submit ONE prompt and yield its ``StepOutput`` chunks as the
        driver produces them; the final chunk has ``finished=True`` (an
        out-of-band ``abort()`` delivers an empty terminal chunk).
        Abandoning the iterator (``break`` / ``aclose()``) aborts the
        request: a dropped stream never pins a slot or its pages."""
        async def _gen():
            req, q = await self._submit(prompt, params, max_new_tokens,
                                        priority)
            drain = self._drain(req, q)
            try:
                async for chunk in drain:
                    yield chunk
            finally:
                # ``async for`` does not close its iterator on an early
                # exit; without this, an abandoned stream's abort (in
                # _drain's finally) would wait for the event loop's
                # async-generator finalizer instead of running inside
                # ``aclose()``.
                await drain.aclose()

        return _gen()

    async def abort(self, uid) -> bool:
        """Cancel a queued or running request; its open stream (if any)
        receives an empty terminal chunk with ``finish_reason="aborted"``.
        False for unknown or finished uids."""
        ok = await self._call(self.core.abort, uid)
        await self._call(self.core.reap_done)
        q = self._queues.pop(uid, None)
        if q is not None:
            q.put_nowait(StepOutput(uid, [], True, FINISH_ABORT))
        return ok

    # -- telemetry ---------------------------------------------------------
    def _restarts_gauge(self):
        if self.core.tel.enabled:
            self.core.tel.gauge(
                "driver_restarts", self.restarts,
                help="Supervised step() retries by the async driver")

    async def metrics(self):
        """The engine's metrics snapshot with the driver-restart gauge
        folded in; None at ``EngineConfig.telemetry == "off"``. Serialized
        through the engine's executor like every core call."""
        def _snap():
            self._restarts_gauge()
            return self.core.metrics()

        return await self._call(_snap)

    async def metrics_text(self):
        """Prometheus text exposition (None at telemetry "off")."""
        def _text():
            self._restarts_gauge()
            return self.core.metrics_text()

        return await self._call(_text)

    async def timeline(self, uid):
        """One request's lifecycle timeline (None when unknown or at
        telemetry "off")."""
        return await self._call(self.core.request_timeline, uid)

    async def step_trace(self):
        """Chrome-trace JSON object of the recorded step spans."""
        return await self._call(self.core.step_trace)

    async def tier_stats(self):
        """KV-tier counters (residency per tier, transition totals,
        prefetch hits and misses); None on an engine without tiers."""
        return await self._call(self.core.tier_stats)

    def _output_of(self, req: Request) -> RequestOutput:
        text = (self.detokenizer(list(req.generated))
                if self.detokenizer is not None else "")
        return RequestOutput(
            uid=req.uid, prompt_token_ids=list(map(int, req.prompt)),
            token_ids=list(req.generated), finish_reason=req.finish_reason,
            text=text, cached_tokens=req.cached_tokens,
            prefill_tokens=max(req.prefill_tokens, 0), request=req)

    # -- lifecycle ---------------------------------------------------------
    async def close(self):
        """Cancel the driver, abort the requests in flight and shut the
        executor down. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._driver is not None and not self._driver.done():
            self._driver.cancel()
            try:
                await self._driver
            except (asyncio.CancelledError, Exception):
                pass
        for uid, q in list(self._queues.items()):
            await self._call(self.core.abort, uid)
            q.put_nowait(StepOutput(uid, [], True, FINISH_ABORT))
        self._queues.clear()
        await self._call(self.core.reap_done)
        self._exec.shutdown(wait=True)

    async def __aenter__(self) -> "AsyncLLM":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()
