"""User-facing serving API over the step-driven ``EngineCore``.

Three entry points, all driving the same core (and therefore the same
slots, page pools and prefix cache):

* ``LLM.generate(prompts, params)``: synchronous batch; submit every
  prompt, loop ``step()`` until all finish, return ``RequestOutput``s in
  submission order.
* ``LLM.stream(prompt, params)``: an iterator of ``StepOutput`` chunks,
  one per engine step that emitted tokens for the request (the first
  arrives at admission). Other in-flight requests keep decoding on the
  shared core while a stream is consumed.
* ``LLM.abort(uid)``: cancel a queued or running request; its pages
  return to the pools and an open stream for it ends.

``Session`` is multi-turn chat on top: each ``send()`` submits history +
new user tokens as one prompt, so with the engine's prefix cache on, turn
N+1 aliases the pages turn N left behind and prefills only the uncached
suffix.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serving.engine import (EngineConfig, EngineCore, Request,
                                        StepOutput)
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass
class RequestOutput:
    """Completed request: generated token ids and finish metadata."""
    uid: int
    prompt_token_ids: List[int]
    token_ids: List[int]
    finish_reason: str
    text: str = ""                 # detokenized (engines with a detokenizer)
    cached_tokens: int = 0         # prompt tokens served from the cache
    prefill_tokens: int = 0        # prompt tokens actually forwarded
    request: Optional[Request] = None   # timings (ttft/latency), slot, hits


def _is_single_prompt(prompts) -> bool:
    if isinstance(prompts, np.ndarray):
        return prompts.ndim == 1
    if isinstance(prompts, (list, tuple)) and prompts:
        return isinstance(prompts[0], (int, np.integer))
    return False


class LLM:
    """High-level front door owning one ``EngineCore``.

    ``detokenizer``: optional ``List[int] -> str``; enables
    ``SamplingParams.stop`` strings and fills ``RequestOutput.text``.
    Extra keyword arguments build the ``EngineConfig`` when ``ecfg`` is not
    given. ``faults``: a ``serving.faults.FaultInjector`` threaded through
    the core's injection sites. ``device``: where the core runs (``None``
    = CUDA; ``params`` must live there)."""

    def __init__(self, cfg, params, ecfg: Optional[EngineConfig] = None, *,
                 detokenizer: Optional[Callable] = None, faults=None,
                 device=None, **ecfg_kw):
        if ecfg is None:
            ecfg = EngineConfig(**ecfg_kw)
        elif ecfg_kw:
            raise ValueError(f"pass ecfg OR EngineConfig kwargs, not both "
                             f"({sorted(ecfg_kw)})")
        if ecfg.scheduler != "continuous":
            raise ValueError("LLM drives EngineCore.step(): continuous "
                             "scheduler only (use ServingEngine for the "
                             "cohort path)")
        self.core = EngineCore(cfg, params, ecfg, detokenizer=detokenizer,
                               faults=faults, device=device)
        self.detokenizer = detokenizer

    # -- driving -----------------------------------------------------------
    def _drive(self) -> List[StepOutput]:
        """One engine step; when nothing is admissible yet (open-loop
        arrivals), sleep until the next arrival so callers simply loop."""
        outs = self.core.step()
        if not outs and not self.core.has_active:
            t = self.core.next_arrival()
            if t is not None:
                time.sleep(max(1e-4, t - time.time()))
        return outs

    def _output_of(self, req: Request) -> RequestOutput:
        text = (self.detokenizer(list(req.generated))
                if self.detokenizer is not None else "")
        return RequestOutput(
            uid=req.uid, prompt_token_ids=list(map(int, req.prompt)),
            token_ids=list(req.generated), finish_reason=req.finish_reason,
            text=text, cached_tokens=req.cached_tokens,
            prefill_tokens=max(req.prefill_tokens, 0), request=req)

    # -- public API --------------------------------------------------------
    def generate(self, prompts,
                 params: Union[SamplingParams, Sequence[SamplingParams],
                               None] = None, *,
                 priority: int = 0) -> List[RequestOutput]:
        """Submit one prompt (a flat token sequence) or a batch of prompts
        and block until all finish. ``params``: one ``SamplingParams``
        shared by every prompt, or one per prompt."""
        single = _is_single_prompt(prompts)
        batch = [prompts] if single else list(prompts)
        if params is None or isinstance(params, SamplingParams):
            plist = [params] * len(batch)
        else:
            plist = list(params)
            if len(plist) != len(batch):
                raise ValueError(f"{len(plist)} SamplingParams for "
                                 f"{len(batch)} prompts")
        reqs = [self.core.add_request(p, sp, priority=priority)
                for p, sp in zip(batch, plist)]
        while any(not r.finished for r in reqs):
            self._drive()
        outs = [self._output_of(r) for r in reqs]
        self.core.reap_done()   # keep the long-lived core's memory bounded
        return outs

    def stream(self, prompt, params: Optional[SamplingParams] = None, *,
               max_new_tokens: Optional[int] = None,
               priority: int = 0) -> Iterator[StepOutput]:
        """Submit one prompt and yield its tokens as they come: one
        ``StepOutput`` per engine step that emitted tokens for THIS request
        (the admission chunk carries the first token; the final chunk has
        ``finished=True``; after an ``abort(uid)`` between chunks it is an
        empty terminal chunk with ``finish_reason="aborted"``, and after a
        quarantine a terminal chunk with ``finish_reason="error"``, the
        reason on ``Request.error``).

        The request is submitted when iteration begins (first
        ``__next__``), and abandoning the iterator (break, close, garbage
        collection) aborts it, so a dropped stream never pins a slot, its
        pages or a queue position. Chunks are cut against the Request's
        own token list: tokens generated while another call drives the
        shared core come with the next ``__next__``, never dropped."""
        def _gen():
            # Submitted here, not in stream(): an iterator closed before
            # its first __next__ never runs this body, so it enqueues
            # nothing.
            req = self.core.add_request(prompt, params,
                                        max_new_tokens=max_new_tokens,
                                        priority=priority)
            emitted = 0
            delivered_fin = False
            try:
                while True:
                    new = [int(t) for t in req.generated[emitted:]]
                    fin = req.finished
                    if new:
                        emitted += len(new)
                        delivered_fin = fin
                        yield StepOutput(req.uid, new, fin,
                                         req.finish_reason)
                    if fin:
                        if not delivered_fin:   # an out-of-band abort()
                            yield StepOutput(req.uid, [], True,
                                             req.finish_reason)
                        self.core.reap_done()
                        return
                    self._drive()
            finally:
                # abandoned mid-flight: release the slot and its pages
                if not req.finished:
                    self.core.abort(req.uid)

        return _gen()

    def abort(self, uid) -> bool:
        return self.core.abort(uid)


class Session:
    """Multi-turn chat over one ``LLM``.

    Each ``send(user_tokens)`` submits ``history + user_tokens`` as the
    prompt and appends the reply to the history, so with
    ``EngineConfig.prefix_cache=True`` a later turn aliases the pages the
    earlier turns filled (``RequestOutput.cached_tokens`` /
    ``prefill_tokens`` report the split)."""

    def __init__(self, llm: LLM, params: Optional[SamplingParams] = None):
        self.llm = llm
        self.params = params
        self.history: List[int] = []       # prompt + reply tokens so far
        self.turns: List[RequestOutput] = []

    def send(self, user_tokens,
             params: Optional[SamplingParams] = None) -> RequestOutput:
        prompt = self.history + list(map(int, user_tokens))
        out = self.llm.generate(np.asarray(prompt, np.int32),
                                params if params is not None
                                else self.params)[0]
        self.history = prompt + list(out.token_ids)
        self.turns.append(out)
        return out
