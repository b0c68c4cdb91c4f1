"""Step-driven serving core with a per-slot CHAI phase machine.

Request lifecycle (paper Fig 10), tracked PER BATCH SLOT:

    PREFILL  --(batch=1 full forward; KV rows written into the slot)-->
    WARMUP   --(MHA decode steps; per-head attention scores accumulate
                into the slot's clustering-feature buffer)-->
    CLUSTER  --(per-slot K-Means membership; the slot's dense K rows are
                compacted to representative rows)-->
    STEADY   --(Clustered Head Attention decode until a finish condition)

plus ``abort(uid)``, which cancels a request at any phase (or still
queued) and returns every page it held to the pools, and the chunked
PREFILL self-loop: with ``EngineConfig.prefill_chunk_tokens`` (paged
layout, global-attention archs), a prompt longer than the chunk forwards
one page-aligned chunk per ``step()``, interleaved with the batched decode
of the other slots; greedy tokens equal the monolithic prefill's. Each
chunk's attention is the CUDA ``paged_prefix_attend`` over the pages the
earlier chunks wrote plus the CUDA ``flash_prefill`` over the chunk.

* ``EngineCore`` owns the device state and the page pools, and ONE
  scheduling primitive: ``step()`` runs exactly one iteration (admit
  arrived requests into free slots, after advancing every mid-prefill
  slot by one chunk -> cluster/compact slots whose warmup completed ->
  one batched decode -> retire finished slots) and returns a
  ``StepOutput`` per request that produced tokens.
* ``ServingEngine`` is the ``submit()`` / ``run()`` batch surface over it.

Two schedulers (``EngineConfig.scheduler``):

* ``"continuous"`` (default): slot-level continuous batching. A fixed pool
  of batch slots holds requests at different phases at once; each step is
  one batched decode, host-dispatched to the all-MHA, all-CHAI or mixed
  step by the phase mix (the mixed step runs both attention paths and
  selects per slot). Two KV layouts (``EngineConfig.kv_layout``):

  - ``"paged"`` (default): block-table page pools. Admission is
    page-budget based, and the CLUSTER transition frees the slot's dense
    K pages back to the ``PagePool`` once the representative rows are
    gathered into clustered pages, so ``kv_bytes()`` falls (the paper's
    saving, realized by the allocator). The STEADY decode is the CUDA
    ``paged_chai_fused_decode``.
  - ``"dense"``: the unified per-slot layout (dense and clustered
    rectangles resident side by side), kept for parity; its STEADY
    decode is ``chai_fused_decode``.

* ``"cohort"``: the lockstep path (``serving.cohort``).

This port decodes greedily. Not ported yet, and refused with
``NotImplementedError``: sampling with temperature > 0, stop strings,
``priority`` (preemption); not there yet: prefix cache, relay decode,
fault injection and auditing, telemetry and KV tiers.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
from repro_torch.launch import steps as steps_mod
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving.cohort import CohortSchedulerMixin
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(eq=False)       # identity semantics: the queue and
class Request:                         # abort() membership-test Requests
    uid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # -- filled by the engine --
    generated: Optional[List[int]] = None
    finish_reason: str = ""            # "" while in flight; "length" |
    #                                    "stop" | "aborted" when done
    t_enqueue: float = 0.0
    t_arrival: float = 0.0             # earliest admission time
    t_first_token: float = 0.0         # first token on the host
    t_done: float = 0.0
    slot: int = -1                     # continuous: slot the request ran in
    admit_step: int = -1               # continuous: engine step at admission
    retire_step: int = -1              # continuous: engine step at retire

    @property
    def finished(self) -> bool:
        return bool(self.finish_reason)

    @property
    def ttft(self):
        return self.t_first_token - self.t_arrival

    @property
    def latency(self):
        return self.t_done - self.t_arrival


@dataclasses.dataclass
class StepOutput:
    """Per-request result of one ``EngineCore.step()``: the token ids
    emitted for this request THIS step, and whether it just finished."""
    uid: int
    token_ids: List[int]
    finished: bool = False
    finish_reason: str = ""


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4               # slot-pool / cohort size (static)
    max_seq: int = 256                 # KV capacity per slot (static)
    # Default SamplingParams for requests submitted without one: greedy
    # (temperature 0), or temperature 1.0 with greedy=False, which is not
    # ported yet and is refused at submission.
    greedy: bool = True
    scheduler: str = "continuous"      # "continuous" | "cohort"
    cohort_deadline_s: float = 120.0   # cohort straggler re-dispatch
    use_chai: bool = True
    # -- KV layout (continuous scheduler only) --
    kv_layout: str = "paged"           # "paged" | "dense"
    page_size: int = 16                # tokens per page (divides max_seq);
    #                                    also the fused decode's S-tile
    # Pool capacities in pages, INCLUDING the reserved null page 0.
    # 0 = auto: worst case for batch_slots requests of max_seq tokens.
    num_pages: int = 0                 # dense K/V pool
    num_chai_pages: int = 0            # clustered pool (MHA+CHAI archs)
    # Chunked prefill (paged layout, global-attention archs): a prompt
    # longer than this forwards at most ``prefill_chunk_tokens`` per
    # ``step()`` (rounded up to a page multiple), interleaved with the
    # running decodes, so a long prompt does not stall every concurrent
    # stream for its whole prefill. 0 = monolithic. Ignored on
    # kv_layout="dense", as in the reference.
    prefill_chunk_tokens: int = 0


class EngineCore(CohortSchedulerMixin):
    """Device-state owner + one-iteration scheduler (``step()``).

    ``device``: where the engine runs; ``None`` means CUDA, and a missing
    GPU raises. ``params`` must already live there."""

    _HISTORY_MAX = 1 << 16

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 device=None):
        self.device = resolve_device(device)
        if ecfg.scheduler not in ("continuous", "cohort"):
            raise ValueError(f"unknown scheduler {ecfg.scheduler!r}")
        if ecfg.kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown kv_layout {ecfg.kv_layout!r}")
        if cfg.n_attn_layers == 0 and ecfg.use_chai:
            raise ValueError("CHAI needs attention layers")
        if params["embed"]["tok"].device != self.device:
            raise ValueError(f"params live on {params['embed']['tok'].device}"
                             f", the engine on {self.device}")
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.redispatched = 0
        self.steps_executed = 0          # batched decode steps
        self._uid_counter = 0            # monotonic: uids never collide
        b, s = ecfg.batch_slots, ecfg.max_seq
        self.chai_on = ecfg.use_chai and cfg.chai.enabled and cfg.k_max > 0
        self.paged = (ecfg.scheduler == "continuous"
                      and ecfg.kv_layout == "paged"
                      and cfg.n_global_layers > 0)
        # MHA+CHAI archs carry the clustered page pool.
        self.chai_clustered = self.paged and self.chai_on and cfg.is_mha
        self.dense_pool = None
        self.chai_pool = None
        # Allocated-bytes trajectory (paged), one record per CLUSTER
        # transition and per decode step; the peak is a running int.
        self.kv_bytes_history: List[dict] = []
        self._kv_peak = 0
        if self.paged:
            if s % ecfg.page_size:
                raise ValueError(f"page_size {ecfg.page_size} must divide "
                                 f"max_seq {s}")
            p_slot = s // ecfg.page_size
            self._slot_pages_max = p_slot
            self.dense_pool = chai_cache.PagePool(
                ecfg.num_pages or (2 * b * p_slot + 1), ecfg.page_size)
            if self.chai_clustered:
                self.chai_pool = chai_cache.PagePool(
                    ecfg.num_chai_pages or (b * p_slot + 1), ecfg.page_size)
        # Chunked prefill: page-aligned chunks, paged layout only.
        self._chunk = 0
        if ecfg.prefill_chunk_tokens and self.paged:
            if any(t != ATTN_GLOBAL for t in cfg.layer_types):
                raise ValueError(
                    "prefill_chunk_tokens supports global-attention-only "
                    f"archs (got {cfg.name!r} with local/recurrent "
                    "layers): chunk forwards cannot rebuild local rings "
                    "or recurrent state from earlier chunks")
            ps = ecfg.page_size
            self._chunk = -(-ecfg.prefill_chunk_tokens // ps) * ps
        # Device state persists across step()/run() calls; None until the
        # first continuous step.
        self._dev_state = None
        self._dev_ctx = None
        self.cluster_transitions = 0     # CLUSTER transitions executed
        self._requests: dict = {}        # uid -> Request (abort lookup)
        self._slot_req: List[Optional[Request]] = [None] * b
        self._slot_count = [0] * b       # tokens generated this admission
        self._slot_pages: List[dict] = [{} for _ in range(b)]  # page ids
        # Mid-prefill cursors of chunked prefills: {"req", "tokens",
        # "cursor"} per slot, None otherwise.
        self._slot_prefill_state: List[Optional[dict]] = [None] * b
        self._next_tok = np.zeros((b,), np.int64)     # host mirror
        self._next_tok_dev = None
        self._tok_dirty = True
        self._phases = np.full((b,), chai_cache.PHASE_FREE, np.int32)
        # decode_ts = page_size pins the dense fused decode's tile to the
        # paged kernel's page, so every layout and scheduler performs
        # bit-identical attention arithmetic.
        ts = ecfg.page_size
        self._prefill = steps_mod.make_serve_prefill(cfg, b, s)
        self._mha_step = steps_mod.make_serve_step(cfg, chai=False,
                                                   decode_ts=ts)
        if self.paged:
            self._slot_prefill = steps_mod.make_paged_slot_prefill(cfg, s)
            self._chunk_prefill = steps_mod.make_paged_chunk_prefill(cfg, s)
            self._reset_slot = steps_mod.make_paged_slot_reset(cfg)
        else:
            self._slot_prefill = steps_mod.make_slot_prefill(cfg, s)
            self._reset_slot = steps_mod.make_slot_reset(cfg)
        self._cluster_slot = None        # built lazily (identify hook)
        if self.chai_on:
            self._chai_step = steps_mod.make_serve_step(cfg, chai=True,
                                                        decode_ts=ts)
            self._mixed_step = steps_mod.make_mixed_step(cfg, decode_ts=ts)
            self._compact = steps_mod.make_compact_step(cfg)
            self._identify = lambda sc: clustering.identify_membership(sc,
                                                                       cfg)

    # -- public API --------------------------------------------------------
    def default_sampling(self) -> SamplingParams:
        return (SamplingParams() if self.ecfg.greedy
                else SamplingParams(temperature=1.0))

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    *, max_new_tokens: Optional[int] = None, uid=None,
                    arrival_delay: float = 0.0,
                    priority: int = 0) -> Request:
        """Enqueue a greedy request. ``max_new_tokens`` (when given)
        overrides ``sampling.max_new_tokens``; ``arrival_delay`` (seconds
        from now) models open-loop arrivals. Default uids come from a
        monotonic engine counter."""
        sp = sampling if sampling is not None else self.default_sampling()
        if priority != 0:
            raise NotImplementedError(
                "priority (preemption) is not ported yet: ROADMAP Queue 1, "
                "chunked prefill and preemption")
        if not sp.greedy:
            raise NotImplementedError(
                "sampling with temperature > 0 is not ported yet: ROADMAP "
                "Queue 1, front-end API and sampling")
        if sp.stop:
            raise NotImplementedError(
                "stop strings need a detokenizer, which is not ported yet: "
                "ROADMAP Queue 1, front-end API and sampling")
        max_new = (max_new_tokens if max_new_tokens is not None
                   else sp.max_new_tokens)
        if len(prompt) + max_new > self.ecfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq ({self.ecfg.max_seq})")
        if uid is None:
            uid = self._uid_counter
        self._uid_counter = max(self._uid_counter, int(uid) + 1)
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new, sampling=sp)
        req.t_enqueue = time.time()
        req.t_arrival = req.t_enqueue + arrival_delay
        req.generated = []
        self.queue.append(req)
        self._requests[uid] = req
        return req

    def _done(self, req: Request):
        self.done.append(req)
        if self._requests.get(req.uid) is req:
            del self._requests[req.uid]

    def abort(self, uid) -> bool:
        """Cancel a request: a queued one is dropped before touching the
        device; a running one retires at once, its pages return to the
        pools and its slot resets. Tokens generated so far stay on the
        Request (``finish_reason="aborted"``). False for unknown or
        finished uids."""
        req = self._requests.get(uid)
        if req is None or req.finished:
            return False
        if req in self.queue:
            self.queue.remove(req)
            req.finish_reason = sampling_mod.FINISH_ABORT
            req.t_done = time.time()
            req.retire_step = self.steps_executed
            self._done(req)
            return True
        for i, r in enumerate(self._slot_req):
            if r is req:
                self._retire_slot(i, sampling_mod.FINISH_ABORT)
                return True
        return False

    @property
    def has_active(self) -> bool:
        return any(r is not None for r in self._slot_req)

    def has_work(self) -> bool:
        return bool(self.queue) or self.has_active

    def step(self) -> List[StepOutput]:
        """Run exactly ONE scheduler iteration: forward one chunk of every
        mid-prefill slot, admit arrived requests into free slots, run
        CLUSTER transitions for slots whose warmup just completed, one
        batched decode over the slots past prefill, and retire slots that
        hit a finish condition. Returns one ``StepOutput`` per request that
        emitted tokens; ``[]`` when there is no admissible work. With the
        engine idle and the queue head beyond the pools' capacity, raises
        ``MemoryError``."""
        if self.ecfg.scheduler != "continuous":
            raise RuntimeError("step() drives the continuous scheduler; "
                               "cohort engines run via run()")
        outs: List[StepOutput] = []
        self._ensure_dev_state()
        self._advance_prefills(outs)
        blocked = self._admit(outs)
        active = [i for i in range(self.ecfg.batch_slots)
                  if self._slot_req[i] is not None
                  and self._phases[i] != chai_cache.PHASE_PREFILL]
        if not active:
            if self.has_active:
                return outs        # only mid-prefill slots: progress made
            if self.queue and blocked:
                head = self.queue[0]
                n = self._pages_for(head)
                raise MemoryError(
                    f"request uid={head.uid} needs {2 * n} dense and "
                    f"{self._chai_pages_per(n)} clustered pages; pool "
                    f"capacities {self.dense_pool.capacity} and "
                    f"{self.chai_pool.capacity if self.chai_pool else 0}")
            return outs
        self._cluster_transitions(active)
        outs.extend(self._decode(active))
        return outs

    # -- prefill helpers ----------------------------------------------------
    @staticmethod
    def _prompt_bucket(t: int, cap: int) -> int:
        """Next power of two >= t, capped at max_seq."""
        b = 1
        while b < t:
            b <<= 1
        return min(b, cap)

    def _padded_suffix(self, suffix, prefix_len: int):
        """Right-pad the tokens at positions ``prefix_len..`` (a whole
        prompt when 0, else a chunk) to their bucket, the reference's
        shapes, so both packages forward the same padded length; returns
        (tokens (1, bucket), true length). The bucket is the next power of
        two, or the page multiple of the length where the power of two
        would run past max_seq: padded cache rows must stay inside the
        slot's logical pages."""
        t = len(suffix)
        ps = self.ecfg.page_size
        bucket = self._prompt_bucket(t, self.ecfg.max_seq)
        if bucket > self.ecfg.max_seq - prefix_len:
            bucket = chai_cache.pages_needed(t, ps) * ps
        assert t <= bucket <= self.ecfg.max_seq - prefix_len, \
            (bucket, t, prefix_len)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :t] = suffix
        return torch.from_numpy(toks).to(self.device), t

    def _cluster_fn(self):
        # Built on first use so a replaced ``_identify`` hook is honored.
        if self._cluster_slot is None:
            maker = (steps_mod.make_paged_slot_cluster if self.paged
                     else steps_mod.make_slot_cluster)
            self._cluster_slot = maker(self.cfg, self._identify)
        return self._cluster_slot

    def _finish_of(self, req: Request) -> str:
        return sampling_mod.finish_reason(req.generated, req.sampling,
                                          req.max_new_tokens)

    # -- paged-pool bookkeeping (host side) --------------------------------
    def _pages_for(self, req) -> int:
        """Logical pages a request can touch over its lifetime."""
        n = chai_cache.pages_needed(
            len(req.prompt) + req.max_new_tokens, self.ecfg.page_size)
        return min(n, self._slot_pages_max)

    def _chai_pages_per(self, n: int) -> int:
        return n if self.chai_clustered else 0

    def _try_alloc(self, req):
        """Page-budget admission: allocate the request's dense K + V pages
        and reserve its clustered pages, so the CLUSTER transition can
        never stall mid-flight. Returns a page dict, or None if the pools
        cannot cover it yet."""
        n = self._pages_for(req)
        chai_n = self._chai_pages_per(n)
        if self.dense_pool.free_pages < 2 * n:
            return None
        if chai_n and self.chai_pool.free_pages < chai_n:
            return None
        pages = {"kg": self.dense_pool.alloc(n),
                 "vg": self.dense_pool.alloc(n)}
        if self.chai_clustered:
            pages["kc"] = self.chai_pool.alloc(n)
        return pages

    def _free_pages(self, pages: dict):
        for key, pool in (("kg", self.dense_pool), ("vg", self.dense_pool),
                          ("kc", self.chai_pool)):
            if key in pages:
                pool.free(pages.pop(key))

    def _page_vec(self, pages):
        """Null-padded (P,) int32 device vector of a page list."""
        vec = np.zeros((self._slot_pages_max,), np.int32)
        vec[:len(pages)] = pages
        return torch.from_numpy(vec).to(self.device)

    def _record_kv_bytes(self):
        bytes_now = self.kv_bytes()
        self._kv_peak = max(self._kv_peak, bytes_now)
        if len(self.kv_bytes_history) >= self._HISTORY_MAX:
            return
        phases = self._phases
        self.kv_bytes_history.append({
            "step": self.steps_executed,
            "kv_bytes": bytes_now,
            "dense_pages": self.dense_pool.pages_in_use,
            "chai_pages": (self.chai_pool.pages_in_use
                           if self.chai_pool else 0),
            "n_warmup": int((phases == chai_cache.PHASE_WARMUP).sum()),
            "n_steady": int((phases == chai_cache.PHASE_STEADY).sum()),
        })

    def _ensure_dev_state(self):
        """Continuous-scheduler device state, built once and kept across
        ``step()``/``run()`` calls (retired slots rewind ``pos``, so stale
        rows are masked like the zero tail)."""
        if self._dev_state is None:
            cfg, ecfg = self.cfg, self.ecfg
            b = ecfg.batch_slots
            if self.paged:
                self._dev_state = chai_cache.init_paged_state(
                    cfg, b, ecfg.max_seq, page_size=ecfg.page_size,
                    dense_pages=self.dense_pool.num_pages,
                    chai_pages=(self.chai_pool.num_pages if self.chai_pool
                                else 0),
                    chai=self.chai_on, device=self.device)
            else:
                self._dev_state = chai_cache.init_unified_state(
                    cfg, b, ecfg.max_seq, chai=self.chai_on,
                    device=self.device)
            self._dev_ctx = (clustering.init_batched_ctx(cfg, b, self.device)
                             if self.chai_on else None)
        return self._dev_state, self._dev_ctx

    # -- step internals ----------------------------------------------------
    def _admit(self, outs: List[StepOutput]) -> bool:
        """Fill free slots from the arrived FIFO prefix while the page
        budget covers prompt + generation headroom. Returns True when the
        queue head had arrived but the pools could not cover it yet."""
        now = time.time()
        while self.queue and self.queue[0].t_arrival <= now:
            free_slots = [i for i in range(self.ecfg.batch_slots)
                          if self._slot_req[i] is None]
            if not free_slots:
                break
            pages = self._try_alloc(self.queue[0]) if self.paged else {}
            if pages is None:         # FIFO holds until pages free up
                return True
            i = free_slots[0]
            req = self.queue.popleft()
            self._admit_to_slot(i, req, pages)
            req.slot, req.admit_step = i, self.steps_executed
            self._slot_req[i] = req
            trunc, reason = sampling_mod.scan_finish(
                req.generated, req.sampling, req.max_new_tokens)
            if reason:
                req.generated = trunc
                self._retire_slot(i, reason)
            if req.generated or reason:
                # A chunked admission has no first token yet: its
                # StepOutput comes with its final chunk.
                outs.append(StepOutput(req.uid, list(req.generated),
                                       bool(reason), reason))
        return False

    def _admit_to_slot(self, i: int, req: Request, pages: dict):
        """Prefill ``req`` into free slot ``i`` (cold: no cached prefix)."""
        self._slot_pages[i] = pages
        self._phases[i] = chai_cache.PHASE_PREFILL
        if self._chunk and len(req.prompt) > self._chunk:
            # Chunked prefill: the first chunk now; step() advances one
            # chunk per iteration until the final one enters WARMUP.
            self._slot_prefill_state[i] = {"req": req, "tokens": req.prompt,
                                           "cursor": 0}
            self._advance_chunk(i)
            return
        toks, true_len = self._padded_suffix(req.prompt, 0)
        if self.paged:
            logits, self._dev_state = self._slot_prefill(
                self.params, toks, true_len, self._dev_state, i,
                self._page_vec(pages["kg"]), self._page_vec(pages["vg"]))
        else:
            logits, self._dev_state = self._slot_prefill(
                self.params, toks, true_len, self._dev_state, i)
        self._finish_prefill(i, req, logits)

    def _advance_prefills(self, outs: List[StepOutput]):
        """Forward ONE chunk for every mid-prefill slot. A slot whose final
        chunk completes enters WARMUP and emits its first token here."""
        for i in range(self.ecfg.batch_slots):
            st = self._slot_prefill_state[i]
            if st is None:
                continue
            req = st["req"]
            self._advance_chunk(i)
            if self._slot_prefill_state[i] is not None:
                continue                    # more chunks to go
            reason = self._finish_of(req)
            if reason:
                self._retire_slot(i, reason)
            outs.append(StepOutput(req.uid, [req.generated[-1]],
                                   bool(reason), reason))

    def _advance_chunk(self, i: int):
        """Prefill the next chunk of slot ``i``'s prompt. Chunk starts are
        page-aligned (the chunk is a page multiple), so each chunk's
        scatter touches exactly its own page range; an intermediate chunk
        parks the device phase at FREE so the interleaved decode treats
        the slot as empty."""
        st = self._slot_prefill_state[i]
        prompt, cur = st["tokens"], st["cursor"]
        end = min(cur + self._chunk, len(prompt))
        final = end == len(prompt)
        toks, true_len = self._padded_suffix(prompt[cur:end], cur)
        ps = self.ecfg.page_size
        lo, hi = cur // ps, chai_cache.pages_needed(end, ps)
        pages = self._slot_pages[i]

        def scatter(page_list):
            return [p if lo <= j < hi else chai_cache.NULL_PAGE
                    for j, p in enumerate(page_list)]

        phase = chai_cache.PHASE_WARMUP if final else chai_cache.PHASE_FREE
        logits, self._dev_state = self._chunk_prefill(
            self.params, toks, true_len, cur, self._dev_state, i,
            self._page_vec(scatter(pages["kg"])),
            self._page_vec(scatter(pages["vg"])),
            self._page_vec(pages["kg"]), self._page_vec(pages["vg"]), phase)
        st["cursor"] = end
        if final:
            self._slot_prefill_state[i] = None
            self._finish_prefill(i, st["req"], logits)

    def _finish_prefill(self, i: int, req: Request, logits):
        """Prefill completed (monolithic, or a chunked prefill's final
        chunk): enter WARMUP and take the first token."""
        self._phases[i] = chai_cache.PHASE_WARMUP
        self._slot_count[i] = 1
        tok = int(self._argmax(logits)[0])
        req.generated.append(tok)
        req.t_first_token = time.time()
        self._next_tok[i] = tok
        self._tok_dirty = True

    def _cluster_transitions(self, active):
        """CLUSTER + compact the slots whose warmup just completed; paged:
        the slot's dense K pages return to the pool here."""
        if not self.chai_on:
            return
        warm = self.cfg.chai.warmup_tokens
        for i in active:
            if not (self._slot_count[i] == warm + 1
                    and self._phases[i] == chai_cache.PHASE_WARMUP):
                continue
            self._phases[i] = chai_cache.PHASE_CLUSTER
            self.cluster_transitions += 1
            if self.paged:
                self._dev_state, self._dev_ctx = self._cluster_fn()(
                    self._dev_state, self._dev_ctx, i,
                    self._page_vec(self._slot_pages[i].get("kc", [])))
                if self.chai_clustered:
                    self.dense_pool.free(self._slot_pages[i].pop("kg"))
                self._record_kv_bytes()
            else:
                self._dev_state, self._dev_ctx = self._cluster_fn()(
                    self._dev_state, self._dev_ctx, i)
            self._phases[i] = chai_cache.PHASE_STEADY

    def _decode(self, active) -> List[StepOutput]:
        """One batched decode step on the cheapest step that covers the
        phase mix, then one greedy pick per slot."""
        outs: List[StepOutput] = []
        if self._tok_dirty:
            self._next_tok_dev = torch.from_numpy(self._next_tok).to(
                self.device)
            self._tok_dirty = False
        occupied = self._phases[self._phases != chai_cache.PHASE_FREE]
        logits, self._dev_state = self._dispatch_decode(
            {"tokens": self._next_tok_dev}, occupied)
        tok_dev = self._argmax(logits)
        self._next_tok_dev = tok_dev
        toks = tok_dev.cpu().numpy()
        self._next_tok[:] = toks
        self.steps_executed += 1
        for i in active:
            r = self._slot_req[i]
            r.generated.append(int(toks[i]))
            self._slot_count[i] += 1
            reason = self._finish_of(r)
            if reason:
                self._retire_slot(i, reason)
            outs.append(StepOutput(r.uid, [int(toks[i])], bool(reason),
                                   reason))
        if self.paged:
            self._record_kv_bytes()
        return outs

    def _dispatch_decode(self, inputs, occupied):
        """All-CHAI when every occupied slot is STEADY, all-MHA when every
        one is WARMUP (or CHAI is off), else the mixed-phase step."""
        state = self._dev_state
        if not self.chai_on:
            return self._mha_step(self.params, inputs, state)
        if (occupied == chai_cache.PHASE_STEADY).all():
            return self._chai_step(self.params, inputs, state, self._dev_ctx)
        if (occupied == chai_cache.PHASE_WARMUP).all():
            return self._mha_step(self.params, inputs, state)
        return self._mixed_step(self.params, inputs, state, self._dev_ctx)

    def _retire_slot(self, i: int, reason: str):
        """Retire or abort slot ``i``: finalize the request, reset the slot
        on the device and return every page it held to the pools."""
        r = self._slot_req[i]
        r.generated = r.generated[:r.max_new_tokens]
        r.finish_reason = reason
        r.t_done = time.time()
        r.retire_step = self.steps_executed
        self._done(r)
        self._slot_req[i] = None
        self._slot_prefill_state[i] = None
        self._phases[i] = chai_cache.PHASE_FREE
        self._slot_count[i] = 0
        self._dev_state = self._reset_slot(self._dev_state, i)
        if self.paged:          # block tables are nulled; pages go back
            self._free_pages(self._slot_pages[i])

    # -- metrics ------------------------------------------------------------
    def kv_bytes(self, *, chai: Optional[bool] = None):
        """KV-cache bytes. With explicit ``chai=``: the paper's analytic
        steady-state size (Fig 11 A/B comparisons). With no argument on
        the continuous scheduler: this engine's actual footprint, the
        allocated-page bytes right now (paged; falls at each CLUSTER
        transition) or the unified layout's constant residency (dense)."""
        if chai is None and self.ecfg.scheduler == "continuous":
            if self.paged:
                return chai_cache.paged_kv_bytes(
                    self.cfg, self.ecfg.page_size,
                    self.dense_pool.pages_in_use,
                    self.chai_pool.pages_in_use if self.chai_pool else 0)
            return chai_cache.unified_kv_bytes(
                self.cfg, self.ecfg.batch_slots, self.ecfg.max_seq,
                chai=self.chai_on)
        chai = self.chai_on if chai is None else chai
        return chai_cache.kv_cache_bytes(
            self.cfg, self.ecfg.batch_slots, self.ecfg.max_seq, chai=chai)

    def kv_bytes_peak(self):
        """Paged: high-water allocated bytes over the run."""
        if not self.paged:
            return 0
        return max(self._kv_peak, self.kv_bytes())

    def kv_bytes_capacity(self):
        """Paged: bytes if every pool page were in use; dense layouts: the
        resident footprint."""
        if not self.paged:
            return self.kv_bytes()
        return chai_cache.paged_kv_bytes(
            self.cfg, self.ecfg.page_size, self.dense_pool.capacity,
            self.chai_pool.capacity if self.chai_pool else 0)


class ServingEngine(EngineCore):
    """Batch surface over ``EngineCore``: ``submit()`` enqueues, ``run()``
    drains the queue (looping ``step()``, or through lockstep cohorts
    with ``scheduler="cohort"``) and returns the completed requests."""

    def submit(self, prompt, max_new_tokens=32, uid=None, *,
               arrival_delay: float = 0.0,
               sampling: Optional[SamplingParams] = None):
        """Enqueue a request (see ``EngineCore.add_request``)."""
        return self.add_request(prompt, sampling,
                                max_new_tokens=max_new_tokens, uid=uid,
                                arrival_delay=arrival_delay)

    def run(self):
        """Drain the queue; returns completed requests."""
        if self.ecfg.scheduler == "cohort":
            return self._run_cohort_loop()
        while self.has_work():
            outs = self.step()
            if not outs and not self.has_active and self.queue:
                # open-loop idle: wait for the next arrival
                time.sleep(max(1e-4,
                               self.queue[0].t_arrival - time.time()))
        return self.done
