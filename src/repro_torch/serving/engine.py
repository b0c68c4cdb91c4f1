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

With ``EngineConfig.prefix_cache`` (paged layout) admission consults a
radix tree over token blocks (``serving.prefix_cache``): a request whose
prompt starts with cached whole pages aliases them (refcounted, never
written) and prefills only its suffix (the PREFILL edge above shortened);
a greedy request whose full prompt was served before resumes from the
CHAI snapshot captured at that request's CLUSTER transition and enters
STEADY directly (PREFILL -> STEADY), or, when the snapshot's warmup
tokens cover its whole budget, is answered on the host without a slot.
With ``relay_decode`` on top, STEADY slots admitted through the same
cached chain form relay groups: each decode step reads the shared prefix
once per group and layer (the CUDA ``relay_prefix_decode``) and each
slot's fused decode only its private suffix, merged by online-softmax
state.

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

GQA models (``nemotron-4-15b``) run every path above: membership is
per KV group, the K cache stays per group (no clustered pool; no pages
are freed at CLUSTER) and both fused kernels run with ``reps_per_group
= r_max``. Their prefix cache reuses the radix tree's dense pages only
(no CHAI snapshot: as in the reference, snapshots need the clustered
pool), and relay decode routes each KV group's reps to its K row.

With ``use_chai=False`` (the MHA baseline) every decode step runs the
flash decode kernels: ``paged_decode`` on the paged pool in place,
``flash_decode`` on the dense layouts (either scheduler).

Local-attention models (``gemma2-9b``, local and global layers
alternating, with tanh softcaps; ``h2o-danube-1.8b``, all local) run
both schedulers and both layouts, the MHA baseline included. Their
rings are per slot and never paged, so a model without global layers
runs ``kv_layout="paged"`` on the unified layout, as the reference does;
chunked prefill and the prefix cache refuse them (a ring cannot be
rebuilt from a suffix). The fused kernels run their softcap mode on the
global layers; with CHAI off, a local layer, and a global layer of a
softcap model, decodes eagerly (the flash decode kernels have neither a
ring nor a softcap, in the reference as here).

Each request carries its ``SamplingParams``: greedy (``temperature == 0``,
the raw-logits argmax) or a seeded top-k / top-p draw
(``launch.steps.make_sampler``) keyed by (seed, tokens sampled so far),
so a seeded request gives the same tokens on either scheduler and
layout. Stop token ids and, with ``EngineCore(detokenizer=...)``, stop
strings finish a request at their first match. ``serving.api`` is the
front door over ``EngineCore`` (``LLM``, ``stream``, ``Session``).

Failures are typed (``serving.faults``). A request-isolatable failure
(an injected fault at a named site, non-finite logits) QUARANTINES its
request: ``finish_reason="error"`` with ``Request.error`` set, its pages
returned refcount-exactly, the rest of the batch decoding on. Every
continuous ``step()`` ends in an invariant audit (``serving.invariants``;
``EngineConfig.audit_level``) that raises ``EngineFault`` on corrupt
engine state. A seeded ``FaultInjector`` (``EngineCore(faults=...)``)
drives the sites. An injected ``kernel.decode`` fault, raised before any
launch, retries the step on the plain versions of the decode kernels
(``kernels.ref``, on the engine's device) and keeps the engine there
(``degraded_decode``) until ``decode_heal_steps`` clean steps have passed;
any other exception in the decode propagates, since after a real CUDA
error the context is unusable and the step may already have written K/V
in place.

Telemetry (``EngineConfig.telemetry``, ``serving.telemetry``): at "basic"
a metrics registry (request flow, TTFT / ITL / queue / latency
histograms, faults, the CHAI gauges and counters, the relay and KV-tier
counters, the KV occupancy gauges) and per-request lifecycle timelines;
at "trace" also a span for each stage of every ``step()`` (``step``,
``admit``, ``cluster``, ``relay.form``, ``decode.dispatch``, ``sample``,
``retire``, ``audit``), exported as a Chrome trace (``step_trace()``),
the registry as Prometheus text (``metrics_text()``). Every hook sits
behind ``tel.enabled``: at "off" (the default) a step runs the same torch
ops and device work as without telemetry, and the decode step keeps its
one device-to-host copy at every tier. Spans are on the host clock.

KV tiers (``EngineConfig.kv_offload``, paged layout, ``serving.kv_tiers``):
under device pool pressure an unlocked prefix-cache entry DEMOTES to a
host page (pinned memory on CUDA, CRC-stamped) instead of dropping; under
host pressure a radix block re-codes to int4, and the ladder ends in a
drop. A hit on a demoted entry PROMOTES it into fresh device pages, bit
for bit, before the plan aliases it; a checksum mismatch, an injected
``offload.in`` fault or (with ``lossy_promote=False``) a compressed entry
drops the entry and the request re-plans cold.

Priority preemption (``EngineConfig.preemption``, paged layout): when the
arrived queue head strictly outranks a running request (``priority``) and
no slot or no pages can take it, the lowest-priority running slot (the
latest admitted among equals) is PREEMPTED: its per-slot columns and the
contents of its pages are copied to host pages of the tier manager
(CRC-stamped), its device pages are freed, and the request goes back to
the queue right behind the head. Its re-admission swaps everything back
into fresh pages and continues the SAME decode chain, bit for bit (the
same kernels as an uninterrupted run; a seeded request draws token n
from (seed, n) as always). A victim still in PREFILL saves nothing and
prefills again. A corrupted host copy (a CRC mismatch at swap-in) or an
injected ``swap.in`` / ``offload.in`` fault quarantines the victim before
its swap-in touches the device.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
from repro_torch.launch import steps as steps_mod
from repro_torch.models.transformer import check_supported
from repro_torch.serving import exporters as exporters_mod
from repro_torch.serving import faults as faults_mod
from repro_torch.serving import invariants as invariants_mod
from repro_torch.serving import kv_tiers as kv_tiers_mod
from repro_torch.serving import sampling as sampling_mod
from repro_torch.serving import telemetry as telemetry_mod
from repro_torch.serving.cohort import CohortSchedulerMixin
from repro_torch.serving.faults import (CapacityError, EngineFault,
                                        FaultInjector, InjectedFault,
                                        QuarantineError, RequestError,
                                        SnapshotRestoreError,
                                        ValidationError)
from repro_torch.serving.prefix_cache import BlockNode, ChaiSnapshot, \
    PrefixCache
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
    #                                    "stop" | "aborted" | "error"
    t_enqueue: float = 0.0
    t_arrival: float = 0.0             # earliest admission time
    t_first_token: float = 0.0         # first token on the host
    t_done: float = 0.0
    priority: int = 0                  # preemption class: higher outranks
    slot: int = -1                     # continuous: slot the request ran in
    admit_step: int = -1               # continuous: engine step at admission
    retire_step: int = -1              # continuous: engine step at retire
    # -- prefix cache --
    cache_hit: str = ""                # "" | "prefix" | "snapshot" | "replay"
    cached_tokens: int = 0             # prompt tokens served from cache
    prefill_tokens: int = -1           # tokens actually forwarded (prefill)
    # -- failure taxonomy --
    error: str = ""                    # quarantine message when
    #                                    finish_reason == "error"
    # -- preemption --
    preemptions: int = 0               # times this request lost its slot
    # The swapped-out slot (phase, token count, per-slot columns, CHAI
    # membership, the host tier's page ids and the CRC) its next admission
    # swaps back in; None for fresh and mid-PREFILL-evicted requests.
    resume_state: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)

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
    emitted for this request THIS step (one decode token; several at a
    snapshot or replay admission), and whether it just finished."""
    uid: int
    token_ids: List[int]
    finished: bool = False
    finish_reason: str = ""


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4               # slot-pool / cohort size (static)
    max_seq: int = 256                 # KV capacity per slot (static)
    # Default SamplingParams for requests submitted without one: greedy
    # (temperature 0), or temperature 1.0 with greedy=False.
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
    # -- shared-prefix KV reuse (paged layout, global-attention archs) --
    # Radix-tree prefix cache over token blocks: admission aliases the
    # longest cached block prefix into the slot's block tables and
    # prefills only the uncached suffix; a greedy request whose FULL
    # prompt was served before resumes from a CHAI snapshot (membership
    # + clustered pages) and enters STEADY directly. Cached pages are
    # refcounted, copy-on-write, LRU-evicted under pressure.
    prefix_cache: bool = False
    # -- shared-prefix relay decode (prefix_cache + paged + CHAI) --
    # STEADY slots admitted through the same radix chain group on their
    # deepest shared node with >= relay_min_group members; each decode
    # step runs ONE group-batched prefix pass per layer over a packed
    # copy of the shared pages, while each slot's fused decode covers only
    # its private suffix pages; the two online-softmax states merge before
    # the finalize. Slots outside a group decode bitwise as without it.
    relay_decode: bool = False
    relay_min_group: int = 2           # smallest group worth a prefix pass
    # -- priority preemption (paged layout) --
    # When the arrived queue head outranks a running request and the
    # pools or the slots cannot take it, the lowest-priority running slot
    # is swapped out to host pages (its KV and per-slot state) and
    # re-queued behind the head; its re-admission swaps it back in and
    # continues the same decode chain. Equal priorities never preempt.
    # False: FIFO admission, whatever the priorities.
    preemption: bool = True
    # -- runtime self-checks (serving/invariants.py) --
    # "basic" (default): cheap host-side checks after every continuous
    # step() (pool conservation, refcount accounting, phase legality,
    # cache lock / residency consistency). "deep": also read the device
    # block tables and phase vector (one transfer) and check them against
    # the host bookkeeping. "off": no auditing. A failed audit raises
    # EngineFault.
    audit_level: str = "basic"         # "off" | "basic" | "deep"
    # -- telemetry (serving/telemetry.py) --
    # "off" (default): NullTelemetry; every hook is a no-op behind an
    # ``enabled`` guard and a step runs the same torch ops as without
    # telemetry. "basic": the metrics registry (counters, gauges,
    # histograms) and per-request lifecycle timelines (TTFT / ITL / queue
    # time). "trace": also a span for every step() stage, exportable as a
    # Chrome trace (``step_trace()``).
    telemetry: str = "off"             # "off" | "basic" | "trace"
    # -- degraded-decode healing --
    # After an injected kernel.decode fault flips ``degraded_decode`` the
    # engine decodes on the kernels' plain versions; with N > 0 it returns
    # to the kernels after N consecutive clean decode steps (each return
    # counts in ``decode_heals``). 0 = never.
    decode_heal_steps: int = 0
    # -- hierarchical KV tiers (serving/kv_tiers.py; paged layout) --
    # kv_offload turns prefix-cache eviction into DEMOTION: under device
    # pool pressure an unlocked radix leaf or CHAI snapshot moves to host
    # pages instead of dropping (the LRU ladder walks hot -> host ->
    # compressed int4 -> gone), and a hit on a demoted entry promotes it
    # into fresh device pages (bitwise: greedy tokens as with no pressure).
    # On CUDA the host pages live in pinned memory, allocated in slabs on
    # the first demotion.
    kv_offload: bool = False
    # Host / compressed pool sizes in usable pages PER KIND (the dense and
    # the clustered pool each get this many). 0 = auto: the host pool
    # covers 2x the device pool, the int4 pool matches the host pool. Only
    # radix blocks ride the compressed rung (snapshots replay bitwise).
    host_pages: int = 0
    compressed_pages: int = 0
    # Admission-time prefetch: add_request queues the promotion of the
    # demoted entries the request will hit; step() promotes a few of them
    # ahead of the admission (a synchronous promotion at plan time stays
    # the fallback).
    tier_prefetch: bool = True
    # A hit on an int4-compressed entry: False (default) drops the entry
    # and re-plans cold (still exact: the prefill recomputes); True
    # promotes the dequantized approximation.
    lossy_promote: bool = False


#: planner sentinel: a demoted entry was dropped mid-plan (a failed
#: promotion, a compressed hit): the tree changed, plan again.
_REPLAN = object()


_DEGRADED_HELP = "1 while decode runs the kernels' plain versions"

_PHASE_NAMES = {chai_cache.PHASE_FREE: "FREE",
                chai_cache.PHASE_PREFILL: "PREFILL",
                chai_cache.PHASE_WARMUP: "WARMUP",
                chai_cache.PHASE_CLUSTER: "CLUSTER",
                chai_cache.PHASE_STEADY: "STEADY"}


class EngineCore(CohortSchedulerMixin):
    """Device-state owner + one-iteration scheduler (``step()``).

    ``device``: where the engine runs; ``None`` means CUDA, and a missing
    GPU raises. ``params`` must already live there. ``detokenizer``:
    optional ``List[int] -> str`` that ``SamplingParams.stop`` strings are
    matched against."""

    _HISTORY_MAX = 1 << 16

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 detokenizer: Optional[Callable] = None,
                 faults: Optional[FaultInjector] = None, device=None):
        check_supported(cfg)       # the cache dtype, share_values
        self.device = resolve_device(device)
        self.detokenizer = detokenizer
        if ecfg.audit_level not in ("off", "basic", "deep"):
            raise ValueError(f"audit_level must be off|basic|deep, got "
                             f"{ecfg.audit_level!r}")
        if ecfg.decode_heal_steps < 0:
            raise ValueError("decode_heal_steps must be >= 0, got "
                             f"{ecfg.decode_heal_steps}")
        # the tier's validation happens inside make_telemetry
        self.tel = telemetry_mod.make_telemetry(ecfg.telemetry)
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
        # -- fault containment / robustness --
        self.faults = faults           # None = no injection site active
        self.quarantined = 0           # requests typed-failed ("error")
        self.audit_steps = 0           # step()s that ran the auditor
        self.degraded_decode = False   # decode on the plain versions now
        self.decode_fallbacks = 0      # injected decode faults survived
        self.decode_heals = 0          # degraded -> kernel reverts
        self._heal_clean = 0           # consecutive clean degraded steps
        self._decode_fault_hit = False  # kernel.decode fired this step
        self.relay_dissolved = 0       # relay groups dissolved by fault
        self.swap_checksum_failures = 0      # corrupted swap-ins caught
        self.offload_checksum_failures = 0   # corrupted promotions caught
        self.prefetch_hits = 0         # demoted hit found already promoted
        self.prefetch_misses = 0       # demoted hit promoted at plan time
        self._plain_steps = None       # degraded decode steps, built lazily
        self._fault_blocked = False    # last plan blocked by injection
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.redispatched = 0
        self.preemptions = 0             # slots reclaimed for priority
        self.steps_executed = 0          # batched decode steps
        self._step_calls = 0             # every _step_inner entry (spans)
        self._span_step = -1             # step ordinal current spans carry
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
                # share_values: clustered K and V pages, one pool
                share = 2 if cfg.chai.share_values else 1
                self.chai_pool = chai_cache.PagePool(
                    ecfg.num_chai_pages or (share * b * p_slot + 1),
                    ecfg.page_size)
        # Shared-prefix KV reuse (paged layout only).
        self.prefix_cache = None
        if ecfg.prefix_cache:
            if not self.paged:
                raise ValueError("prefix_cache requires the paged KV "
                                 "layout on the continuous scheduler")
            if any(t != ATTN_GLOBAL for t in cfg.layer_types):
                raise ValueError(
                    "prefix_cache supports global-attention-only archs "
                    f"(got {cfg.name!r} with local/recurrent layers)")
            self.prefix_cache = PrefixCache(self.dense_pool, self.chai_pool,
                                            ecfg.page_size)
        # Hierarchical KV tiers: a TierManager on every paged engine (its
        # pools hold nothing, and pin nothing, until a demotion); demotion
        # needs ecfg.kv_offload.
        self.tiers = None
        self._prefetch_q: deque = deque()
        self._prefetch_ids: set = set()
        if ecfg.kv_offload and not self.paged:
            raise ValueError("kv_offload requires the paged KV layout "
                             "on the continuous scheduler")
        if self.paged:
            host_d = ecfg.host_pages or 2 * self.dense_pool.capacity
            host_c = 0
            if self.chai_pool is not None:
                host_c = ecfg.host_pages or 2 * self.chai_pool.capacity
            self.tiers = kv_tiers_mod.TierManager(
                ecfg.page_size,
                host_pages={"dense": host_d, "chai": host_c},
                # Only radix blocks compress, and blocks hold dense pages
                # only: the clustered kind never rides the int4 rung.
                comp_pages={"dense": ecfg.compressed_pages or host_d,
                            "chai": 0},
                on_transition=self._tel_tier_transition,
                pin=self.device.type == "cuda")
            if self.prefix_cache is not None:
                self.prefix_cache.tiers = self.tiers
                self.tiers.drop_hook = self.prefix_cache.drop_demoted
                self.tiers.droppable_hook = self.prefix_cache._droppable
                if ecfg.kv_offload:
                    self.prefix_cache.demote_hook = self._demote_entry
        self.relay_decode = False
        if ecfg.relay_decode:
            if not (self.paged and self.chai_on and ecfg.prefix_cache):
                raise ValueError(
                    "relay_decode requires prefix_cache on the paged "
                    "layout with CHAI enabled (the relay groups STEADY "
                    "slots by their locked radix chain)")
            self.relay_decode = True
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
        self._slot_locked: List[list] = [[] for _ in range(b)]  # cache pins
        # Mid-prefill cursors of chunked prefills: {"req", "tokens",
        # "cursor"} per slot, None otherwise.
        self._slot_prefill_state: List[Optional[dict]] = [None] * b
        self._next_tok = np.zeros((b,), np.int64)     # host mirror
        self._next_tok_dev = None
        self._tok_dirty = True
        self._phases = np.full((b,), chai_cache.PHASE_FREE, np.int32)
        # Per-slot SamplingParams on the host (FREE slots sample greedily;
        # their tokens are never recorded).
        self._samp_host = sampling_mod.knob_vectors(b)
        self._sampler = steps_mod.make_sampler()
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
            self._suffix_prefill = steps_mod.make_paged_suffix_prefill(cfg,
                                                                       s)
            self._reset_slot = steps_mod.make_paged_slot_reset(cfg)
            self._restore_snapshot = steps_mod.make_snapshot_restore(cfg)
            self._copy_page = {kind: steps_mod.make_page_copy(cfg, kind)
                               for kind in ("dense", "chai")}
            # the tiers' one-page demotion read and promotion write
            kinds = ("dense", "chai") if self.chai_clustered else ("dense",)
            self._fetch_page = {k: steps_mod.make_page_fetch(cfg, k)
                                for k in kinds}
            self._put_page = {k: steps_mod.make_page_put(cfg, k)
                              for k in kinds}
            self._swap_out, self._swap_in = steps_mod.make_slot_swap(cfg)
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
        # Relay decode: host caches keyed by a version of the clustering
        # context, which moves only at CLUSTER transitions and snapshot
        # restores, so the row maps are rebuilt only then.
        self._ctx_version = 0
        self._ctx_host_cache = None    # (version, {name: np.ndarray})
        self._relay_rows_cache = None  # (key, {k_row, a_row, v_row})
        self.relay_steps = 0           # decode steps that ran the relay
        self.relay_grouped_slots = 0   # cumulative grouped-slot count
        if self.relay_decode:
            self._relay_step = steps_mod.make_relay_step(cfg, decode_ts=ts)

    # -- public API --------------------------------------------------------
    def default_sampling(self) -> SamplingParams:
        return (SamplingParams() if self.ecfg.greedy
                else SamplingParams(temperature=1.0))

    def add_request(self, prompt, sampling: Optional[SamplingParams] = None,
                    *, max_new_tokens: Optional[int] = None, uid=None,
                    arrival_delay: float = 0.0,
                    priority: int = 0) -> Request:
        """Enqueue a request with its ``SamplingParams``. ``max_new_tokens``
        (when given) overrides ``sampling.max_new_tokens``;
        ``arrival_delay`` (seconds from now) models open-loop arrivals.
        ``priority``: the preemption class; under page or slot pressure a
        strictly higher-priority arrival may reclaim a running
        lower-priority slot (``EngineConfig.preemption``). Default uids
        come from a monotonic engine counter. A request beyond
        ``max_seq``, or with stop strings on an engine without a
        detokenizer, raises ``ValidationError`` (a ``ValueError``)."""
        sp = sampling if sampling is not None else self.default_sampling()
        max_new = (max_new_tokens if max_new_tokens is not None
                   else sp.max_new_tokens)
        if len(prompt) + max_new > self.ecfg.max_seq:
            raise ValidationError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new}) "
                f"exceeds max_seq ({self.ecfg.max_seq})", uid=uid)
        if sp.stop and self.detokenizer is None:
            raise ValidationError(
                "SamplingParams.stop strings need an engine detokenizer "
                "(EngineCore(detokenizer=...))", uid=uid)
        if uid is None:
            uid = self._uid_counter
        self._uid_counter = max(self._uid_counter, int(uid) + 1)
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new, sampling=sp,
                      priority=int(priority))
        req.t_enqueue = time.time()
        req.t_arrival = req.t_enqueue + arrival_delay
        req.generated = []
        self.queue.append(req)
        self._requests[uid] = req
        if (self.paged and self.ecfg.kv_offload and self.ecfg.tier_prefetch
                and self.prefix_cache is not None):
            # Admission-time prefetch: queue the demoted entries this
            # prompt will hit for promotion ahead of the planning step.
            self._queue_prefetch(req)
        if self.tel.enabled:
            self.tel.counter("requests_submitted_total",
                             help="Requests enqueued via add_request")
            self.tel.gauge("engine_queue_depth", len(self.queue),
                           help="Requests waiting in the arrival queue")
            self.tel.event(req.uid, "enqueue", t=req.t_enqueue,
                           prompt_tokens=int(len(req.prompt)),
                           max_new_tokens=int(max_new),
                           priority=int(priority))
        return req

    def _done(self, req: Request):
        """Finalize a request: move it to ``done`` and drop its abort
        lookup entry, so a long-lived core holds nothing per request
        served but ``done``, which ``reap_done()`` empties."""
        self.done.append(req)
        if self._requests.get(req.uid) is req:
            del self._requests[req.uid]
        if self.tel.enabled:
            self._tel_finish(req)

    def reap_done(self) -> List[Request]:
        """Return and clear the finished-request list (the ``LLM`` front
        door calls it after collecting its outputs; ``ServingEngine.run``
        lets ``done`` accumulate)."""
        out, self.done = self.done, []
        return out

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
            self._free_resume(req)      # a swapped-out victim's host pages
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

    def next_arrival(self) -> Optional[float]:
        """Earliest queued arrival time (a caller sleeps until it when
        ``step()`` makes no progress), or None with the queue empty."""
        return self.queue[0].t_arrival if self.queue else None

    def step(self) -> List[StepOutput]:
        """Run exactly ONE scheduler iteration: forward one chunk of every
        mid-prefill slot, admit arrived requests into free slots, run
        CLUSTER transitions for slots whose warmup just completed, one
        batched decode over the slots past prefill, and retire slots that
        hit a finish condition. Returns one ``StepOutput`` per request that
        emitted tokens; ``[]`` when there is no admissible work. With the
        engine idle and the queue head beyond the pools' capacity, raises
        ``CapacityError`` (a ``MemoryError``, carrying the uid).
        Request-isolatable failures never raise: the request is
        quarantined (a typed ``StepOutput`` with ``finish_reason="error"``)
        and the batch keeps running. ``EngineConfig.audit_level`` gates an
        invariant audit after the iteration; a violation raises
        ``EngineFault``."""
        if self.ecfg.scheduler != "continuous":
            raise RuntimeError("step() drives the continuous scheduler; "
                               "cohort engines run via run()")
        tel = self.tel
        if tel.enabled:
            t0 = time.perf_counter()
        with tel.span("step", step=self._step_calls):
            outs = self._step_inner()
        if self.ecfg.audit_level != "off":
            self.audit_steps += 1
            with tel.span("audit", step=self._span_step):
                vio = invariants_mod.audit(
                    self, deep=self.ecfg.audit_level == "deep")
            if vio:
                raise EngineFault(f"invariant audit failed at step "
                                  f"{self.steps_executed}", violations=vio)
        if tel.enabled:
            tel.observe("engine_step_seconds", time.perf_counter() - t0,
                        help="Wall time of one step() iteration")
            tel.counter("engine_steps_total",
                        help="step() iterations executed")
            tel.gauge("engine_queue_depth", len(self.queue),
                      help="Requests waiting in the arrival queue")
            tel.gauge("engine_active_slots",
                      sum(1 for r in self._slot_req if r is not None),
                      help="Batch slots holding a live request")
        return outs

    def _step_inner(self) -> List[StepOutput]:
        outs: List[StepOutput] = []
        self._ensure_dev_state()
        if self._prefetch_q:
            self._drain_prefetch()
        self._fault_blocked = False
        tel = self.tel
        self._span_step = self._step_calls
        self._step_calls += 1
        self._advance_prefills(outs)
        drained = False
        while True:
            with tel.span("admit", step=self._span_step):
                blocked = self._admit(outs)
            active = [i for i in range(self.ecfg.batch_slots)
                      if self._slot_req[i] is not None
                      and self._phases[i] != chai_cache.PHASE_PREFILL]
            if active:
                break
            if self.has_active:
                return outs        # only mid-prefill slots: progress made
            if not (self.queue and blocked):
                return outs        # idle, or waiting on future arrivals
            if self._fault_blocked:
                return outs        # injected transient: retry next step
            # The plan failed with the engine idle: drain the prefix cache
            # and retry once; only if even an empty cache cannot cover the
            # request is it impossible.
            if not drained and self.prefix_cache is not None and (
                    self.prefix_cache.num_blocks
                    or self.prefix_cache.num_snapshots):
                self.prefix_cache.clear()
                drained = True
                continue
            head = self.queue[0]
            n = self._pages_for(head)
            raise CapacityError(
                f"request uid={head.uid} needs {2 * n} dense and "
                f"{self._chai_pages_per(n)} clustered pages; pool "
                f"capacities {self.dense_pool.capacity} and "
                f"{self.chai_pool.capacity if self.chai_pool else 0}",
                uid=head.uid)
        with tel.span("cluster", step=self._span_step):
            self._cluster_transitions(active, outs)
        # A kernel.cluster quarantine may have retired slots mid-list.
        active = [i for i in active if self._slot_req[i] is not None]
        if active:
            outs.extend(self._decode(active))
        return outs

    # -- fault injection / quarantine ---------------------------------------
    def _fault(self, site: str, uid: int = -1):
        """Consult the fault injector at a named site; None when no
        injector is armed or nothing fires."""
        if self.faults is None:
            return None
        spec = self.faults.fire(site, step=self.steps_executed, uid=uid)
        if spec is not None and self.tel.enabled:
            self.tel.counter("faults_injected_total", site=site,
                             mode=spec.mode,
                             help="Injected faults that fired, by site")
        return spec

    def _quarantine_queued(self, req: Request, err: RequestError,
                           outs: List[StepOutput]):
        """Typed-fail a request that is still queued (or was just popped):
        no device state to unwind; record the error and finish it."""
        if req in self.queue:
            self.queue.remove(req)
        self._free_resume(req)      # a swapped-out victim's host pages
        req.finish_reason = sampling_mod.FINISH_ERROR
        req.error = str(err)
        req.t_done = time.time()
        req.retire_step = self.steps_executed
        self.quarantined += 1
        if self.tel.enabled:
            self.tel.event(req.uid, "quarantine", reason=str(err))
        self._done(req)
        outs.append(StepOutput(req.uid, [], True,
                               sampling_mod.FINISH_ERROR))

    def _abort_admission(self, i: int, req: Request, gen0: int,
                         hit0: tuple):
        """Unwind a failed ``_admit_to_slot``: free the plan's pages and
        locks refcount-exactly, reset the slot on the device, and rewind
        the request's progress records to their pre-admission values."""
        self._slot_prefill_state[i] = None
        self._phases[i] = chai_cache.PHASE_FREE
        self._slot_count[i] = 0
        self._dev_state = self._reset_slot(self._dev_state, i)
        self._free_pages(self._slot_pages[i])
        if self._slot_locked[i]:
            self.prefix_cache.unlock(self._slot_locked[i])
            self._slot_locked[i] = []
        req.generated = req.generated[:gen0]
        req.cache_hit, req.cached_tokens, req.prefill_tokens = hit0

    # -- telemetry hooks (every caller guards on self.tel.enabled) ---------
    def _tel_admit(self, i: int, req: Request, plan: dict, resumed: bool):
        """Admission succeeded: labeled admit counter (kind "swap" for a
        preempted request's return), queue-wait histogram, cache-hit token
        counters, timeline event ("resume" for a return)."""
        tel = self.tel
        kind = "swap" if resumed else plan["kind"]
        tel.counter("requests_admitted_total", kind=kind,
                    help="Slot admissions by plan kind")
        tel.observe("request_queue_seconds",
                    max(0.0, time.time() - req.t_enqueue),
                    help="Enqueue-to-admission wait")
        tel.event(req.uid, "resume" if resumed else "admit", slot=i,
                  kind=kind, step=self.steps_executed,
                  cached_tokens=int(req.cached_tokens))
        if req.cache_hit == "prefix":
            tel.counter("prefix_hit_tokens_total", req.cached_tokens,
                        help="Prompt tokens served from the radix cache")
        elif req.cache_hit == "snapshot":
            tel.counter("snapshot_hit_tokens_total", req.cached_tokens,
                        help="Prompt tokens served from CHAI snapshots")
            # A snapshot admission lands in STEADY with its warmup tokens
            # emitted: its first token happened here.
            if req.generated and req.t_first_token:
                tel.event(req.uid, "first_token", t=req.t_first_token)
                tel.observe("request_ttft_seconds",
                            max(0.0, req.t_first_token - req.t_enqueue),
                            help="Enqueue-to-first-token latency")
                tel.counter("tokens_generated_total", len(req.generated),
                            help="Generated tokens emitted")
                tel.token(req.uid, n=len(req.generated),
                          t=req.t_first_token)

    def _tel_finish(self, req: Request):
        """A request reached a terminal state (retire, abort, quarantine,
        replay): reason-labeled counter, latency histogram, timeline
        seal."""
        tel = self.tel
        reason = req.finish_reason or "unknown"
        tel.counter("requests_finished_total", reason=reason,
                    help="Requests finished, by finish_reason")
        if req.error:
            tel.counter("requests_quarantined_total",
                        help="Requests typed-failed and quarantined")
        if req.t_done and req.t_enqueue:
            tel.observe("request_latency_seconds",
                        max(0.0, req.t_done - req.t_enqueue),
                        help="Enqueue-to-completion latency")
        data = {"reason": reason,
                "tokens": len(req.generated or ()),
                "preemptions": int(req.preemptions)}
        if req.error:
            data["error"] = req.error
        if req.cache_hit:
            data["cache_hit"] = req.cache_hit
        tel.event(req.uid, "finish", t=req.t_done or None, **data)
        tel.finish(req.uid)

    def _tel_clusters(self, i: int):
        """Per-layer cluster-count gauges from slot ``i``'s membership,
        copied to the host here: once per CLUSTER transition, never on a
        decode step."""
        help_ = ("Clusters per attention layer at the latest CLUSTER "
                 "transition")
        if "h2c" in self._dev_ctx:                  # MHA: (nA, H)
            h2c = self._dev_ctx["h2c"][:, i].cpu().numpy()
            for layer in range(h2c.shape[0]):
                self.tel.gauge("chai_clusters", len(np.unique(h2c[layer])),
                               layer=layer, help=help_)
        elif "cluster_of" in self._dev_ctx:         # GQA: (nA, KV, qpk)
            co = self._dev_ctx["cluster_of"][:, i].cpu().numpy()
            for layer in range(co.shape[0]):
                n = sum(int(len(np.unique(co[layer, g])))
                        for g in range(co.shape[1]))
                self.tel.gauge("chai_clusters", n, layer=layer, help=help_)

    def _refresh_gauges(self):
        """Point-in-time gauges recomputed at scrape time."""
        tel = self.tel
        tel.gauge("engine_queue_depth", len(self.queue),
                  help="Requests waiting in the arrival queue")
        tel.gauge("engine_active_slots",
                  sum(1 for r in self._slot_req if r is not None),
                  help="Batch slots holding a live request")
        tel.gauge("engine_degraded_decode", int(self.degraded_decode),
                  help=_DEGRADED_HELP)
        if self.paged:
            tel.gauge("kv_bytes_allocated", self.kv_bytes(),
                      help="Allocated KV bytes right now")
            tel.gauge("dense_pages_in_use", self.dense_pool.pages_in_use,
                      help="Dense-pool pages in use")
            if self.chai_pool is not None:
                tel.gauge("chai_pages_in_use",
                          self.chai_pool.pages_in_use,
                          help="Clustered-pool pages in use")
            if self.tiers is not None:
                help_tier = "KV pages resident per tier and pool kind"
                tel.gauge("kv_tier_pages", self.dense_pool.pages_in_use,
                          tier="hot", kind="dense", help=help_tier)
                if self.chai_pool is not None:
                    tel.gauge("kv_tier_pages",
                              self.chai_pool.pages_in_use,
                              tier="hot", kind="chai", help=help_tier)
                for (tier, kind), n in self.tiers.tier_pages().items():
                    tel.gauge("kv_tier_pages", n, tier=tier, kind=kind,
                              help=help_tier)

    def metrics(self):
        """JSON-ready metrics snapshot (the point-in-time gauges refreshed
        first); None at telemetry "off"."""
        if not self.tel.enabled:
            return None
        self._refresh_gauges()
        return self.tel.snapshot()

    def metrics_text(self):
        """Prometheus text exposition of ``metrics()`` (None at "off")."""
        snap = self.metrics()
        return None if snap is None else exporters_mod.to_prometheus(snap)

    def request_timeline(self, uid):
        """One request's lifecycle timeline (events and the derived TTFT /
        ITL / queue summary); None when unknown or at "off"."""
        return self.tel.timeline(uid)

    def step_trace(self):
        """Chrome-trace JSON object of the recorded step spans (empty below
        the "trace" tier)."""
        return exporters_mod.to_chrome_trace(self.tel.spans)

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

    def _sample_first(self, logits, req: Request) -> int:
        """A request's first token from its prefill logits (count 0, the
        draw the cohort scheduler makes for its row)."""
        sp = req.sampling
        if sp.greedy:
            return int(self._argmax(logits)[0])
        return int(self._sampler(logits, [sp.temperature], [sp.top_k],
                                 [sp.top_p], [np.uint32(sp.seed)], [0])[0])

    def _finish_of(self, req: Request) -> str:
        return sampling_mod.finish_reason(req.generated, req.sampling,
                                          req.max_new_tokens,
                                          self.detokenizer)

    # -- paged-pool bookkeeping (host side) --------------------------------
    def _pages_for(self, req) -> int:
        """Logical pages a request can touch over its lifetime."""
        n = chai_cache.pages_needed(
            len(req.prompt) + req.max_new_tokens, self.ecfg.page_size)
        return min(n, self._slot_pages_max)

    def _chai_pages_per(self, n: int) -> int:
        """Clustered pages of a request of ``n`` logical pages: its K, and
        under share_values its V too."""
        if not self.chai_clustered:
            return 0
        return n * (2 if self.cfg.chai.share_values else 1)

    def _alloc_chai(self, pages: dict, n: int):
        """Reserve ``n`` clustered K pages (and V pages, share_values)."""
        pages["kc"] = self.chai_pool.alloc(n)
        if self.cfg.chai.share_values:
            pages["vc"] = self.chai_pool.alloc(n)

    def _alloc_pages(self, n: int) -> dict:
        """Allocate a cold request's ``n`` dense K and V pages and reserve
        its clustered pages, so the CLUSTER transition can never stall
        mid-flight (the caller checked the pools can cover them)."""
        pages = {"kg": self.dense_pool.alloc(n),
                 "vg": self.dense_pool.alloc(n)}
        if self.chai_clustered:
            self._alloc_chai(pages, n)
        return pages

    def _free_pages(self, pages: dict):
        for key, pool in (("kg", self.dense_pool), ("vg", self.dense_pool),
                          ("kc", self.chai_pool), ("vc", self.chai_pool)):
            if key in pages:
                pool.free(pages.pop(key))

    def _page_vec(self, pages):
        """Null-padded (P,) int32 device vector of a page list."""
        vec = np.zeros((self._slot_pages_max,), np.int32)
        vec[:len(pages)] = pages
        return torch.from_numpy(vec).to(self.device)

    def _page_ids(self, pages):
        """(len(pages),) int64 device vector of a page list, unpadded."""
        return torch.tensor(list(pages), dtype=torch.long,
                            device=self.device)

    # -- prefix-cache admission planning (host side) -----------------------
    def _eligible_snapshot(self, req):
        """The CHAI snapshot of ``req``'s full prompt, if the snapshot fast
        path applies: paged, cache on, clustered CHAI, a greedy request
        with no tokens yet."""
        if req.generated:
            return None
        if (self.prefix_cache is not None and self.chai_clustered
                and req.sampling.greedy):
            return self.prefix_cache.snapshot_for(req.prompt)
        return None

    def _pool_space(self, dense_need: int, chai_need: int) -> bool:
        """True when the pools can cover the request, evicting unlocked
        prefix-cache entries (LRU) if that is what it takes."""
        ok = (self.dense_pool.free_pages >= dense_need
              and (not chai_need
                   or self.chai_pool.free_pages >= chai_need))
        if ok or self.prefix_cache is None:
            return ok
        return self.prefix_cache.evict_until(dense_free=dense_need,
                                             chai_free=chai_need)

    def _plan_admission(self, req):
        """An admission plan for the queue head, allocating and increfing
        pool pages and locking the cache entries it aliases; None when the
        pools cannot cover the request yet. Kinds: "cold" (no reuse),
        "prefix" (the longest cached block prefix aliased, the suffix
        prefilled), "snapshot" (full prompt cached with a CHAI snapshot:
        STEADY directly), "swap" (a preempted request: fresh pages for
        what its slot held, restored bit for bit, no prefill). A snapshot
        that covers the whole budget is replayed by ``_admit`` before
        planning. The ``pool.alloc`` site blocks the plan (``transient``)
        or raises ``QuarantineError``."""
        if not self.paged:
            return {"kind": "cold", "pages": {}, "locked": []}
        spec = self._fault("pool.alloc", uid=req.uid)
        if spec is not None:
            if spec.mode == "error":
                raise QuarantineError(
                    f"injected allocator failure for uid={req.uid}",
                    uid=req.uid)
            self._fault_blocked = True
            return None     # transient: the plan retries next step
        if req.resume_state is not None:
            return self._plan_swap_in(req)
        cache = self.prefix_cache
        snap = self._eligible_snapshot(req)
        if snap is not None:
            plan = self._plan_snapshot(req, snap)
            if plan is _REPLAN:
                # A demoted snapshot failed promotion and was dropped: plan
                # again (bounded: each re-plan removed a cache entry).
                return self._plan_admission(req)
            return plan
        matched = cache.match(req.prompt) if cache is not None else []
        if matched:
            plan = self._plan_prefix(req, matched)
            if plan is _REPLAN:
                return self._plan_admission(req)
            return plan
        n = self._pages_for(req)
        if not self._pool_space(2 * n, self._chai_pages_per(n)):
            return None        # even LRU eviction cannot cover it yet
        return {"kind": "cold", "pages": self._alloc_pages(n), "locked": []}

    def _plan_swap_in(self, req):
        """Fresh pages matching what the preempted slot held, kind by kind
        (a clustered STEADY victim holds no dense K page); the swap-in
        restores the saved contents into them. Never more pages than the
        request's first admission, so a request admitted once can always
        be planned again."""
        want = req.resume_state["npages"]
        if not self._pool_space(want["kg"] + want["vg"],
                                want["kc"] + want["vc"]):
            return None
        pages = {}
        for key, pool in (("kg", self.dense_pool), ("vg", self.dense_pool),
                          ("kc", self.chai_pool), ("vc", self.chai_pool)):
            if want[key]:
                pages[key] = pool.alloc(want[key])
        return {"kind": "swap", "pages": pages, "locked": []}

    def _plan_prefix(self, req, matched):
        """Alias the ``matched`` block pages; allocate fresh pages for the
        suffix and the generation headroom (and the full clustered
        reservation, as on the cold path)."""
        cache = self.prefix_cache
        n = self._pages_for(req)
        n_m = min(len(matched), n)
        matched = matched[:n_m]
        chai_n = self._chai_pages_per(n)
        cache.lock(matched)     # pin before eviction can run
        demoted = [m for m in matched if m.tier != kv_tiers_mod.TIER_HOT]
        for m in matched:
            if m.prefetched:
                m.prefetched = False
                self._count_prefetch(hit=True)
        # Each promoted node needs 2 fresh dense pages on top of the
        # suffix's.
        if not self._pool_space(2 * (n - n_m) + 2 * len(demoted), chai_n):
            cache.unlock(matched)
            return None
        for m in demoted:
            if self.ecfg.tier_prefetch and self.ecfg.kv_offload:
                self._count_prefetch(hit=False)
            if not self._promote_entry(m, uid=req.uid):
                cache.unlock(matched)   # dropped entries stay dropped
                return _REPLAN
        kg_fresh = self.dense_pool.alloc(n - n_m)
        vg_fresh = self.dense_pool.alloc(n - n_m)
        kg_alias = [m.kg_page for m in matched]
        vg_alias = [m.vg_page for m in matched]
        self.dense_pool.incref(kg_alias)
        self.dense_pool.incref(vg_alias)
        pages = {"kg": kg_alias + kg_fresh, "vg": vg_alias + vg_fresh}
        if self.chai_clustered:
            self._alloc_chai(pages, n)
        null = [chai_cache.NULL_PAGE] * n_m
        return {"kind": "prefix", "pages": pages, "locked": matched,
                "prefix_len": n_m * self.ecfg.page_size,
                "scatter_kg": null + kg_fresh,
                "scatter_vg": null + vg_fresh}

    def _plan_snapshot(self, req, snap):
        """Resume from a CHAI snapshot: share its full pages, copy its
        partial tail page (copy-on-write), allocate headroom for the rest
        of the generation, and enter STEADY directly. Under share_values
        the V pages are clustered ones too (no dense page at all)."""
        cache = self.prefix_cache
        share = self.cfg.chai.share_values
        n = self._pages_for(req)
        p_full, rem = divmod(snap.pos, self.ecfg.page_size)
        cache.lock([snap])
        if snap.prefetched:
            snap.prefetched = False
            self._count_prefetch(hit=True)
        extra_d = extra_c = 0
        if snap.tier != kv_tiers_mod.TIER_HOT:
            extra_d = len(snap.tier_pages.get("vg", ()))
            extra_c = (len(snap.tier_pages.get("kc", ()))
                       + len(snap.tier_pages.get("vc", ())))
        if not self._pool_space((0 if share else n - p_full) + extra_d,
                                self._chai_pages_per(n - p_full) + extra_c):
            cache.unlock([snap])
            return None
        if snap.tier != kv_tiers_mod.TIER_HOT:
            if self.ecfg.tier_prefetch and self.ecfg.kv_offload:
                self._count_prefetch(hit=False)
            if not self._promote_entry(snap, uid=req.uid):
                cache.unlock([snap])    # dropped: re-plan cold
                return _REPLAN
        copies = []     # (pool kind, src physical page, dst physical page)
        pages = {}
        for key, kind, pool, held in (
                ("kc", "chai", self.chai_pool, snap.kc_pages),
                ("vc", "chai", self.chai_pool, snap.vc_pages) if share
                else ("vg", "dense", self.dense_pool, snap.vg_pages)):
            fresh = pool.alloc(n - p_full)
            pool.incref(held[:p_full])
            pages[key] = held[:p_full] + fresh
            if rem:
                copies.append((kind, held[p_full], fresh[0]))
        return {"kind": "snapshot", "snapshot": snap, "pages": pages,
                "locked": [snap], "copies": copies}

    def _replay_request(self, req, snap):
        """Serve a request entirely from a CHAI snapshot's warmup tokens:
        no slot, no pages, no device work."""
        toks, reason = sampling_mod.scan_finish(
            snap.tokens[:req.max_new_tokens], req.sampling,
            req.max_new_tokens, self.detokenizer)
        req.generated = toks
        req.finish_reason = reason or sampling_mod.FINISH_LENGTH
        req.cache_hit = "replay"
        req.cached_tokens = len(req.prompt)
        req.prefill_tokens = 0
        req.t_first_token = time.time()
        req.t_done = time.time()
        req.admit_step = req.retire_step = self.steps_executed
        self.prefix_cache.stats["snapshot_hits"] += 1
        self.prefix_cache.stats["tokens_reused"] += len(req.prompt)
        if self.tel.enabled:
            tel = self.tel
            tel.counter("requests_admitted_total", kind="replay",
                        help="Slot admissions by plan kind")
            tel.counter("snapshot_hit_tokens_total", len(req.prompt),
                        help="Prompt tokens served from CHAI snapshots")
            tel.event(req.uid, "admit", kind="replay", slot=-1,
                      step=self.steps_executed,
                      cached_tokens=int(req.cached_tokens))
            tel.event(req.uid, "first_token", t=req.t_first_token)
            tel.observe("request_ttft_seconds",
                        max(0.0, req.t_first_token - req.t_enqueue),
                        help="Enqueue-to-first-token latency")
            tel.counter("tokens_generated_total", len(toks),
                        help="Generated tokens emitted")
            tel.token(req.uid, n=len(toks), t=req.t_first_token)
        self._done(req)

    def _capture_snapshot(self, slot, req, pages):
        """Capture the slot's STEADY-entry state (membership, clustered K
        pages, dense V pages or, under share_values, clustered V pages,
        warmup tokens) keyed by its full prompt. Full pages are shared
        (incref); the partial tail page, which the running slot keeps
        writing, is copied. Skipped when the pools cannot spare the
        copies."""
        cache = self.prefix_cache
        key = tuple(int(t) for t in req.prompt)
        if cache.snapshot_for(key) is not None:
            return
        share = self.cfg.chai.share_values
        warm = self.cfg.chai.warmup_tokens
        pos_steady = len(req.prompt) + warm
        p_full, rem = divmod(pos_steady, self.ecfg.page_size)
        n_copy = 1 if rem else 0
        if not self._pool_space(0 if share else n_copy,
                                self._chai_pages_per(n_copy)):
            return
        held = {"vg": [], "kc": [], "vc": []}
        for name, kind, pool in (
                ("kc", "chai", self.chai_pool),
                ("vc", "chai", self.chai_pool) if share
                else ("vg", "dense", self.dense_pool)):
            held[name] = list(pages[name][:p_full])
            pool.incref(held[name])
            if rem:
                [dst] = pool.alloc(1)
                self._dev_state = self._copy_page[kind](
                    self._dev_state, pages[name][p_full], dst)
                held[name].append(dst)
        slot_ctx = {k: np.array(v[:, slot].cpu())      # a copy: the ctx
                    for k, v in self._dev_ctx.items()}   # is updated in place
        cache.add_snapshot(ChaiSnapshot(
            prompt=key, pos=pos_steady,
            tokens=list(req.generated[:warm + 1]), ctx=slot_ctx,
            vg_pages=held["vg"], kc_pages=held["kc"],
            vc_pages=held["vc"]))

    def _record_kv_bytes(self):
        bytes_now = self.kv_bytes()
        self._kv_peak = max(self._kv_peak, bytes_now)
        if self.tel.enabled:
            self.tel.gauge("kv_bytes_allocated", bytes_now,
                           help="Allocated KV bytes right now")
            self.tel.gauge("dense_pages_in_use",
                           self.dense_pool.pages_in_use,
                           help="Dense-pool pages in use")
            if self.chai_pool is not None:
                self.tel.gauge("chai_pages_in_use",
                               self.chai_pool.pages_in_use,
                               help="Clustered-pool pages in use")
        if len(self.kv_bytes_history) >= self._HISTORY_MAX:
            return
        phases = self._phases
        rec = {
            "step": self.steps_executed,
            "kv_bytes": bytes_now,
            "dense_pages": self.dense_pool.pages_in_use,
            "chai_pages": (self.chai_pool.pages_in_use
                           if self.chai_pool else 0),
            "n_warmup": int((phases == chai_cache.PHASE_WARMUP).sum()),
            "n_steady": int((phases == chai_cache.PHASE_STEADY).sum()),
        }
        if self.tiers is not None:
            tb = self.tiers.tier_bytes()
            rec["host_bytes"] = tb.get(kv_tiers_mod.TIER_HOST, 0)
            rec["compressed_bytes"] = tb.get(kv_tiers_mod.TIER_COMP, 0)
        self.kv_bytes_history.append(rec)

    # -- KV tier ops (demote / promote / prefetch) -------------------------
    def _tel_tier_transition(self, frm: str, to: str, kind: str, n: int):
        """TierManager transition callback -> Prometheus counter."""
        if self.tel.enabled:
            self.tel.counter("tier_transitions_total", n,
                             help="KV page transitions between tiers",
                             **{"from": frm, "to": to})

    def _count_prefetch(self, hit: bool):
        if hit:
            self.prefetch_hits += 1
            if self.tel.enabled:
                self.tel.counter(
                    "prefetch_hits_total",
                    help="Demoted entries promoted before the planner "
                         "needed them")
        else:
            self.prefetch_misses += 1
            if self.tel.enabled:
                self.tel.counter(
                    "prefetch_misses_total",
                    help="Demoted entries promoted synchronously at plan "
                         "time")

    @staticmethod
    def _entry_device_pages(entry) -> dict:
        """Device pages an entry owns, by pool key (kg/vg/kc/vc)."""
        if isinstance(entry, BlockNode):
            return {"kg": [entry.kg_page], "vg": [entry.vg_page]}
        return {pk: list(pages) for pk, pages in (
            ("vg", entry.vg_pages), ("kc", entry.kc_pages),
            ("vc", entry.vc_pages)) if pages}

    def _demote_entry(self, entry) -> bool:
        """Move an unlocked prefix-cache entry's device pages to the host
        tier; ``PrefixCache._evict_one`` calls it under device pool
        pressure (the victim already off its LRU). False: the cache drops
        the entry instead. The pages land on the host (one gather and one
        non-blocking copy a page, then one event synchronized before the
        CRC reads them) BEFORE the device references are released, so a
        False return never loses data."""
        if self.tiers is None or self._dev_state is None:
            return False
        spec = self._fault("offload.out")
        if spec is not None and spec.mode != "corrupt":
            return False  # demotion declined: a plain drop
        refs = self._entry_device_pages(entry)
        need = {}
        for pk, pages in refs.items():
            kind = kv_tiers_mod.POOL_OF[pk]
            need[kind] = need.get(kind, 0) + len(pages)
        if not self.tiers.make_room(need):
            return False
        if any(kv_tiers_mod.POOL_OF[pk] not in self._fetch_page
               for pk in refs):
            return False
        take = self.tiers.slabs.take
        payloads = {pk: [self._fetch_page[kv_tiers_mod.POOL_OF[pk]](
                        self._dev_state, p, take) for p in pages]
                    for pk, pages in refs.items()}
        if self.device.type == "cuda":
            landed = torch.cuda.Event()
            landed.record()
            landed.synchronize()
        self.tiers.store_entry(entry, payloads)
        if spec is not None:
            # Damage the stored host copy AFTER the CRC stamp, so that
            # promotion catches it; the damaged bytes go back into the
            # host pages' own buffers.
            tree = {pk: {str(j): dict(p) for j, p in enumerate(pl)}
                    for pk, pl in payloads.items()}
            faults_mod.corrupt_arrays(tree, seed=self.faults.seed)
            for pk, pl in payloads.items():
                for j, p in enumerate(pl):
                    for key, buf in p.items():
                        buf.copy_(tree[pk][str(j)][key])
        # The host copy is safe: release the device references.
        for pk, pages in refs.items():
            kind = kv_tiers_mod.POOL_OF[pk]
            pool = self.dense_pool if kind == "dense" else self.chai_pool
            pool.free(pages)
            self.tiers.record("hot", "host", kind, len(pages))
        if isinstance(entry, ChaiSnapshot):  # page ids now live in
            entry.vg_pages = []              # entry.tier_pages
            entry.kc_pages = []
            entry.vc_pages = []
        return True

    def _promote_entry(self, entry, *, uid: int = -1) -> bool:
        """Bring a demoted entry back into fresh device pages (the caller
        checked the pools' headroom first). Each page goes to the device
        in one copy and into its pool slice in one more, on the engine's
        stream. False, with the entry DROPPED, on a checksum mismatch, an
        injected ``offload.in`` fault, or a compressed entry while
        ``lossy_promote`` is off: the caller re-plans the request cold."""
        cache = self.prefix_cache
        t0 = time.perf_counter()
        frm = entry.tier
        if frm == kv_tiers_mod.TIER_COMP and not self.ecfg.lossy_promote:
            cache.drop_demoted(entry)
            return False
        failed = self._fault("offload.in", uid) is not None
        if not failed and not self.tiers.verify_entry(entry):
            self.offload_checksum_failures += 1
            failed = True
        if failed:
            cache.drop_demoted(entry)
            return False
        payloads = self.tiers.fetch_entry(entry)
        new_pages = {}
        for pk, pl in payloads.items():
            kind = kv_tiers_mod.POOL_OF[pk]
            pool = self.dense_pool if kind == "dense" else self.chai_pool
            pages = pool.alloc(len(pl))
            for p, payload in zip(pages, pl):
                self._dev_state = self._put_page[kind](self._dev_state, p,
                                                       payload)
            new_pages[pk] = pages
        self.tiers.release_entry(entry)
        if isinstance(entry, BlockNode):
            entry.kg_page = new_pages["kg"][0]
            entry.vg_page = new_pages["vg"][0]
            cache.stats["promoted_blocks"] += 1
        else:
            entry.vg_pages = new_pages.get("vg", [])
            entry.kc_pages = new_pages.get("kc", [])
            entry.vc_pages = new_pages.get("vc", [])
            cache.stats["promoted_snapshots"] += 1
        entry.tier = kv_tiers_mod.TIER_HOT
        entry.tier_crc = 0
        for pk, pages in new_pages.items():
            self.tiers.record(frm, "hot", kv_tiers_mod.POOL_OF[pk],
                              len(pages))
        cache._lru_file(entry)  # a no-op while the entry is locked
        if self.tel.enabled:
            self.tel.observe("promote_wait_seconds",
                             time.perf_counter() - t0,
                             help="Host->device promotion latency")
        return True

    def _queue_prefetch(self, req: Request):
        """At enqueue, look up the demoted prefix-cache entries this prompt
        will hit and queue them for promotion ahead of the planning step
        (``_drain_prefetch``)."""
        cache = self.prefix_cache
        snap = self._eligible_snapshot(req)
        if snap is not None and snap.tier != kv_tiers_mod.TIER_HOT:
            targets = [snap]
        else:
            targets = [m for m in cache.match(req.prompt)
                       if m.tier != kv_tiers_mod.TIER_HOT]
        for e in targets:
            if id(e) in self._prefetch_ids or e.prefetched:
                continue
            self._prefetch_ids.add(id(e))
            self._prefetch_q.append(e)

    def _drain_prefetch(self, budget: int = 4):
        """Promote up to ``budget`` queued entries into free device pages.
        Never evicts to make room: with the pools full the queue waits
        (the planners' synchronous promotion still covers the hit)."""
        while self._prefetch_q and budget > 0:
            e = self._prefetch_q.popleft()
            self._prefetch_ids.discard(id(e))
            if (e.tier == kv_tiers_mod.TIER_HOT
                    or getattr(e, "evicted", False) or e.locks):
                continue
            if (e.tier == kv_tiers_mod.TIER_COMP
                    and not self.ecfg.lossy_promote):
                continue
            counts = self.tiers._entry_page_counts(e)
            dense_need = counts.get("dense", 0)
            chai_need = counts.get("chai", 0)
            if (self.dense_pool.free_pages < dense_need
                    or (chai_need and self.chai_pool.free_pages
                        < chai_need)):
                self._prefetch_q.appendleft(e)
                self._prefetch_ids.add(id(e))
                return
            if self._promote_entry(e):
                e.prefetched = True
            budget -= 1

    def _free_resume(self, req: Request):
        """Release the host pages of a preempted request's swapped-out
        slot (its abort or quarantine while it waits in the queue)."""
        rs = req.resume_state
        if not rs or not rs.get("tier_pages"):
            return
        for pk, pages in rs["tier_pages"].items():
            kind = kv_tiers_mod.POOL_OF[pk]
            self.tiers.free_pages(kind, pages)
            self.tiers.record("host", "gone", kind, len(pages))
        rs["tier_pages"] = {}

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
        budget covers prompt + generation headroom (prefix-cache hits
        alias shared pages and need fewer). When the head outranks a
        running request and no slot, or no page budget, can take it, the
        lowest-priority slot is preempted and the plan retried. A
        preempted request's return emits no StepOutput (its tokens were
        emitted before). Returns True when the queue head had arrived but
        could not be planned."""
        now = time.time()
        blocked = False
        while self.queue and self.queue[0].t_arrival <= now:
            head = self.queue[0]
            snap = self._eligible_snapshot(head)
            if snap is not None and head.max_new_tokens <= len(snap.tokens):
                # The snapshot covers the whole request: answer it on the
                # host without a slot.
                req = self.queue.popleft()
                self._replay_request(req, snap)
                outs.append(StepOutput(req.uid, list(req.generated), True,
                                       req.finish_reason))
                continue
            free_slots = [i for i in range(self.ecfg.batch_slots)
                          if self._slot_req[i] is None]
            if not free_slots and not self._try_preempt(head):
                break
            if not free_slots:        # a preemption just freed a slot
                continue
            try:
                plan = self._plan_admission(head)
            except RequestError as err:
                self._quarantine_queued(head, err, outs)
                continue
            if plan is None:          # FIFO holds until pages free up
                if not self._fault_blocked and self._try_preempt(head):
                    continue          # pages reclaimed: retry the plan
                blocked = True
                break
            i = free_slots[0]
            req = self.queue.popleft()
            resumed = bool(req.generated)
            gen0 = len(req.generated)
            hit0 = (req.cache_hit, req.cached_tokens, req.prefill_tokens)
            try:
                self._admit_to_slot(i, req, plan)
            except SnapshotRestoreError:
                # Recoverable: unwind the admission, drop the snapshot and
                # re-plan the request (cold or by prefix) at once; greedy
                # tokens are unchanged, the snapshot being a shortcut.
                self._abort_admission(i, req, gen0, hit0)
                self.prefix_cache.drop_snapshot(plan["snapshot"])
                self.queue.appendleft(req)
                continue
            except RequestError as err:
                self._abort_admission(i, req, gen0, hit0)
                self._quarantine_queued(req, err, outs)
                continue
            if req.generated and not req.t_first_token:
                req.t_first_token = time.time()
            req.slot, req.admit_step = i, self.steps_executed
            self._slot_req[i] = req
            sampling_mod.set_knobs(self._samp_host, i, req.sampling)
            if self.tel.enabled:
                self._tel_admit(i, req, plan, resumed)
            if resumed:
                continue    # its tokens so far were emitted and checked
            trunc, reason = sampling_mod.scan_finish(
                req.generated, req.sampling, req.max_new_tokens,
                self.detokenizer)
            if reason:
                req.generated = trunc
                self._retire_slot(i, reason)
            if req.generated or reason:
                # A chunked admission has no first token yet: its
                # StepOutput comes with its final chunk.
                outs.append(StepOutput(req.uid, list(req.generated),
                                       bool(reason), reason))
        return blocked

    def _admit_to_slot(self, i: int, req: Request, plan: dict):
        """Place ``req`` into free slot ``i`` according to ``plan``. The
        ``snapshot.restore`` site raises ``SnapshotRestoreError`` before
        the restore touches the device, ``kernel.prefill``
        ``QuarantineError`` once the slot entered PREFILL, and a swap-in
        ``QuarantineError`` before it touches the device; ``_admit``
        unwinds each."""
        self._slot_pages[i] = plan["pages"]
        self._slot_locked[i] = plan["locked"]
        pages = plan["pages"]
        if plan["kind"] == "swap":
            self._swap_in_slot(i, req)
            return
        if plan["kind"] == "snapshot":
            snap = plan["snapshot"]
            if self._fault("snapshot.restore", uid=req.uid) is not None:
                raise SnapshotRestoreError(
                    f"injected snapshot-restore failure for uid={req.uid}",
                    uid=req.uid)
            for kind, src, dst in plan["copies"]:
                self._dev_state = self._copy_page[kind](self._dev_state,
                                                        src, dst)
            self._dev_state = self._restore_snapshot(
                self._dev_state, i, self._page_vec([]),
                self._page_vec(pages.get("vg", [])),
                self._page_vec(pages["kc"]), snap.pos,
                self._page_vec(pages.get("vc", [])))
            clustering.update_ctx_slot(
                self._dev_ctx, {k: torch.from_numpy(v).to(self.device)
                                for k, v in snap.ctx.items()}, i)
            self._ctx_version += 1
            req.generated.extend(snap.tokens)
            req.cache_hit = "snapshot"
            req.cached_tokens = len(req.prompt)
            req.prefill_tokens = 0
            self._phases[i] = chai_cache.PHASE_STEADY
            self._slot_count[i] = len(snap.tokens)
            self.prefix_cache.stats["snapshot_hits"] += 1
            self.prefix_cache.stats["tokens_reused"] += len(req.prompt)
            self._next_tok[i] = snap.tokens[-1]
            self._tok_dirty = True
            if self.tel.enabled:
                self.tel.event(req.uid, "phase", phase="STEADY", slot=i)
            return
        self._phases[i] = chai_cache.PHASE_PREFILL
        if self._fault("kernel.prefill", uid=req.uid) is not None:
            raise QuarantineError(
                f"injected prefill-kernel failure for uid={req.uid}",
                uid=req.uid)
        if self.tel.enabled:
            self.tel.event(req.uid, "phase", phase="PREFILL", slot=i)
        prompt, pre = req.prompt, 0
        if plan["kind"] == "prefix":
            pre = plan["prefix_len"]
            req.cache_hit = "prefix"
            req.cached_tokens = pre
            req.prefill_tokens = len(prompt) - pre
            self.prefix_cache.stats["partial_hits"] += 1
            self.prefix_cache.stats["tokens_reused"] += pre
            self.prefix_cache.stats["tokens_prefilled"] += \
                req.prefill_tokens
        else:
            req.prefill_tokens = len(prompt)
            if self.prefix_cache is not None:
                self.prefix_cache.stats["misses"] += 1
                self.prefix_cache.stats["tokens_prefilled"] += len(prompt)
        if self._chunk and len(prompt) - pre > self._chunk:
            # Chunked prefill: the first chunk now; step() advances one
            # chunk per iteration until the final one enters WARMUP.
            self._slot_prefill_state[i] = {"req": req, "tokens": prompt,
                                           "cursor": pre}
            self._advance_chunk(i)
            return
        toks, true_len = self._padded_suffix(prompt[pre:], pre)
        if plan["kind"] == "prefix":
            logits, self._dev_state = self._suffix_prefill(
                self.params, toks, true_len, pre, self._dev_state, i,
                self._page_vec(plan["scatter_kg"]),
                self._page_vec(plan["scatter_vg"]),
                self._page_vec(pages["kg"]), self._page_vec(pages["vg"]))
        elif self.paged:
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
        chunk): index the prompt into the prefix cache, enter WARMUP and
        sample the first token."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt, self._slot_pages[i]["kg"],
                                     self._slot_pages[i]["vg"])
        self._phases[i] = chai_cache.PHASE_WARMUP
        self._slot_count[i] = 1
        tok = self._sample_first(logits, req)
        req.generated.append(tok)
        first = not req.t_first_token
        if first:
            req.t_first_token = time.time()
        self._next_tok[i] = tok
        self._tok_dirty = True
        if self.tel.enabled:
            tel = self.tel
            tel.event(req.uid, "phase", phase="WARMUP", slot=i)
            if req.prefill_tokens > 0:
                tel.counter("prefill_tokens_total", req.prefill_tokens,
                            help="Prompt tokens actually forwarded")
            if first:
                tel.event(req.uid, "first_token", t=req.t_first_token)
                tel.observe("request_ttft_seconds",
                            max(0.0, req.t_first_token - req.t_enqueue),
                            help="Enqueue-to-first-token latency")
            tel.counter("tokens_generated_total",
                        help="Generated tokens emitted")
            tel.token(req.uid, t=req.t_first_token if first else None)

    # -- priority preemption -----------------------------------------------
    def _try_preempt(self, head: Request) -> bool:
        """Reclaim the running slot of lowest priority that ``head``
        strictly outranks (ties never preempt; among equals the latest
        admission loses, the least progress thrown away). False when there
        is none, or when the host tier cannot make room for its pages; True
        once the slot was preempted (the caller retries its plan)."""
        if not (self.ecfg.preemption and self.paged):
            return False
        victims = [i for i in range(self.ecfg.batch_slots)
                   if self._slot_req[i] is not None
                   and self._slot_req[i].priority < head.priority]
        if not victims:
            return False
        i = min(victims, key=lambda j: (self._slot_req[j].priority,
                                        -self._slot_req[j].admit_step))
        if self._phases[i] != chai_cache.PHASE_PREFILL:
            pages = self._slot_pages[i]
            need = {}
            for kind, keys in (("dense", ("kg", "vg")),
                               ("chai", ("kc", "vc"))):
                n = sum(len(pages.get(k, ())) for k in keys)
                if n:
                    need[kind] = n
            if need and not self.tiers.make_room(need):
                return False
        self._preempt_slot(i)
        return True

    def _preempt_slot(self, i: int):
        """Evict slot ``i`` WITHOUT finishing its request: swap its state
        out to host pages (``_swap_out_slot``; its tokens stay on the
        Request), index its pages into the prefix cache (when on), free
        every page refcount-exactly as a retire does, and re-queue the
        request right behind the queue head. A victim still in PREFILL has
        no decode state worth saving: it prefills again (a chunked one
        from its first chunk)."""
        r = self._slot_req[i]
        phase = int(self._phases[i])
        if phase != chai_cache.PHASE_PREFILL:
            with self.tel.span("preempt.swap", step=self._span_step,
                               slot=i):
                r.resume_state = self._swap_out_slot(i, r, phase)
            if self.prefix_cache is not None:
                self._index_retired(r, self._slot_pages[i])
        r.preemptions += 1
        self.preemptions += 1
        self._slot_prefill_state[i] = None
        self._slot_req[i] = None
        self._phases[i] = chai_cache.PHASE_FREE
        self._slot_count[i] = 0
        self._dev_state = self._reset_slot(self._dev_state, i)
        self._free_pages(self._slot_pages[i])
        if self._slot_locked[i]:
            self.prefix_cache.unlock(self._slot_locked[i])
            self._slot_locked[i] = []
        self._samp_host["temperature"][i] = 0.0     # FREE slots: greedy
        self.queue.insert(min(1, len(self.queue)), r)
        if self.tel.enabled:
            self.tel.counter("preemptions_total",
                             help="Slots reclaimed for a higher-priority "
                                  "arrival")
            self.tel.event(r.uid, "preempt", slot=i,
                           phase=_PHASE_NAMES.get(phase, str(phase)),
                           step=self.steps_executed)

    def _swap_out_slot(self, i: int, r: Request, phase: int) -> dict:
        """Copy slot ``i``'s per-slot columns, CHAI membership and page
        contents to the host: one gather a pool plane
        (``steps.make_slot_swap``), one non-blocking copy a page into the
        tier manager's host buffers (pinned on CUDA), then ONE event
        synchronized before the CRC reads them. All of it is queued before
        the caller frees the device pages, which the next admission may
        write at once. Returns the resume payload: phase, token count,
        columns, membership, page counts, the CRC over columns and pages
        (the ``swap.corrupt`` site damages the host copy after it) and the
        host page ids."""
        pages = self._slot_pages[i]
        keys = ("kg", "vg", "kc", "vc")
        npages = {k: len(pages.get(k, ())) for k in keys}
        cols, pools = self._swap_out(
            self._dev_state, i, *[self._page_ids(pages.get(k, ()))
                                  for k in keys])
        take = self.tiers.slabs.take
        payloads = {}
        for k in keys:
            if not npages[k]:
                continue
            planes = {name: pools[key].movedim(1, 0).contiguous()
                      for name, key in (("data", k), ("scale", k + "_scale"))
                      if key in pools}           # (pages, nG, rows, ...)
            payloads[k] = []
            for j in range(npages[k]):
                page = {}
                for name, dev in planes.items():
                    host = take(tuple(dev.shape[1:]), dev.dtype)
                    host.copy_(dev[j], non_blocking=True)
                    page[name] = host
                payloads[k].append(page)
        cols = {k: v.to("cpu", non_blocking=True) for k, v in cols.items()}
        ctx = ({k: v[:, i].to("cpu", non_blocking=True, copy=True)
                for k, v in self._dev_ctx.items()} if self.chai_on else None)
        if self.device.type == "cuda":
            landed = torch.cuda.Event()
            landed.record()
            landed.synchronize()
        tree = {k: {str(j): p for j, p in enumerate(pl)}
                for k, pl in payloads.items()}
        crc = faults_mod.checksum_arrays({"cols": cols, "pools": tree})
        if self._fault("swap.corrupt", uid=r.uid) is not None:
            # Damage the host copy AFTER the stamp, so the swap-in catches
            # it; the damaged bytes go back into the host buffers.
            damaged = {k: {j: dict(p) for j, p in pl.items()}
                       for k, pl in tree.items()}
            faults_mod.corrupt_arrays(damaged, seed=self.faults.seed)
            for k, pl in tree.items():
                for j, p in pl.items():
                    for name, buf in p.items():
                        buf.copy_(damaged[k][j][name])
        tier_pages = {}
        for k, pl in payloads.items():
            kind = kv_tiers_mod.POOL_OF[k]
            tier_pages[k] = self.tiers.store_pages(kind, pl)
            self.tiers.record("hot", "host", kind, len(pl))
        return {"phase": phase, "count": self._slot_count[i], "cols": cols,
                "ctx": ctx, "npages": npages, "crc": crc,
                "tier_pages": tier_pages}

    def _swap_in_slot(self, i: int, req: Request):
        """Resume a preempted request in slot ``i``, whose fresh pages the
        plan allocated: check the host copy's CRC, upload the columns and
        the page contents (one non-blocking copy a page into one staging
        buffer a plane, then one scatter a plane), rebuild the block
        tables, restore the CHAI membership (a new ctx version, so no
        stale host view serves the slot) and the sampler's knobs (set by
        ``_admit``). The slot decodes on the state it was evicted with,
        bit for bit. The ``swap.in`` and ``offload.in`` sites and a CRC
        mismatch raise ``QuarantineError`` before the device is touched;
        the request's host pages are then freed by the quarantine."""
        resume = req.resume_state
        if self._fault("swap.in", uid=req.uid) is not None:
            raise QuarantineError(
                f"injected swap-in failure for uid={req.uid}", uid=req.uid)
        if self._fault("offload.in", uid=req.uid) is not None:
            raise QuarantineError(
                f"injected host-tier fetch failure for uid={req.uid}",
                uid=req.uid)
        payloads = {k: self.tiers.fetch_pages(kv_tiers_mod.POOL_OF[k], pg)
                    for k, pg in resume["tier_pages"].items()}
        tree = {k: {str(j): p for j, p in enumerate(pl)}
                for k, pl in payloads.items()}
        if faults_mod.checksum_arrays(
                {"cols": resume["cols"], "pools": tree}) != resume["crc"]:
            self.swap_checksum_failures += 1
            raise QuarantineError(
                f"swap-in checksum mismatch for uid={req.uid}: the "
                "host-side resume payload was corrupted while swapped "
                "out", uid=req.uid)
        pools = {}
        for k, pl in payloads.items():
            for name, key in (("data", k), ("scale", k + "_scale")):
                if name not in pl[0]:
                    continue
                dev = torch.empty((len(pl),) + tuple(pl[0][name].shape),
                                  dtype=pl[0][name].dtype, device=self.device)
                for j, p in enumerate(pl):
                    dev[j].copy_(p[name], non_blocking=True)
                pools[key] = dev.movedim(0, 1)     # (nG, pages, rows, ...)
        pages = self._slot_pages[i]
        keys = ("kg", "vg", "kc", "vc")
        self._dev_state = self._swap_in(
            self._dev_state, i, resume["cols"], pools,
            *[self._page_ids(pages.get(k, ())) for k in keys],
            *[self._page_vec(pages.get(k, [])) for k in keys])
        # The uploads are queued: the host pages may go (a later write
        # into their buffers is ordered after them, kv_tiers.free_pages).
        for k, pg in resume["tier_pages"].items():
            kind = kv_tiers_mod.POOL_OF[k]
            self.tiers.free_pages(kind, pg)
            self.tiers.record("host", "hot", kind, len(pg))
        resume["tier_pages"] = {}
        req.resume_state = None
        if self.chai_on:
            clustering.update_ctx_slot(
                self._dev_ctx, {k: v.to(self.device, non_blocking=True)
                                for k, v in resume["ctx"].items()}, i)
            self._ctx_version += 1
        self._phases[i] = resume["phase"]
        self._slot_count[i] = resume["count"]
        self._next_tok[i] = req.generated[-1]
        self._tok_dirty = True
        self._record_kv_bytes()

    def _cluster_transitions(self, active, outs: List[StepOutput]):
        """CLUSTER + compact the slots whose warmup just completed; paged:
        the slot's dense K pages (and, under share_values, its dense V
        pages) return to the pool here, after the prefix cache (when on)
        captured the slot's CHAI snapshot. An injected ``kernel.cluster``
        fault quarantines the transitioning request before clustering
        mutates the pools (``outs`` receives its typed StepOutput)."""
        if not self.chai_on:
            return
        warm = self.cfg.chai.warmup_tokens
        for i in active:
            if not (self._slot_count[i] == warm + 1
                    and self._phases[i] == chai_cache.PHASE_WARMUP):
                continue
            req = self._slot_req[i]
            if self._fault("kernel.cluster", uid=req.uid) is not None:
                self._retire_slot(
                    i, sampling_mod.FINISH_ERROR, index=False,
                    error=f"injected cluster-transition failure for "
                          f"uid={req.uid}")
                outs.append(StepOutput(req.uid, [], True,
                                       sampling_mod.FINISH_ERROR))
                continue
            self._phases[i] = chai_cache.PHASE_CLUSTER
            self.cluster_transitions += 1
            if self.tel.enabled:
                self.tel.counter("cluster_transitions_total",
                                 help="WARMUP->CLUSTER->STEADY "
                                      "transitions executed")
                self.tel.event(req.uid, "phase", phase="CLUSTER", slot=i)
            if self.paged:
                self._dev_state, self._dev_ctx = self._cluster_fn()(
                    self._dev_state, self._dev_ctx, i,
                    self._page_vec(self._slot_pages[i].get("kc", [])),
                    self._page_vec(self._slot_pages[i].get("vc", [])))
                self._ctx_version += 1
                if (self.prefix_cache is not None and self.chai_clustered
                        and self._slot_req[i].sampling.greedy):
                    self._capture_snapshot(i, self._slot_req[i],
                                           self._slot_pages[i])
                if self.chai_clustered:
                    freed = len(self._slot_pages[i]["kg"])
                    self.dense_pool.free(self._slot_pages[i].pop("kg"))
                    if self.cfg.chai.share_values:
                        freed += len(self._slot_pages[i]["vg"])
                        self.dense_pool.free(self._slot_pages[i].pop("vg"))
                    if self.tel.enabled:
                        self.tel.counter(
                            "chai_dense_pages_freed_total", freed,
                            help="Dense pages freed at compaction (the "
                                 "paper's KV saving, realized)")
                self._record_kv_bytes()
            else:
                self._dev_state, self._dev_ctx = self._cluster_fn()(
                    self._dev_state, self._dev_ctx, i)
                self._ctx_version += 1
            self._phases[i] = chai_cache.PHASE_STEADY
            if self.tel.enabled:
                self.tel.event(req.uid, "phase", phase="STEADY", slot=i)
                self._tel_clusters(i)

    def _decode(self, active) -> List[StepOutput]:
        """One batched decode step on the cheapest step that covers the
        phase mix, then one pick per slot: the bare argmax when no slot
        samples, else the sampler, each sampling row drawing its token
        number ``len(req.generated)``. Each row's finite flag (the NaN/Inf
        guard: a non-finite row quarantines its slot, the other rows'
        tokens untouched) comes back with the tokens, in the step's one
        device-to-host copy.

        An injected ``kernel.decode`` fault (``InjectedFault``, raised
        before any launch) retries the step on the plain steps and leaves
        the engine degraded; any other exception propagates: a real CUDA
        error leaves the context unusable, and the step writes K/V into
        the pools in place before it attends."""
        outs: List[StepOutput] = []
        tel = self.tel
        step_no = self._span_step
        if self._tok_dirty:
            self._next_tok_dev = torch.from_numpy(self._next_tok).to(
                self.device)
            self._tok_dirty = False
        inputs = {"tokens": self._next_tok_dev}
        occupied = self._phases[self._phases != chai_cache.PHASE_FREE]
        with tel.span("relay.form", step=step_no):
            relay = self._build_relay(active) if self.relay_decode else None
        self._decode_fault_hit = False
        try:
            with tel.span("decode.dispatch", step=step_no,
                          degraded=self.degraded_decode):
                logits, state = self._dispatch_decode(inputs, relay,
                                                      occupied)
        except InjectedFault as err:
            self.degraded_decode = True
            self.decode_fallbacks += 1
            self._heal_clean = 0
            if tel.enabled:
                tel.counter("decode_fallbacks_total",
                            help="Injected decode faults survived on the "
                                 "kernels' plain versions")
                tel.gauge("engine_degraded_decode", 1, help=_DEGRADED_HELP)
            try:
                with tel.span("decode.dispatch", step=step_no,
                              degraded=True, retry=True):
                    logits, state = self._dispatch_decode(inputs, None,
                                                          occupied)
            except Exception as err2:
                raise EngineFault(
                    "decode failed on the kernels AND on their plain "
                    f"versions: {err2!r} (original failure: {err!r})"
                ) from err2
        else:
            if self.degraded_decode and self.ecfg.decode_heal_steps > 0:
                self._maybe_heal()
        self._dev_state = state
        if self.faults is not None:
            poison = [i for i in active
                      if self._fault("step.logits",
                                     uid=self._slot_req[i].uid) is not None]
            if poison:
                logits = logits.clone()
                logits[poison] = float("nan")
        sample_cm = tel.span("sample", step=step_no)
        sample_cm.__enter__()
        finite = torch.isfinite(torch.amax(logits, dim=-1))
        temps = self._samp_host["temperature"]
        if not temps.any():
            tok_dev = self._argmax(logits)
        else:
            counts = np.zeros((self.ecfg.batch_slots,), np.int64)
            for i in active:
                counts[i] = len(self._slot_req[i].generated)
            h = self._samp_host
            tok_dev = self._sampler(logits, temps, h["top_k"], h["top_p"],
                                    h["seed"], counts)
        self._next_tok_dev = tok_dev
        host = torch.stack([tok_dev, finite.to(tok_dev.dtype)]).cpu().numpy()
        toks, finite = host[0], host[1] != 0
        self._next_tok[:] = toks
        sample_cm.__exit__(None, None, None)
        self.steps_executed += 1
        retire_cm = tel.span("retire", step=step_no)
        retire_cm.__enter__()
        for i in active:
            r = self._slot_req[i]
            if not finite[i]:
                # The row's token is garbage: quarantine the request; rows
                # are independent, so the other slots' picks stand.
                self._retire_slot(
                    i, sampling_mod.FINISH_ERROR, index=False,
                    error=f"non-finite logits for uid={r.uid} at step "
                          f"{self.steps_executed - 1}")
                outs.append(StepOutput(r.uid, [], True,
                                       sampling_mod.FINISH_ERROR))
                continue
            r.generated.append(int(toks[i]))
            self._slot_count[i] += 1
            if tel.enabled:
                tel.counter("tokens_generated_total",
                            help="Generated tokens emitted")
                tel.token(r.uid)
            reason = self._finish_of(r)
            if reason:
                self._retire_slot(i, reason)
            outs.append(StepOutput(r.uid, [int(toks[i])], bool(reason),
                                   reason))
        retire_cm.__exit__(None, None, None)
        if self.paged:
            self._record_kv_bytes()
        return outs

    def _dispatch_decode(self, inputs, relay, occupied):
        """The relay step when relay groups formed; else all-CHAI when
        every occupied slot is STEADY, all-MHA when every one is WARMUP
        (or CHAI is off), else the mixed-phase step. The ``kernel.decode``
        site raises ``InjectedFault`` first, before any launch (while
        degraded a firing arm only restarts the heal count);
        ``degraded_decode`` runs the plain steps
        (``_plain_decode_steps``)."""
        state = self._dev_state
        if self._fault("kernel.decode") is not None:
            self._decode_fault_hit = True
            if not self.degraded_decode:
                raise InjectedFault("kernel.decode")
        if relay is not None:
            self.relay_steps += 1
            return self._relay_step(self.params, inputs, state,
                                    self._dev_ctx, relay)
        if self.degraded_decode:
            steps = self._plain_decode_steps()
            mha, chai, mixed = steps["mha"], steps.get("chai"), \
                steps.get("mixed")
        else:
            mha = self._mha_step
            chai = self._chai_step if self.chai_on else None
            mixed = self._mixed_step if self.chai_on else None
        if not self.chai_on:
            return mha(self.params, inputs, state)
        if (occupied == chai_cache.PHASE_STEADY).all():
            return chai(self.params, inputs, state, self._dev_ctx)
        if (occupied == chai_cache.PHASE_WARMUP).all():
            return mha(self.params, inputs, state)
        return mixed(self.params, inputs, state, self._dev_ctx)

    def _maybe_heal(self):
        """Degraded-decode healing: after ``decode_heal_steps``
        consecutive clean decode steps (the ``kernel.decode`` arm stayed
        quiet), return to the kernels. A firing arm, even one the
        degraded path masks, restarts the count."""
        if self._decode_fault_hit:
            self._heal_clean = 0
            return
        self._heal_clean += 1
        if self._heal_clean < self.ecfg.decode_heal_steps:
            return
        self.degraded_decode = False
        self.decode_heals += 1
        self._heal_clean = 0
        if self.tel.enabled:
            self.tel.counter("decode_heals_total",
                             help="Degraded decode returned to the "
                                  "kernels")
            self.tel.gauge("engine_degraded_decode", 0,
                           help=_DEGRADED_HELP)

    def _plain_decode_steps(self):
        """The degraded decode steps, built on the first injected decode
        fault: the same step makers with ``plain=True``, so every decode
        attention that launches a CUDA kernel on the clean step runs that
        kernel's plain version (``kernels.ref``) on the engine's device
        instead (the relay is skipped: ``_build_relay`` returns None while
        degraded)."""
        if self._plain_steps is None:
            cfg, ts = self.cfg, self.ecfg.page_size
            steps = {"mha": steps_mod.make_serve_step(
                cfg, chai=False, decode_ts=ts, plain=True)}
            if self.chai_on:
                steps["chai"] = steps_mod.make_serve_step(
                    cfg, chai=True, decode_ts=ts, plain=True)
                steps["mixed"] = steps_mod.make_mixed_step(
                    cfg, decode_ts=ts, plain=True)
            self._plain_steps = steps
        return self._plain_steps

    def _retire_slot(self, i: int, reason: str, *, error: str = "",
                     index: bool = True):
        """Retire or abort slot ``i``: finalize the request, reset the slot
        on the device and return every page it held to the pools. A
        quarantine passes ``error`` (recorded on the Request) and
        ``index=False``: a damaged sequence never seeds the prefix
        cache."""
        r = self._slot_req[i]
        r.generated = r.generated[:r.max_new_tokens]
        r.finish_reason = reason
        r.error = error
        if error:
            self.quarantined += 1
            if self.tel.enabled:
                self.tel.event(r.uid, "quarantine", reason=error)
        r.t_done = time.time()
        r.retire_step = self.steps_executed
        self._done(r)
        self._slot_req[i] = None
        self._slot_prefill_state[i] = None
        self._phases[i] = chai_cache.PHASE_FREE
        self._slot_count[i] = 0
        if index and self.prefix_cache is not None:
            self._index_retired(r, self._slot_pages[i])
        self._dev_state = self._reset_slot(self._dev_state, i)
        if self.paged:          # block tables are nulled; pages go back
            self._free_pages(self._slot_pages[i])
            if self._slot_locked[i]:
                self.prefix_cache.unlock(self._slot_locked[i])
                self._slot_locked[i] = []
        self._samp_host["temperature"][i] = 0.0     # FREE slots: greedy

    def _index_retired(self, req: Request, pages: dict):
        """Retire-time radix insertion of the slot's FULL sequence (prompt
        + generated; decode wrote K/V for every token but the last), so a
        follow-up turn prefills only its new suffix. Only slots that still
        hold their dense K and V pages have a complete paged record
        (clustered CHAI slots freed dense K at compaction; their reuse
        path is the prompt-keyed snapshot)."""
        if "kg" not in pages or "vg" not in pages:
            return
        seq = list(map(int, req.prompt)) + list(req.generated[:-1])
        self.prefix_cache.insert(seq, pages["kg"], pages["vg"])

    # -- shared-prefix relay decode ----------------------------------------
    def _ctx_host(self):
        """numpy mirror of the clustering context, rebuilt only when the
        ctx version moved (CLUSTER transition or snapshot restore)."""
        if (self._ctx_host_cache is None
                or self._ctx_host_cache[0] != self._ctx_version):
            self._ctx_host_cache = (
                self._ctx_version,
                {k: np.array(v.cpu()) for k, v in self._dev_ctx.items()})
        return self._ctx_host_cache[1]

    def _resident_view(self, chain):
        """Packed copy (nG, KV, len(chain) * page, hd) of a radix chain's
        dense K and V pages (int8: and of their scale planes (nG, KV,
        len(chain) * page), the reference's ``_pack_prefix_fn``), cached
        on the deepest node and keyed by the chain's pages. Cached pages
        are never written (copy-on-write), and eviction drops
        ``node.resident``, so the copy stays valid across steps."""
        node = chain[-1]
        key = (tuple(n.kg_page for n in chain),
               tuple(n.vg_page for n in chain))
        if node.resident is None or node.resident[0] != key:
            state = self._dev_state

            def view(name, pages):
                pool = state[name]            # (nG, nP, KV, page[, hd])
                idx = torch.tensor(pages, dtype=torch.long,
                                   device=pool.device)
                g = pool[:, idx].transpose(1, 2)
                return g.reshape(g.shape[:2] + (-1,) + g.shape[4:])
            packs = {"k": view("kvp", key[0]), "v": view("kvp", key[1])}
            if "kvp_scale" in state:
                packs["k_scale"] = view("kvp_scale", key[0])
                packs["v_scale"] = view("kvp_scale", key[1])
            node.resident = (key, packs)
        return node.resident[1]

    def _relay_row_maps(self, groups, nmax):
        """Per-layer routing maps of the group-batched prefix pass (see
        ``core.chai_attention._relay_prefix_state``), cached per (ctx
        version, membership). Member j of a group owns query rows
        [j*R, (j+1)*R) and acc rows [j*H, (j+1)*H). MHA (R = k_max reps):
        query row j*R + i reads the chain's dense K row reps[i]; head h
        reads query row j*R + h2c[h] and V row h; under share_values the
        member owns acc rows [j*R, (j+1)*R) instead, acc row j*R + i
        reading query row j*R + i and the dense V row reps[i] (the h2c
        broadcast then happens at the finalize). GQA (R = KV * r reps,
        r per KV group): query row j*R + g*r + i reads its group's K row
        g; head h of group g reads query row j*R + g*r + cluster_of[g,
        h % qpk] and V row g. Padded member entries keep index 0: their
        rows compute values the per-slot scatter discards."""
        key = (self._ctx_version,
               tuple((id(g["node"]), tuple(g["members"])) for g in groups))
        if (self._relay_rows_cache is not None
                and self._relay_rows_cache[0] == key):
            return self._relay_rows_cache[1]
        ctx = self._ctx_host()
        if self.cfg.is_mha and self.cfg.chai.share_values:
            k_rows = v_rows = ctx["reps"]             # (nA, B, R)
            n_a, b, r = k_rows.shape
            h = r                                     # acc rows: the reps
            a_rows = np.broadcast_to(np.arange(r, dtype=np.int32),
                                     (n_a, b, r))
        elif self.cfg.is_mha:
            k_rows, a_rows = ctx["reps"], ctx["h2c"]  # (nA, B, R), (nA, B, H)
            n_a, b, r = k_rows.shape
            h = a_rows.shape[-1]
            v_rows = np.broadcast_to(np.arange(h, dtype=np.int32),
                                     (n_a, b, h))
        else:
            # reps (nA, B, KV, r), cluster_of (nA, B, KV, qpk)
            cluster_of = ctx["cluster_of"]
            n_a, b, n_kv, r_g = ctx["reps"].shape
            qpk = cluster_of.shape[-1]
            r, h = n_kv * r_g, n_kv * qpk
            group = np.arange(n_kv, dtype=np.int32)
            k_rows = np.broadcast_to(np.repeat(group, r_g), (n_a, b, r))
            a_rows = (group[:, None] * r_g + cluster_of).reshape(n_a, b, h)
            v_rows = np.broadcast_to(np.repeat(group, qpk), (n_a, b, h))
        n_g = len(groups)
        k_row = np.zeros((n_a, n_g, nmax * r), np.int32)
        a_row = np.zeros((n_a, n_g, nmax * h), np.int32)
        v_row = np.zeros((n_a, n_g, nmax * h), np.int32)
        for g, grp in enumerate(groups):
            for j, slot in enumerate(grp["members"]):
                k_row[:, g, j * r:(j + 1) * r] = k_rows[:, slot]
                a_row[:, g, j * h:(j + 1) * h] = j * r + a_rows[:, slot]
                v_row[:, g, j * h:(j + 1) * h] = v_rows[:, slot]
        maps = {name: torch.from_numpy(x).to(self.device)
                for name, x in (("k_row", k_row), ("a_row", a_row),
                                ("v_row", v_row))}
        self._relay_rows_cache = (key, maps)
        return maps

    def _build_relay(self, active):
        """Form shared-prefix relay groups over the STEADY slots.

        Slots admitted through the radix cache keep their matched chain
        pinned in ``_slot_locked``; each slot picks the DEEPEST chain node
        shared by >= ``relay_min_group`` such slots, and slots that picked
        the same node form one group. Returns the relay dict the relay
        step consumes (None: the plain dispatch): the groups' packed
        prefix copies stacked (zero tail to the longest), the routing
        maps, and per-slot scatter coordinates; a slot outside a group has
        ``in_group=False`` and ``len=0``. None while the decode is
        degraded (the plain steps attend the whole block tables), and when
        the ``relay.residency`` site dissolves the groups formed."""
        if self.degraded_decode:
            return None
        min_g = max(1, self.ecfg.relay_min_group)
        chains = {}
        for i in active:
            if self._phases[i] != chai_cache.PHASE_STEADY:
                continue
            locked = self._slot_locked[i]
            if not locked or not all(isinstance(e, BlockNode)
                                     for e in locked):
                continue      # snapshot pins / no radix plan
            if any(e.evicted for e in locked):
                continue      # the chain lost pages since admission
            chains[i] = locked
        if len(chains) < min_g:
            return None
        counts: dict = {}
        for chain in chains.values():
            for node in chain:
                counts[id(node)] = counts.get(id(node), 0) + 1
        by_node: dict = {}
        for i, chain in sorted(chains.items()):
            pick = None
            for depth, node in enumerate(chain, start=1):
                if counts[id(node)] >= min_g:
                    pick = (node, depth)        # deepest wins
            if pick is None:
                continue
            node, depth = pick
            grp = by_node.setdefault(
                id(node), {"node": node, "depth": depth, "members": []})
            grp["members"].append(i)
        groups = [g for g in by_node.values()
                  if len(g["members"]) >= min_g]
        if not groups:
            return None
        if self._fault("relay.residency") is not None:
            # Dissolve the groups formed this step to the per-request
            # decode path: grouped and ungrouped decode give the same
            # tokens, so dissolving is always safe.
            self.relay_dissolved += 1
            if self.tel.enabled:
                self.tel.counter("relay_dissolved_total",
                                 help="Relay groups dissolved by an "
                                      "injected residency fault")
            return None
        ps = self.ecfg.page_size
        b = self.ecfg.batch_slots
        nmax = max(len(g["members"]) for g in groups)
        packs = [self._resident_view(chains[g["members"][0]][:g["depth"]])
                 for g in groups]
        sp_max = max(p["k"].shape[2] for p in packs)

        def stack(name):
            # zero tail to the longest group's Sp (axis 2 of every pack)
            return torch.stack([torch.nn.functional.pad(
                p[name], (0, 0) * (p[name].ndim - 3)
                + (0, sp_max - p[name].shape[2])) for p in packs], dim=1)

        relay = {name: stack(name) for name in packs[0]}
        members = np.zeros((len(groups), nmax), np.int32)
        plen_g = np.zeros((len(groups),), np.int32)
        gid = np.zeros((b,), np.int32)
        midx = np.zeros((b,), np.int32)
        plen_b = np.zeros((b,), np.int32)
        ing = np.zeros((b,), bool)
        for g, grp in enumerate(groups):
            plen_g[g] = grp["depth"] * ps
            for j, slot in enumerate(grp["members"]):
                members[g, j] = slot
                gid[slot] = g
                midx[slot] = j
                plen_b[slot] = plen_g[g]
                ing[slot] = True
        relay.update(self._relay_row_maps(groups, nmax))
        relay.update({name: torch.from_numpy(x).to(self.device)
                      for name, x in (("plen", plen_g), ("members", members),
                                      ("gid", gid), ("midx", midx),
                                      ("len", plen_b), ("in_group", ing))})
        self.relay_grouped_slots += int(ing.sum())
        if self.tel.enabled:
            self.tel.counter("relay_groups_formed_total", len(groups),
                             help="Shared-prefix relay groups formed")
            self.tel.counter("relay_grouped_slots_total", int(ing.sum()),
                             help="Slot-steps decoded through a relay "
                                  "group")
        return relay

    # -- metrics ------------------------------------------------------------
    def fault_stats(self):
        """Robustness counters and the injector's replayable plan and
        firing log (None without an injector). ``offload_checksum_failures``
        counts demoted entries whose host copy failed its CRC at
        promotion, ``swap_checksum_failures`` preempted requests whose
        host copy failed its CRC at swap-in."""
        return {"quarantined": self.quarantined,
                "audit_steps": self.audit_steps,
                "degraded_decode": self.degraded_decode,
                "decode_fallbacks": self.decode_fallbacks,
                "decode_heals": self.decode_heals,
                "relay_dissolved": self.relay_dissolved,
                "swap_checksum_failures": self.swap_checksum_failures,
                "offload_checksum_failures": self.offload_checksum_failures,
                "injector": (self.faults.report()
                             if self.faults is not None else None)}

    def tier_stats(self):
        """KV-tier counters: per-tier residency, transition totals and the
        prefetch hits and misses (None without tiers: the dense
        layout)."""
        if self.tiers is None:
            return None
        out = self.tiers.stats()
        out["prefetch_hits"] = self.prefetch_hits
        out["prefetch_misses"] = self.prefetch_misses
        out["offload_checksum_failures"] = self.offload_checksum_failures
        return out

    def prefix_stats(self):
        """Prefix-cache counters and current residency (empty when the
        cache is off)."""
        if self.prefix_cache is None:
            return {}
        dense_held, chai_held = self.prefix_cache.held_pages()
        return {**self.prefix_cache.stats,
                "blocks": self.prefix_cache.num_blocks,
                "snapshots": self.prefix_cache.num_snapshots,
                "dense_page_refs": dense_held,
                "chai_page_refs": chai_held}

    def kv_bytes(self, *, chai: Optional[bool] = None):
        """KV-cache bytes. With explicit ``chai=``: the paper's analytic
        steady-state size (Fig 11 A/B comparisons). With no argument on
        the continuous scheduler: this engine's actual footprint, the
        allocated-page bytes right now plus the local rings (paged; falls
        at each CLUSTER transition) or the unified layout's constant
        residency (dense)."""
        if chai is None and self.ecfg.scheduler == "continuous":
            if self.paged:
                return chai_cache.paged_kv_bytes(
                    self.cfg, self.ecfg.page_size,
                    self.dense_pool.pages_in_use,
                    self.chai_pool.pages_in_use if self.chai_pool else 0,
                    batch=self.ecfg.batch_slots, max_seq=self.ecfg.max_seq)
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
            self.chai_pool.capacity if self.chai_pool else 0,
            batch=self.ecfg.batch_slots, max_seq=self.ecfg.max_seq)


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
