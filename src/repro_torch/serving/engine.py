"""Serving engine: ``ServingEngine.submit/run`` over the cohort scheduler.

Request lifecycle (paper Fig 10), in lockstep per cohort:

    PREFILL -> WARMUP (MHA decode, clustering features accumulate)
            -> CLUSTER (K-Means membership) -> COMPACT (K cache gathered
               to representative rows) -> STEADY (Clustered Head Attention)

This slice ports the reference's ``"cohort"`` scheduler on the dense
layout. ``scheduler="continuous"`` (the reference's default: slot-level
continuous batching over the paged KV layout) is the next slice and
raises ``NotImplementedError`` until then. Every request is greedy.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as chai_cache
from repro_torch.core import clustering
from repro_torch.launch import steps as steps_mod
from repro_torch.serving.cohort import CohortSchedulerMixin
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 32
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # -- filled by the engine --
    generated: Optional[List[int]] = None
    finish_reason: str = ""            # "" while in flight; "length"|"stop"
    t_enqueue: float = 0.0
    t_arrival: float = 0.0             # earliest admission time
    t_first_token: float = 0.0         # first token on the host
    t_done: float = 0.0

    @property
    def ttft(self):
        return self.t_first_token - self.t_arrival

    @property
    def latency(self):
        return self.t_done - self.t_arrival


@dataclasses.dataclass
class EngineConfig:
    batch_slots: int = 4               # cohort size (static)
    max_seq: int = 256                 # KV capacity per slot (static)
    scheduler: str = "continuous"      # "continuous" (next slice) | "cohort"
    cohort_deadline_s: float = 120.0   # cohort straggler re-dispatch
    use_chai: bool = True
    page_size: int = 16                # also the fused decode's S-tile


class ServingEngine(CohortSchedulerMixin):
    """``submit()`` enqueues, ``run()`` drains the queue through lockstep
    cohorts and returns the completed requests.

    ``device``: where the engine runs; ``None`` means CUDA, and a missing
    GPU raises. ``params`` must already live there."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, *,
                 device=None):
        self.device = resolve_device(device)
        if ecfg.scheduler == "continuous":
            raise NotImplementedError(
                "scheduler='continuous' (slot-level continuous batching "
                "over the paged KV layout with paged_chai_fused_decode) is "
                "the next slice of the port; use scheduler='cohort'")
        if ecfg.scheduler != "cohort":
            raise ValueError(f"unknown scheduler {ecfg.scheduler!r}")
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
        self._uid_counter = 0
        b, s = ecfg.batch_slots, ecfg.max_seq
        self.chai_on = ecfg.use_chai and cfg.chai.enabled and cfg.k_max > 0
        self._prefill = steps_mod.make_serve_prefill(cfg, b, s)
        self._mha_step = steps_mod.make_serve_step(
            cfg, chai=False, decode_ts=ecfg.page_size)
        if self.chai_on:
            self._chai_step = steps_mod.make_serve_step(
                cfg, chai=True, decode_ts=ecfg.page_size)
            self._compact = steps_mod.make_compact_step(cfg)
            self._identify = lambda sc: clustering.identify_membership(sc,
                                                                       cfg)

    def submit(self, prompt, max_new_tokens=32, uid=None, *,
               arrival_delay: float = 0.0,
               sampling: Optional[SamplingParams] = None):
        """Enqueue a greedy request; returns its ``Request``."""
        sp = sampling if sampling is not None else SamplingParams()
        if not sp.greedy:
            raise NotImplementedError(
                "sampling with temperature > 0 comes with the continuous "
                "engine; this slice decodes greedily")
        if sp.stop:
            raise NotImplementedError("stop strings need a detokenizer, "
                                      "which is not ported yet")
        if len(prompt) + max_new_tokens > self.ecfg.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens})"
                f" exceeds max_seq ({self.ecfg.max_seq})")
        if uid is None:
            uid = self._uid_counter
        self._uid_counter = max(self._uid_counter, int(uid) + 1)
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, sampling=sp)
        req.t_enqueue = time.time()
        req.t_arrival = req.t_enqueue + arrival_delay
        req.generated = []
        self.queue.append(req)
        return req

    def run(self):
        """Drain the queue; returns completed requests."""
        return self._run_cohort_loop()

    @staticmethod
    def _prompt_bucket(t: int, cap: int) -> int:
        """Next power of two >= t, capped at max_seq."""
        b = 1
        while b < t:
            b <<= 1
        return min(b, cap)

    def kv_bytes(self, *, chai: Optional[bool] = None):
        """Analytic steady-state KV-cache bytes (paper Fig 11) for this
        engine's batch and capacity; ``chai`` defaults to whether CHAI
        is on."""
        chai = self.chai_on if chai is None else chai
        return chai_cache.kv_cache_bytes(
            self.cfg, self.ecfg.batch_slots, self.ecfg.max_seq, chai=chai)
