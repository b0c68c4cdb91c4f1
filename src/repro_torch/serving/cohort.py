"""Lockstep cohort scheduler (``EngineConfig.scheduler="cohort"``).

Requests admitted together move through the CHAI phase machine together:
one bucketed prefill, then lockstep WARMUP (MHA decode collecting
clustering features) -> CLUSTER (K-Means membership) -> COMPACT (K-cache
gather to representative rows) -> STEADY (clustered decode), with the
cohort-deadline straggler re-dispatch of the reference. The bucketed
prefill passes each row's true length, so a local layer's ring holds the
row's last real positions, never its padding. Every row samples with its
request's ``SamplingParams`` through the engine's sampler, token n of a
row keyed by (seed, n) as on the continuous scheduler, so a seeded
request gives the same tokens on both.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import cache as chai_cache
from repro_torch.serving import sampling as sampling_mod


class CohortSchedulerMixin:
    """Cohort scheduling methods mixed into ``ServingEngine``."""

    def _run_cohort_loop(self):
        while self.queue:
            if self.queue[0].t_arrival > time.time():
                time.sleep(max(1e-4,
                               self.queue[0].t_arrival - time.time()))
                continue
            # Priority classes pick the cohort (a lockstep cohort cannot
            # preempt mid-flight as the continuous core does, so the class
            # counts at formation): over the whole arrived run, highest
            # ``priority`` first, FIFO within a class (a stable sort); the
            # overflow goes back to the queue in that order.
            arrived = []
            while self.queue and self.queue[0].t_arrival <= time.time():
                arrived.append(self.queue.popleft())
            arrived.sort(key=lambda r: -r.priority)
            cohort = arrived[:self.ecfg.batch_slots]
            for r in reversed(arrived[self.ecfg.batch_slots:]):
                self.queue.appendleft(r)
            try:
                self._run_cohort(cohort)
            except TimeoutError:
                # cohort exceeded its deadline: finalize what finished,
                # re-dispatch the rest
                self.redispatched += len(cohort)
                for r in cohort:
                    trunc, reason = sampling_mod.scan_finish(
                        r.generated, r.sampling, r.max_new_tokens,
                        self.detokenizer)
                    if reason:
                        r.generated, r.finish_reason = trunc, reason
                        r.t_done = time.time()
                        self._done(r)
                    else:
                        self.queue.append(r)
        return self.done

    def _pad_prompts(self, cohort):
        """Right-pad a (possibly ragged) cohort to ONE power-of-two
        prompt-length bucket with per-example ``true_lens``."""
        b = self.ecfg.batch_slots
        t = max(len(r.prompt) for r in cohort)
        bucket = self._prompt_bucket(t, self.ecfg.max_seq)
        toks = np.zeros((b, bucket), np.int64)
        lens = np.full((b,), bucket, np.int64)   # idle rows: whole bucket
        for i, r in enumerate(cohort):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device))

    def _run_cohort(self, cohort):
        cfg, ecfg = self.cfg, self.ecfg
        deadline = time.time() + ecfg.cohort_deadline_s
        b = ecfg.batch_slots
        all_greedy = all(r.sampling.greedy for r in cohort)
        vecs = sampling_mod.knob_vectors(b)     # idle rows: greedy
        for i, r in enumerate(cohort):
            sampling_mod.set_knobs(vecs, i, r.sampling)

        def sample(logits, n):
            # n: tokens every row has sampled so far (lockstep), so each
            # draw is the continuous scheduler's for the same request.
            if all_greedy:
                return self._argmax(logits)
            return self._sampler(logits, vecs["temperature"],
                                 vecs["top_k"], vecs["top_p"],
                                 vecs["seed"], np.full((b,), n, np.int64))

        # A re-dispatched request decodes afresh from its prompt, and its
        # sampler counts restart with it, so a seeded request reproduces
        # its first run.
        for r in cohort:
            r.generated = []
        tokens, lens = self._pad_prompts(cohort)
        logits, state = self._prefill(
            self.params, {"tokens": tokens, "true_lens": lens})
        next_tok = sample(logits, 0)
        self._record(cohort, next_tok)
        t_first = time.time()
        for r in cohort:
            r.t_first_token = t_first

        warm = cfg.chai.warmup_tokens if self.chai_on else 0
        max_new = max(r.max_new_tokens for r in cohort)

        # ---- WARMUP: MHA decode, accumulating clustering features ----
        if self.chai_on:
            state = chai_cache.add_score_buffer(state, cfg, ecfg.batch_slots)
        step = 1
        while step < max_new and step <= warm:
            if time.time() > deadline:
                raise TimeoutError
            logits, state = self._mha_step(
                self.params, {"tokens": next_tok}, state)
            next_tok = sample(logits, step)
            self._record(cohort, next_tok)
            self.steps_executed += 1
            step += 1

        # ---- CLUSTER + COMPACT: membership ID, K-cache gather ----
        ctx = None
        if self.chai_on and step <= max_new:
            state, scores = chai_cache.pop_score_buffer(state)
            ctx = self._identify(scores)
            state = self._compact(state, ctx)

        # ---- STEADY: Clustered Head Attention decode ----
        while step < max_new:
            if time.time() > deadline:
                raise TimeoutError
            if ctx is not None:
                logits, state = self._chai_step(
                    self.params, {"tokens": next_tok}, state, ctx)
            else:
                logits, state = self._mha_step(
                    self.params, {"tokens": next_tok}, state)
            next_tok = sample(logits, step)
            self._record(cohort, next_tok)
            self.steps_executed += 1
            step += 1

        t_done = time.time()
        for r in cohort:
            # lockstep rows decode to the cohort's max; stops/budgets are
            # applied by the front-scan the reference uses
            trunc, reason = sampling_mod.scan_finish(
                r.generated, r.sampling, r.max_new_tokens,
                self.detokenizer)
            r.generated = trunc
            r.finish_reason = reason or sampling_mod.FINISH_LENGTH
            r.t_done = t_done
            self._done(r)

    @staticmethod
    def _argmax(logits):
        return torch.argmax(logits, dim=-1)

    @staticmethod
    def _record(cohort, next_tok):
        toks = next_tok.cpu().numpy()
        for i, r in enumerate(cohort):
            r.generated.append(int(toks[i]))
