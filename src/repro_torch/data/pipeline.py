"""Deterministic synthetic token pipeline (the reference's
``data/pipeline.py``; numpy, so its tokens are the reference's bit for
bit).

An endless stream of next-token-predictable sequences from a mixture of
Zipfian n-gram Markov streams:

  * **Stateless-seeded**: batch ``i`` is a pure function of ``(seed,
    i)``, so a restarted trainer resumes mid-stream from the step counter
    alone (no iterator state in checkpoints).
  * **Shard-aware**: ``batch(i, host_id, n_hosts)`` makes one host's
    slice of the global batch. Feeding a multi-process job from its
    slices waits for the sharding tooling (ROADMAP #16);
    ``global_batch_tensor`` makes the whole batch on one device.
  * **Learnable**: per-stream transition tables with Zipfian fan-out
    give a small model a loss floor far below uniform.

``calibration_batches`` is the calibration corpus of CHAI's offline
phase: the same generator under its own seed.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_streams: int = 8          # distinct Markov streams in the mixture
    branch: int = 4             # out-degree per state (Zipf-weighted)
    zipf_a: float = 1.4


class SyntheticPipeline:
    """batch(i) -> {"tokens": (B, T) int32, "labels": (B, T) int32}."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xC4]))
        v = cfg.vocab_size
        # Per-stream transition tables: state -> `branch` candidate tokens,
        # sampled Zipfian so streams share a head vocabulary but differ in
        # structure.
        self.tables = np.empty((cfg.n_streams, v, cfg.branch), np.int32)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        zipf = 1.0 / ranks ** cfg.zipf_a
        zipf /= zipf.sum()
        for s in range(cfg.n_streams):
            rng = np.random.default_rng(root.integers(2**63))
            perm = rng.permutation(v)          # stream-specific token ranks
            probs = zipf[np.argsort(perm)]
            self.tables[s] = rng.choice(v, size=(v, cfg.branch), p=probs)

    def _gen_rows(self, rng: np.random.Generator, rows: int) -> np.ndarray:
        c = self.cfg
        toks = np.empty((rows, c.seq_len + 1), np.int32)
        stream = rng.integers(c.n_streams, size=rows)
        state = rng.integers(c.vocab_size, size=rows)
        toks[:, 0] = state
        # branch choice is biased to index 0 (predictable) with noise.
        bias = np.minimum(rng.geometric(0.6, size=(rows, c.seq_len)) - 1,
                          c.branch - 1)
        for t in range(c.seq_len):
            state = self.tables[stream, state, bias[:, t]]
            toks[:, t + 1] = state
        return toks

    def batch(self, index: int, *, host_id: int = 0, n_hosts: int = 1):
        """Host-local slice of global batch ``index`` (numpy)."""
        c = self.cfg
        assert c.global_batch % n_hosts == 0
        rows = c.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, index, host_id]))
        toks = self._gen_rows(rng, rows)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_tensor(self, index: int, device=None):
        """Global batch ``index`` as int64 tensors on ``device`` (None:
        CUDA), one host-to-device copy a leaf."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v.astype(np.int64)).to(dev)
                for k, v in self.batch(index).items()}

    def __iter__(self) -> Iterator[dict]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1


def calibration_batches(vocab_size: int, seq_len: int, n_samples: int,
                        batch: int = 8, seed: int = 0xE1B0):
    """Calibration set for CHAI's offline elbow phase (C4 stand-in)."""
    cfg = DataConfig(vocab_size=vocab_size, seq_len=seq_len,
                     global_batch=batch, seed=seed)
    pipe = SyntheticPipeline(cfg)
    for i in range((n_samples + batch - 1) // batch):
        yield pipe.batch(i)["tokens"]
