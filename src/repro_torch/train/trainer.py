"""Fault-tolerant training loop: checkpoint and restart, straggler
detection (the reference's ``train/trainer.py``).

Every piece of state is either in the checkpoint (params, optimizer,
step) or a pure function of the step counter (the data pipeline), so
killing the process at any point and calling ``Trainer.run`` again
resumes exactly. Per-step wall times feed an EWMA; a step slower than
``straggler_factor`` times it fires ``on_straggler`` (counted and logged
here; ``step_delay_hook`` injects delays in tests). The step's clock
closes on reading its loss, so on the GPU it times the step's device
work, not only its launches.

The int8 cross-pod step (``compress_pods``) and a sharded mesh wait for
the sharding tooling (ROADMAP #16).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts_mod


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    n_micro: int = 1                  # >1 => microbatched accumulation
    compress_pods: bool = False       # int8 cross-pod gradient compression
    straggler_factor: float = 3.0
    lr_kw: Optional[dict] = None


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig, *,
                 step_delay_hook: Optional[Callable[[int], float]] = None,
                 on_straggler: Optional[Callable[[int, float], None]] = None,
                 device=None):
        if tcfg.compress_pods:
            raise ValueError("compress_pods needs a device mesh with a pod "
                             "axis: the sharding tooling waits for "
                             "ROADMAP #16")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        self.pipe = SyntheticPipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_delay_hook = step_delay_hook
        self.on_straggler = on_straggler
        self.straggler_steps: list = []
        self._ewma = None
        self._compiled = True

        lr_kw = tcfg.lr_kw or dict(total=tcfg.total_steps,
                                   warmup=max(2, tcfg.total_steps // 10))
        if tcfg.n_micro > 1:
            self._step_fn = ts_mod.make_microbatched_train_step(
                cfg, n_micro=tcfg.n_micro, lr_kw=lr_kw)
        else:
            self._step_fn = steps_mod.make_train_step(cfg, lr_kw=lr_kw)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """Fresh params from a torch generator seeded with ``tcfg.seed``
        on the trainer's device, and a fresh optimizer state."""
        gen = torch.Generator(self.device).manual_seed(self.tcfg.seed)
        params = tfm.init_params(self.cfg, gen, self.device)
        return {"params": params, "opt": adamw.init(params)}

    # -- the loop ------------------------------------------------------------
    def run(self, *, max_steps: Optional[int] = None):
        state = self.init_state()
        start = 0
        restored = self.ckpt.restore_latest(state, device=self.device)
        if restored is not None:
            start, state, extra = restored
            print(f"[trainer] restored step {start} "
                  f"(data resumes at batch {start})")
        stop = min(self.tcfg.total_steps,
                   start + max_steps if max_steps else self.tcfg.total_steps)
        metrics = {"loss": float("nan"), "ce": float("nan")}
        if start >= stop:     # resumed past the end: a fresh step's metrics
            batch = self.pipe.global_batch_tensor(start, self.device)
            return self._one_step(state, batch)
        for step in range(start, stop):
            batch = self.pipe.global_batch_tensor(step, self.device)
            t0 = time.time()
            if self.step_delay_hook is not None:
                time.sleep(self.step_delay_hook(step))
            state, metrics = self._one_step(state, batch)
            loss = float(metrics["loss"])        # the step's device sync
            dt = time.time() - t0
            self._straggler_check(step, dt)
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"[trainer] step {step + 1} loss={loss:.4f} "
                      f"ce={float(metrics['ce']):.4f} {dt*1e3:.0f}ms")
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == stop:
                self.ckpt.save(step + 1, state,
                               extra={"data_batch": step + 1})
        return state, metrics

    def _one_step(self, state, batch):
        params, opt, metrics = self._step_fn(state["params"], state["opt"],
                                             batch)
        return {"params": params, "opt": opt}, metrics

    def _straggler_check(self, step, dt):
        if self._ewma is None:
            self._ewma = dt          # first step: warm-up of the caches
            self._compiled = False
            return
        if not self._compiled:
            self._ewma = dt          # second step: first steady-state time
            self._compiled = True
            return
        if dt > self.tcfg.straggler_factor * self._ewma and step > 2:
            self.straggler_steps.append((step, dt))
            if self.on_straggler is not None:
                self.on_straggler(step, dt)
            else:
                print(f"[trainer] straggler: step {step} took {dt:.2f}s "
                      f"(ewma {self._ewma:.2f}s)")
        self._ewma = 0.9 * self._ewma + 0.1 * dt
