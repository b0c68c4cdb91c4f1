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

With a ``mesh`` the state lives as DTensors placed by the logical-axis
rules (``_shardings``; restored onto them), each batch is made split on
the batch (``_batch_sharding``), and the step runs the sharded path.
``compress_pods`` takes the int8 cross-pod step, on a mesh with a
``pod`` axis.
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
from repro_torch.optim import adamw, compression
from repro_torch.sharding import rules
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
                 mesh=None, device=None):
        if tcfg.compress_pods and (
                mesh is None or "pod" not in mesh.mesh_dim_names):
            raise ValueError("compress_pods needs a device mesh with a "
                             "'pod' axis (launch.mesh.make_mesh)")
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.device_type)
        self.pipe = SyntheticPipeline(data_cfg)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.step_delay_hook = step_delay_hook
        self.on_straggler = on_straggler
        self.straggler_steps: list = []
        self._ewma = None
        self._compiled = True

        lr_kw = tcfg.lr_kw or dict(total=tcfg.total_steps,
                                   warmup=max(2, tcfg.total_steps // 10))
        if tcfg.compress_pods:
            self._step_fn = ts_mod.make_compressed_train_step(
                cfg, mesh, lr_kw=lr_kw)
        elif tcfg.n_micro > 1:
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
        if self.mesh is not None:
            params = rules.place_tree(params,
                                      self._shardings(None)["params"])
        state = {"params": params, "opt": adamw.init(params)}
        if self.tcfg.compress_pods:
            state["residual"] = compression.compress_residual_init(params)
        return state

    def _shardings(self, state):
        """The state's shardings on the mesh (None without one): the
        parameters, moments and residual by the rules, the step
        replicated."""
        if self.mesh is None:
            return None
        pshapes, plog = tfm.param_structs(self.cfg)
        psh = rules.tree_shardings(pshapes, plog, self.mesh)
        oshapes, olog = adamw.state_structs(pshapes, plog)
        osh = rules.tree_shardings(oshapes, olog, self.mesh)
        sh = {"params": psh, "opt": osh}
        if state is not None and "residual" in state:
            sh["residual"] = psh
        return sh

    def _batch_sharding(self):
        if self.mesh is None:
            return None
        b, t = self.pipe.cfg.global_batch, self.pipe.cfg.seq_len
        return {k: rules.sharding_for((b, t), ("batch", None), self.mesh)
                for k in ("tokens", "labels")}

    # -- the loop ------------------------------------------------------------
    def run(self, *, max_steps: Optional[int] = None):
        state = self.init_state()
        start = 0
        restored = self.ckpt.restore_latest(
            state, device=self.device, shardings=self._shardings(state))
        if restored is not None and self.mesh is not None:
            # the step counter restores replicated; keep it a plain tensor
            st = restored[1]["opt"].step
            st = st.full_tensor() if hasattr(st, "full_tensor") else st
            restored[1]["opt"] = restored[1]["opt"]._replace(step=st)
        if restored is not None:
            start, state, extra = restored
            print(f"[trainer] restored step {start} "
                  f"(data resumes at batch {start})")
        stop = min(self.tcfg.total_steps,
                   start + max_steps if max_steps else self.tcfg.total_steps)
        metrics = {"loss": float("nan"), "ce": float("nan")}
        if start >= stop:     # resumed past the end: a fresh step's metrics
            batch = self.pipe.global_batch_array(
                start, self._batch_sharding(), self.device)
            return self._one_step(state, batch)
        for step in range(start, stop):
            batch = self.pipe.global_batch_array(
                step, self._batch_sharding(), self.device)
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
        import contextlib
        from torch.distributed.tensor.experimental import implicit_replication
        cm = (implicit_replication() if self.mesh is not None
              else contextlib.nullcontext())
        with cm:
            if "residual" in state:
                params, opt, res, metrics = self._step_fn(
                    state["params"], state["opt"], state["residual"], batch)
                return {"params": params, "opt": opt,
                        "residual": res}, metrics
            params, opt, metrics = self._step_fn(state["params"],
                                                 state["opt"], batch)
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
