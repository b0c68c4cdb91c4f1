"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--device cpu] [...]``.

Trains the reduced config in fp32 by default, and with ``--full`` the
full config in its own dtype. On one H100 (80 GB) ``--full`` fits an
arch whose bf16 weights and gradients plus fp32 moments (12 bytes a
parameter) leave room for activations: h2o-danube-1.8b or rwkv6-1.6b
(about 22 GB), not chai-llama-7b (6.74 B parameters, about 81 GB before
activations). Multi-device meshes wait for ROADMAP #16.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chai-llama-7b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--full", action="store_true",
                    help="train the full (not reduced) config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg).replace(dtype="float32")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, n_micro=args.n_micro)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, on {device}")
    trainer = Trainer(cfg, data_cfg, tcfg, device=device)
    state, metrics = trainer.run()
    print(f"[train] done: loss={float(metrics['loss']):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
