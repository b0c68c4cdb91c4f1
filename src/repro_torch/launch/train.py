"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[--device cpu] [...]``.

Trains the reduced config in fp32 by default, and with ``--full`` the
full config in its own dtype. On one H100 (80 GB) ``--full`` fits an
arch whose bf16 weights and gradients plus fp32 moments (12 bytes a
parameter) leave room for activations: h2o-danube-1.8b or rwkv6-1.6b
(about 22 GB), not chai-llama-7b (6.74 B parameters, about 81 GB before
activations).

Several cards: one process a card, each given ``--world-size``,
``--rank`` and ``--dist-url`` (``tcp://host:port``; rank 0's), e.g.
``for r in 0 1 2 3; do python -m repro_torch.launch.train --world-size 4
--rank $r --dist-url tcp://localhost:29511 & done``. Each process then
takes card ``rank % cards`` and the elastic mesh over the world
(``launch.mesh.elastic_mesh``, ``--mesh-model`` wide on the model axis);
the state is sharded by the logical-axis rules. On one card there is no
mesh, as the reference has none on one device.
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
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--dist-url", default="",
                    help="rank 0's tcp://host:port (world size > 1)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-parallel width of the elastic mesh")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = None
    if args.world_size > 1:
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import elastic_mesh
        if not args.dist_url:
            raise SystemExit("--world-size > 1 needs --dist-url")
        if device.type == "cuda":
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
            device = resolve_device(None)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=args.dist_url, world_size=args.world_size,
            rank=args.rank)
        mesh = elastic_mesh(model_parallel=args.mesh_model,
                            device=device.type)
        print(f"[train] mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    cfg = get_config(args.arch)
    if not args.full:
        cfg = reduced(cfg).replace(dtype="float32")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                          global_batch=args.batch)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir, n_micro=args.n_micro)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, on {device}")
    trainer = Trainer(cfg, data_cfg, tcfg, mesh=mesh, device=device)
    state, metrics = trainer.run()
    loss = metrics["loss"]
    loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
    print(f"[train] done: loss={float(loss):.4f}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
