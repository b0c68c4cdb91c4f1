"""Serving CLI: ``python -m repro_torch.launch.serve [--device cuda]``.

Serves synthetic prompts through the ``ServingEngine`` with random weights
made from a seed, and reports wall time, tokens/s, TTFT and KV bytes.
The default engine is the reference's: the continuous scheduler on the
paged KV layout (``--scheduler cohort`` and ``--kv-layout dense`` choose
the others). Full width by default (chai-llama-7b in bf16 needs a GPU
with ~20 GB free; ``--arch`` also takes nemotron-4-15b (GQA), gemma2-9b
(local and global layers, softcaps), h2o-danube-1.8b (all local),
gemma3-4b (local and global layers, qk_norm, head dim 320),
deepseek-moe-16b and qwen3-moe-30b-a3b (MoE FFN; qwen3 needs ~61 GB),
internvl2-76b (141 GB in bf16: ``--reduced`` only on one card) and
musicgen-large (frontend archs, served on tokens), recurrentgemma-9b
(RG-LRU and local layers, ~21 GB) and rwkv6-1.6b (RWKV layers, no
attention: ``--no-chai``)); ``--reduced`` serves the CPU-sized config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chai-llama-7b",
                    choices=list_configs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--scheduler", choices=("continuous", "cohort"),
                    default="continuous")
    ap.add_argument("--kv-layout", choices=("paged", "dense"),
                    default="paged",
                    help="KV layout of the continuous scheduler")
    ap.add_argument("--no-chai", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU-sized reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if not args.no_chai:
        cfg = cfg.with_chai(enabled=True)
    gen = torch.Generator(device).manual_seed(0)
    params = tfm.init_params(cfg, gen, device)
    ecfg = EngineConfig(batch_slots=args.slots, max_seq=args.max_seq,
                        scheduler=args.scheduler, kv_layout=args.kv_layout,
                        use_chai=not args.no_chai)
    eng = ServingEngine(cfg, params, ecfg, device=device)

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len),
                   max_new_tokens=args.max_new, uid=i)
    t0 = time.time()
    done = eng.run()
    wall = time.time() - t0

    n_tok = sum(len(r.generated) for r in done)
    print(f"[serve] arch={cfg.name} device={device} chai={eng.chai_on} "
          f"scheduler={ecfg.scheduler} kv_layout={ecfg.kv_layout} "
          f"requests={len(done)} tokens={n_tok} "
          f"decode_steps={eng.steps_executed}")
    print(f"[serve] wall={wall:.3f}s tok/s={n_tok / wall:.1f} "
          f"ttft_mean={np.mean([r.ttft for r in done]) * 1e3:.1f}ms "
          f"lat_mean={np.mean([r.latency for r in done]) * 1e3:.1f}ms "
          f"redispatched={eng.redispatched}")
    kc, km = eng.kv_bytes(chai=True), eng.kv_bytes(chai=False)
    saving = f"{100 * (1 - kc / km):.1f}%" if km else "n/a (no KV cache)"
    print(f"[serve] kv_bytes (analytic, at capacity) chai={kc:,} mha={km:,} "
          f"saving={saving}")
    if eng.paged:
        print(f"[serve] paged kv_bytes peak={eng.kv_bytes_peak():,} "
              f"capacity={eng.kv_bytes_capacity():,}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
