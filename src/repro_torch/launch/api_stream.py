"""Streaming and multi-turn serving through the ``LLM`` front door.

``python -m repro_torch.launch.api_stream [--reduced] [--device cuda]``

1. ``LLM.generate``: a batch with per-request ``SamplingParams`` (one
   greedy, one seeded top-k / top-p);
2. ``LLM.stream``: incremental chunks, the first at admission;
3. ``abort``: a stream cancelled after its first chunk; the page pools
   drain back to their baseline;
4. ``Session``: a 3-turn chat over the prefix cache; turns 2 and 3 alias
   the pages earlier turns filled and prefill only the new message.

Full-width nemotron-4-15b by default (random weights from a seed, bf16;
a GPU with ~32 GB free); ``--reduced`` serves the CPU-sized config.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as tfm
from repro_torch.serving import LLM, EngineConfig, SamplingParams, Session


def _pool_counters(core):
    return (core.dense_pool.counters(),
            core.chai_pool.counters() if core.chai_pool else None)


ARCH = "nemotron-4-15b"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU-sized reduced config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(ARCH)
    if args.reduced:
        cfg = reduced(cfg, n_layers=2, d_model=32, d_ff=64, vocab=64)
    cfg = cfg.with_chai(enabled=True, warmup_tokens=3)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    llm = LLM(cfg, params, EngineConfig(batch_slots=2, max_seq=128,
                                        prefix_cache=True), device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=12) for _ in range(2)]

    # 1. a batch with per-request sampling
    outs = llm.generate(prompts,
                        [SamplingParams(max_new_tokens=12),
                         SamplingParams(temperature=0.8, top_k=16,
                                        top_p=0.95, seed=7,
                                        max_new_tokens=12)])
    for o in outs:
        print(f"[generate] uid={o.uid} finish={o.finish_reason} "
              f"tokens={o.token_ids}")

    # 2. a stream
    print("[stream]", end=" ", flush=True)
    for chunk in llm.stream(prompts[0], SamplingParams(max_new_tokens=12)):
        print(*chunk.token_ids, end=" ", flush=True)
    print("(done)")

    # 3. an abort mid-stream; the pools drain to their baseline
    base = _pool_counters(llm.core)
    it = llm.stream(rng.integers(0, cfg.vocab_size, size=12),
                    SamplingParams(max_new_tokens=64))
    first = next(it)
    llm.abort(first.uid)
    tail = list(it)
    print(f"[abort] after 1 chunk: terminal chunk "
          f"{tail[-1].finish_reason!r}, pools back to baseline = "
          f"{_pool_counters(llm.core) == base}")

    # 4. a 3-turn session over the prefix cache
    ses = Session(llm, SamplingParams(max_new_tokens=8))
    for turn, n_msg in enumerate((24, 8, 8)):   # a long opener fills pages
        out = ses.send(rng.integers(0, cfg.vocab_size, size=n_msg))
        print(f"[session] turn {turn + 1}: prompt="
              f"{len(out.prompt_token_ids)} cached={out.cached_tokens} "
              f"prefilled={out.prefill_tokens}")
    print(f"[session] prefix-cache stats: {llm.core.prefix_stats()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
