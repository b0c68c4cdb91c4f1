"""Compare the decode kernels' instances of head dims up to 256 between two
source trees on one GPU: the fused decode pair and the flash decode pair.

Builds ``csrc/chai_fused_decode.cu``, ``paged_chai_fused_decode.cu``,
``flash_decode.cu`` and ``paged_decode.cu`` from this checkout and from
another tree of the repository (for example the parent commit, unpacked
with ``git archive`` into a directory that ``.gitignore`` lists), with
``ptxas -v``, and records for each tree: each source's build seconds (all
four started together), each kernel instance's registers and spill
bytes, the SHA-256 of every output's bytes, and the profiled device time
of each case (20 calls back to back), on ``chip_smoke.py``'s full-width
hd-128 shapes (bf16, page 16, seed 0): chai-llama-7b's (B 4, 32 heads,
25 reps, S 1024, pos 300-1000) and nemotron-4-15b's GQA shape (48 heads
over 8 KV groups, 5 reps a group), each kernel dense and paged. The
wide-head instances (head dim 320) are not built here: a tree without
them measures the same cases.

Each tree is measured in its own process, in the order other, this,
this, other, so that a drift of the card's clocks shows as a difference
between the two runs of one tree.

    python tools/decode_ab.py --other build/parent [--out DIR]

writes ``DIR/decode_ab.json`` (default ``build/decode_ab``, which
``.gitignore`` lists) and prints a summary; the last line is the JSON of
each case's median device times and whether every output's bits agree
across the four runs. Needs a CUDA card and ``nvcc``. The runner, the
profiler and the ``ptxas`` parse are ``tools/_ab.py``'s.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _ab  # noqa: E402
from _ab import PAGE  # noqa: E402
from kv_modes_ab import _digest, _pages, summarize  # noqa: E402

SOURCES = ("chai_fused_decode", "paged_chai_fused_decode", "flash_decode",
           "paged_decode")


def _cases(torch, ck, fk):
    """{name: (kernel name, call)} on inputs made from seed 0."""
    gen = torch.Generator("cuda").manual_seed(0)
    dev = "cuda"
    out = {}
    for shape, b, h, kv, rpg in (("mha", 4, 32, 25, 1),
                                 ("gqa", 4, 48, 8, 5)):
        s, hd = 1024, 128
        q = torch.randn(b, kv * rpg, hd, generator=gen, device=dev)
        k = torch.randn(b, kv, s, hd, generator=gen,
                        device=dev).bfloat16()
        v = torch.randn(b, h if rpg == 1 else kv, s, hd, generator=gen,
                        device=dev).bfloat16()
        pos = torch.randint(300, 1001, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        if rpg == 1:
            h2c = torch.randint(0, kv, (b, h), generator=gen, device=dev,
                                dtype=torch.int32)
        else:
            grp = torch.arange(h, device=dev) // (h // kv)
            h2c = (grp[None] * rpg + torch.randint(
                0, rpg, (b, h), generator=gen, device=dev)).to(torch.int32)
        kp, bt_k, _ = _pages(torch, gen, k)
        vp, bt_v, _ = _pages(torch, gen, v)
        out[f"fused_{shape}"] = (
            "chai_fused_decode",
            lambda a=(q, k, v, h2c, pos), r=rpg: ck.chai_fused_decode(
                *a, reps_per_group=r, ts=PAGE))
        out[f"paged_fused_{shape}"] = (
            "paged_chai_fused_decode",
            lambda a=(q, kp, bt_k, vp, bt_v, h2c, pos), r=rpg:
            ck.paged_chai_fused_decode(*a, reps_per_group=r))
        # the flash pair: every query head over its group's K/V rows
        fq = torch.randn(b, h, hd, generator=gen, device=dev).bfloat16()
        fk_, fv = (torch.randn(b, kv if rpg > 1 else h, s, hd,
                               generator=gen, device=dev).bfloat16()
                   for _ in range(2))
        pool = torch.randn(2 * b * (s // PAGE) + 1, fk_.shape[1], PAGE, hd,
                           generator=gen, device=dev).bfloat16()
        ids = torch.randperm(pool.shape[0] - 1, generator=gen,
                             device=dev)[:2 * b * (s // PAGE)] + 1
        fbt_k, fbt_v = ids.to(torch.int32).reshape(2, b, s // PAGE)
        pool[fbt_k.long()] = fk_.reshape(b, -1, s // PAGE, PAGE,
                                         hd).movedim(2, 1)
        pool[fbt_v.long()] = fv.reshape(b, -1, s // PAGE, PAGE,
                                        hd).movedim(2, 1)
        out[f"flash_{shape}"] = (
            "flash_decode",
            lambda a=(fq, fk_, fv, pos): fk.flash_decode(*a, ts=PAGE))
        out[f"paged_flash_{shape}"] = (
            "paged_decode",
            lambda a=(fq, pool, fbt_k, fbt_v, pos): fk.paged_decode(*a))
    return out


def measure(tree, label, out_dir):
    """One tree, in this process: build (the first run of a tree with
    ptxas -v), then every case's digest and device time."""
    build = _ab.open_tree(tree)
    import torch
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import flash_attention as fk
    resources, seconds = ({}, {})
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources, seconds = _ab.build_verbose(build, SOURCES)
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "build_seconds": seconds, "cases": {}}
    for name, (kernel, call) in _cases(torch, ck, fk).items():
        got = call()
        torch.cuda.synchronize()
        rec["cases"][name] = dict(
            sha256=_digest(got), repeat_equal=_digest(call()) == _digest(
                got),
            device_ms=_ab.device_ms(torch, call, rf"\b{kernel}_kernel\b"))
        del got
        torch.cuda.empty_cache()
    return rec


if __name__ == "__main__":
    _ab.ab_main(__file__, __doc__, measure, summarize)
