"""Compare the AV pair (``chai_av``, ``paged_chai_av``) between two source
trees on one GPU.

Builds ``csrc/chai_av.cu`` from this checkout and from another tree of
the repository (for example a parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), with ``ptxas -v``,
and records for each tree:

* each kernel instance's registers and spill bytes;
* the profiled device time of both kernels, warm (20 calls back to back)
  and L2-cold (256 MB read before every call), at ``chip_smoke.py``'s
  layer-0 shapes (B 4, H 32 heads over 25 A rows, S 1024 in pages of 16,
  hd 128; bf16 and fp32 V; pages shuffled, the null page 0 past each
  row's pos) and at S = 65,536 (B 1, bf16; V is 537 MB, cold by size);
* each case's max abs error against the plain PyTorch version
  (``kernels.ref``), and whether paged == dense bitwise.

A tree whose wrapper refuses int8 V skips the int8 case (the parent of
the int8 mode does). Each tree is measured in its own process, in the
order other, this, this, other, so that a drift of the card's clocks
shows as a difference between the two runs of one tree.

    python tools/av_ab.py --other build/parent [--out DIR]

writes ``DIR/av_ab.json`` (default ``build/av_ab``, which ``.gitignore``
lists) and prints a summary; the last line is the JSON of the median
device times. Needs a CUDA card and ``nvcc``. The runner, the profiler
and the ``ptxas`` parse are ``tools/_ab.py``'s.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _ab  # noqa: E402
from _ab import PAGE  # noqa: E402

KEYS = ("dense_device_ms", "paged_device_ms", "dense_cold_device_ms",
        "paged_cold_device_ms")


def _cases(torch, ck, kref):
    """{name: (dense call, paged call, plain call)} on inputs made from
    seed 0."""
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for name, b, h, r, s, dtype in (
            ("layer0_bf16", 4, 32, 25, 1024, torch.bfloat16),
            ("layer0_fp32", 4, 32, 25, 1024, torch.float32),
            ("layer0_int8", 4, 32, 25, 1024, torch.int8),
            ("s65536_bf16", 1, 32, 25, 65536, torch.bfloat16)):
        a = torch.softmax(2 * torch.randn(b, r, s, generator=gen,
                                          device="cuda"), -1)
        h2c = torch.randint(0, r, (b, h), generator=gen, device="cuda",
                            dtype=torch.int32)
        v = torch.randn(b, h, s, 128, generator=gen, device="cuda")
        v = (v * 40).clamp(-128, 127).to(dtype) if dtype == torch.int8 \
            else v.to(dtype)
        n = s // PAGE
        n_pool = b * n + 1
        ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[
            :b * n] + 1
        bt = ids.reshape(b, n).to(torch.int32)
        pool = torch.zeros((n_pool, h, PAGE, 128), dtype=dtype,
                           device="cuda")
        pool[bt.long()] = v.reshape(b, h, n, PAGE, 128).movedim(2, 1)
        if s == 1024:              # the null page 0 past each row's pos
            for i, p in enumerate((200, 320, 450, 500)[:b]):
                bt[i, p // PAGE + 1:] = 0
            v = pool[bt.long()].movedim(1, 2).reshape(b, h, s, 128)
        out[name] = (
            lambda a=a, v=v, h2c=h2c: ck.chai_av(a, v, h2c, ts=PAGE),
            lambda a=a, p=pool, bt=bt, h2c=h2c: ck.paged_chai_av(a, p, bt,
                                                                 h2c),
            lambda a=a, v=v, h2c=h2c: kref.chai_av_ref(a, v, h2c))
    return out


def _instance(mangled):
    """"<element type> vec<load width> <layout>" of a ``chai_av.cu``
    instance."""
    vec = re.search(r"Li(\d+)E", mangled)
    return (f"{_ab.elem_type(mangled)} vec{vec.group(1) if vec else '?'} "
            f"{'paged' if 'Paged' in mangled else 'dense'}")


def measure(tree, label, out_dir):
    """One tree, in this process: build with ptxas -v, check and time
    every case; returns the record."""
    build = _ab.open_tree(tree)
    import torch
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import ref as kref
    resources, seconds = ({}, {})
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources, seconds = _ab.build_verbose(build, ("chai_av",),
                                               _instance)
    flush_buf = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "build_seconds": seconds, "cases": {}}
    for name, (dense, paged, plain) in _cases(torch, ck, kref).items():
        try:
            got = dense()
        except TypeError as err:          # a tree without int8 V
            rec["cases"][name] = dict(refused=str(err))
            continue
        torch.cuda.synchronize()
        want = plain()
        case = dict(max_abs_err=float((got - want).abs().max()),
                    paged_equals_dense=bool(torch.equal(paged(), got)))
        for side, fn in (("dense", dense), ("paged", paged)):
            case[f"{side}_device_ms"] = _ab.device_ms(torch, fn,
                                                      r"\bav_kernel\b")
            case[f"{side}_cold_device_ms"] = (
                case[f"{side}_device_ms"] if name.startswith("s65536")
                else _ab.device_ms(torch, fn, r"\bav_kernel\b",
                                   flush=lambda: flush_buf.sum(
                                       dtype=torch.int32)))
        rec["cases"][name] = case
    return rec


def summarize(runs, out_dir):
    return {side: _ab.medians(runs, side, KEYS)
            for side in ("other", "this")}


if __name__ == "__main__":
    _ab.ab_main(__file__, __doc__, measure, summarize)
