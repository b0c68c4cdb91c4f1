"""Compare the QK kernels (``chai_qk``, ``chai_qk_i8``, ``paged_chai_qk``)
between two source trees on one GPU.

Builds ``csrc/chai_qk.cu`` from this checkout and from another tree of
the repository (for example a parent commit, unpacked with ``git
archive`` into a directory that ``.gitignore`` lists), with ``ptxas -v``,
and records for each tree:

* each kernel instance's registers and spill bytes;
* the profiled device time of the three kernels, warm (20 calls back to
  back) and L2-cold (256 MB read before every call), at the pipeline
  lane's layer-0 shapes (B 4, S 1024 in pages of 16, hd 128, pos 200,
  320, 450 and 500; MHA: 25 reps, each its own K row; GQA: 8 K rows of 5
  reps; pages shuffled, the null page 0 past each row's pos) and at S =
  65,536 (B 1, 25 reps, pos S - 1; K is 419 MB in bf16, cold by size);
  bf16 K, its int8 codes with row scales (``chai_qk_i8``) and its raw
  int8 codes read as values (``chai_qk`` / ``paged_chai_qk``);
* each case's max abs error against the plain PyTorch version
  (``kernels.ref``), and whether paged == dense bitwise.

A tree whose wrappers refuse raw int8 K skips those cases (the parent
of the int8 mode does). Each tree is measured in its own process, in the
order other, this, this, other, so that a drift of the card's clocks
shows as a difference between the two runs of one tree.

    python tools/qk_ab.py --other build/parent [--out DIR]

writes ``DIR/qk_ab.json`` (default ``build/qk_ab``, which ``.gitignore``
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


def _pages(torch, gen, k, pos):
    """(pool, block table) holding dense K (B, KV, S, hd) at shuffled
    pages, the null page 0 past each row's pos."""
    b, kv, s, hd = k.shape
    n = s // PAGE
    n_pool = b * n + 1
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:b * n]
    bt = (ids + 1).reshape(b, n).to(torch.int32)
    pool = torch.zeros((n_pool, kv, PAGE, hd), dtype=k.dtype, device="cuda")
    pool[bt.long()] = k.reshape(b, kv, n, PAGE, hd).movedim(2, 1)
    for i, p in enumerate(pos.tolist()):
        bt[i, p // PAGE + 1:] = 0
    return pool, bt


def _cases(torch, ck, kref, cache):
    """{name: (dense call, paged call or None, plain call)} on inputs made
    from seed 0."""
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for shape, b, kv, rpg, s in (("layer0_mha", 4, 25, 1, 1024),
                                 ("layer0_gqa", 4, 8, 5, 1024),
                                 ("s65536", 1, 25, 1, 65536)):
        q = torch.randn(b, kv * rpg, 128, generator=gen, device="cuda")
        k = torch.randn(b, kv, s, 128, generator=gen, device="cuda").to(
            torch.bfloat16)
        pos = (torch.tensor([200, 320, 450, 500], dtype=torch.int32,
                            device="cuda") if s == 1024 else
               torch.full((b,), s - 1, dtype=torch.int32, device="cuda"))
        kw = dict(reps_per_group=rpg)
        kq, ks = cache.quant_rows(k)
        codes = cache.plain_int8(k.float() * 40)
        for mode, kk in (("bf16", k), ("int8_scaled", kq),
                         ("int8_codes", codes)):
            if mode == "int8_scaled":
                out[f"{shape}_{mode}"] = (
                    lambda a=(q, kq, ks, pos), kw=kw: ck.chai_qk_i8(
                        *a, ts=PAGE, **kw), None,
                    lambda a=(q, kq, ks, pos), kw=kw: kref.chai_qk_i8_ref(
                        *a, **kw))
                continue
            pool, bt = _pages(torch, gen, kk, pos)
            out[f"{shape}_{mode}"] = (
                lambda a=(q, kk, pos), kw=kw: ck.chai_qk(*a, ts=PAGE, **kw),
                lambda a=(q, pool, bt, pos), kw=kw: ck.paged_chai_qk(*a,
                                                                     **kw),
                lambda a=(q, kk, pos), kw=kw: kref.chai_qk_ref(*a, **kw))
    return out


def _instance(mangled):
    """"<element type> vec<load elements> reps<reps> <layout>" of a
    ``chai_qk.cu`` instance; ``vec?`` / ``reps?`` where the instance has
    no such template parameter (this tree's instances have no reps
    parameter, the parent's neither)."""
    ints = re.findall(r"Li(\d+)E", mangled)
    return (f"{_ab.elem_type(mangled)} vec{ints[0] if ints else '?'} "
            f"reps{ints[1] if len(ints) > 1 else '?'} "
            f"{'paged' if 'Paged' in mangled else 'dense'}")


def measure(tree, label, out_dir):
    """One tree, in this process: build with ptxas -v, check and time
    every case; returns the record."""
    build = _ab.open_tree(tree)
    import torch
    from repro_torch.core import cache
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import ref as kref
    resources, seconds = ({}, {})
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources, seconds = _ab.build_verbose(build, ("chai_qk",),
                                               _instance)
    flush_buf = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "build_seconds": seconds, "cases": {}}
    for name, (dense, paged, plain) in _cases(torch, ck, kref,
                                              cache).items():
        try:
            got = dense()
        except TypeError as err:          # a tree without raw int8 K
            rec["cases"][name] = dict(refused=str(err))
            continue
        torch.cuda.synchronize()
        want = plain()
        masked = want == kref.NEG_INF
        case = dict(max_abs_err=float((got - want).abs().max()),
                    masks_equal=bool(torch.equal(got == kref.NEG_INF,
                                                 masked)),
                    repeat_equal=bool(torch.equal(dense(), got)))
        if paged is not None:
            case["paged_equals_dense"] = bool(torch.equal(paged(), got))
        for side, fn in (("dense", dense), ("paged", paged)):
            if fn is None:
                continue
            case[f"{side}_device_ms"] = _ab.device_ms(torch, fn,
                                                      r"\bqk_kernel\b")
            case[f"{side}_cold_device_ms"] = (
                case[f"{side}_device_ms"] if name.startswith("s65536")
                else _ab.device_ms(torch, fn, r"\bqk_kernel\b",
                                   flush=lambda: flush_buf.sum(
                                       dtype=torch.int32)))
        rec["cases"][name] = case
        del got, want, masked
        torch.cuda.empty_cache()
    return rec


def summarize(runs, out_dir):
    return {side: _ab.medians(runs, side, KEYS)
            for side in ("other", "this")}


if __name__ == "__main__":
    _ab.ab_main(__file__, __doc__, measure, summarize)
