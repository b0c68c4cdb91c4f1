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
device times. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from av_ab import PAGE, ROOT  # noqa: E402

OUT_DIR = ROOT / "build" / "qk_ab"
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


def _device_ms(torch, fn, reps=20, flush=None):
    """Device time per launch of ``qk_kernel`` over ``reps`` calls of
    ``fn`` (``flush`` before each), from a ``torch.profiler`` trace; None
    when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\bqk_kernel\b")
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if pat.search(e.key)]
        count = sum(e.count for e in hits)
        total = sum(e.device_time_total for e in hits)
        if count and total:
            return total / count / 1e3
    return None


def _ptxas(text):
    """{"<element type> vec<load elements> reps<reps> <layout>":
    {registers, spill_stores, spill_loads}} from a ``ptxas -v`` log of
    ``chai_qk.cu``; ``vec?`` / ``reps?`` where the instance has no such
    template parameter (this tree's instances have no reps parameter,
    the parent's neither)."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            typ = ("bf16" if "bfloat16" in mangled else
                   "int8" if re.search(r"kernelIa", mangled) else "fp32")
            ints = re.findall(r"Li(\d+)E", mangled)
            lay = "paged" if "Paged" in mangled else "dense"
            entry = (f"{typ} vec{ints[0] if ints else '?'} "
                     f"reps{ints[1] if len(ints) > 1 else '?'} {lay}")
            out[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def measure(tree, label):
    """One tree, in this process: build with ptxas -v, check and time
    every case; returns the record."""
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch
    from repro_torch.core import cache
    from repro_torch.kernels import build
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import ref as kref
    if not str(Path(build.__file__).resolve()).startswith(
            str(Path(tree).resolve())):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s")
    resources = {}
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources = _ptxas(build._finish(
            "chai_qk", *build._start("chai_qk", ("-Xptxas", "-v"))))
    flush_buf = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "cases": {}}
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
            case[f"{side}_device_ms"] = _device_ms(torch, fn)
            case[f"{side}_cold_device_ms"] = (
                case[f"{side}_device_ms"] if name.startswith("s65536")
                else _device_ms(torch, fn, flush=lambda: flush_buf.sum(
                    dtype=torch.int32)))
        rec["cases"][name] = case
        del got, want, masked
        torch.cuda.empty_cache()
    return rec


def run_tree(tree, label):
    """``measure`` of one tree in a process of its own; returns its
    record."""
    env = dict(os.environ, PYTHONPATH=str(Path(tree) / "src"))
    proc = subprocess.run(
        [sys.executable, __file__, "--measure", str(tree), "--label", label],
        env=env, capture_output=True, text=True, check=False)
    if proc.returncode:
        raise SystemExit(f"qk_ab: {label} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def medians(runs, side):
    """{case: {key: median over the runs of ``side``}}."""
    mine = [r for r in runs if r["label"].startswith(side)]
    return {name: {k: statistics.median(v) for k in KEYS
                   if (v := [r["cases"][name][k] for r in mine
                             if r["cases"][name].get(k)])}
            for name in mine[0]["cases"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree to compare")
    ap.add_argument("--measure", help="(internal) measure this tree")
    ap.add_argument("--label", default="run")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the results (default %(default)s)")
    args = ap.parse_args()
    if args.measure:
        print(json.dumps(measure(args.measure, args.label)))
        return
    if not args.other:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("qk_ab: no CUDA card")
    other = Path(args.other).resolve()
    runs = [run_tree(tree, label)
            for tree, label in ((other, "other_1"), (ROOT, "this_1"),
                                (ROOT, "this_2"), (other, "other_2"))]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    meds = {side: medians(runs, side) for side in ("other", "this")}
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "qk_ab.json").write_text(json.dumps(
        {"card": smi, "runs": runs, "device_ms_median": meds}, indent=1))
    print(smi)
    for r in runs:
        print(r["label"], json.dumps(r["cases"]))
    for side in ("other", "this"):
        print(side, "resources", json.dumps(
            next(r for r in runs if r["label"] == f"{side}_1")["resources"]))
    print(json.dumps(meds))


if __name__ == "__main__":
    main()
