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

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "build" / "av_ab"
PAGE = 16


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


def _device_ms(torch, fn, reps=20, flush=None):
    """Device time per launch of ``av_kernel`` over ``reps`` calls of
    ``fn`` (``flush`` before each), from a ``torch.profiler`` trace;
    None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(r"\bav_kernel\b")
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
    """{"<element type> <load width> <layout>": {registers, spills}} from a
    ``ptxas -v`` log of ``chai_av.cu``."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            typ = ("bf16" if "bfloat16" in mangled else
                   "int8" if re.search(r"kernelIa", mangled) else "fp32")
            vec = re.search(r"Li(\d+)E", mangled)
            lay = "paged" if "Paged" in mangled else "dense"
            entry = f"{typ} vec{vec.group(1) if vec else '?'} {lay}"
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
    from repro_torch.kernels import build
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import ref as kref
    if not str(Path(build.__file__).resolve()).startswith(
            str(Path(tree).resolve())):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s")
    resources = {}
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources = _ptxas(build._finish(
            "chai_av", *build._start("chai_av", ("-Xptxas", "-v"))))
    flush_buf = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "cases": {}}
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
            case[f"{side}_device_ms"] = _device_ms(torch, fn)
            case[f"{side}_cold_device_ms"] = (
                case[f"{side}_device_ms"] if name.startswith("s65536")
                else _device_ms(torch, fn, flush=lambda: flush_buf.sum(
                    dtype=torch.int32)))
        rec["cases"][name] = case
    return rec


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
        raise SystemExit("av_ab: no CUDA card")
    out_dir = Path(args.out).resolve()
    other = Path(args.other).resolve()
    runs = []
    for tree, label in ((other, "other_1"), (ROOT, "this_1"),
                        (ROOT, "this_2"), (other, "other_2")):
        env = dict(os.environ, PYTHONPATH=str(Path(tree) / "src"))
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", str(tree), "--label",
             label], env=env, capture_output=True, text=True, check=False)
        if proc.returncode:
            raise SystemExit(f"av_ab: {label} failed:\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    keys = ("dense_device_ms", "paged_device_ms", "dense_cold_device_ms",
            "paged_cold_device_ms")
    medians = {side: {name: {k: statistics.median(
        [r["cases"][name][k] for r in runs
         if r["label"].startswith(side) and r["cases"][name].get(k)])
        for k in keys if any(r["cases"][name].get(k) for r in runs
                             if r["label"].startswith(side))}
        for name in runs[0]["cases"]} for side in ("other", "this")}
    summary = {"card": smi, "runs": runs, "device_ms_median": medians}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "av_ab.json").write_text(json.dumps(summary, indent=1))
    print(smi)
    for r in runs:
        print(r["label"], json.dumps(r["cases"]))
    for side in ("other", "this"):
        print(side, "resources", json.dumps(
            next(r for r in runs if r["label"] == f"{side}_1")["resources"]))
    print(json.dumps(medians))


if __name__ == "__main__":
    main()
