"""What the A/B tools under ``tools/`` share: the profiled device time, the
``ptxas -v`` parse, the card's name, and the runner that measures two
source trees of the repository in turns, each run in a process of its
own.

A tool defines its cases and ``measure(tree, label, out_dir)`` (one tree,
in this process; returns a JSON-able record with ``resources``, the first
run of a tree building its sources with ``ptxas -v``), and calls
``ab_main``: ``--other DIR`` runs the tree at DIR (for example the parent
commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists) and this checkout in the order other, this, this,
other, so that a drift of the card's clocks shows as a difference between
the two runs of one tree, and writes ``<out>/<name>.json``. Nothing here
imports torch or the port at import time: a tree's run imports its own.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PAGE = 16
ORDER = (("other", "other_1"), ("this", "this_1"), ("this", "this_2"),
         ("other", "other_2"))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=False).stdout.strip()


def device_ms(torch, fn, pattern, *, reps=20, flush=None, per_call=False):
    """Device ms per launch of the kernels whose names match the regex
    ``pattern`` over ``reps`` calls of ``fn`` (``flush`` before each), from
    a ``torch.profiler`` trace; ``per_call``: per call of ``fn`` (a library
    call may launch several kernels). None when three traces hold no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(pattern)
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if pat.search(e.key) and e.device_time_total]
        count = reps if per_call else sum(e.count for e in hits)
        if hits and count:
            return sum(e.device_time_total for e in hits) / count / 1e3
    return None


def ptxas(text, name=lambda mangled: mangled):
    """{instance: {registers, stack, spill_stores, spill_loads}} from a
    ``ptxas -v`` log, each instance named by ``name(mangled name)``."""
    out, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = name(m.group(1))
            out[entry] = {}
        elif entry and (m := re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads", line)):
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry]["registers"] = int(m.group(1))
    return out


def elem_type(mangled: str) -> str:
    """The element type of a kernel instance's first template argument."""
    return ("bf16" if "bfloat16" in mangled else
            "int8" if re.search(r"kernelIa", mangled) else "fp32")


def open_tree(tree):
    """Put ``tree``'s port first on the path; returns its ``build`` module
    (raises unless it is that tree's)."""
    sys.path.insert(0, str(Path(tree) / "src"))
    from repro_torch.kernels import build
    if not str(Path(build.__file__).resolve()).startswith(
            str(Path(tree).resolve())):
        raise RuntimeError(f"imported {build.__file__}, not {tree}'s")
    return build


def build_verbose(build, names, name=lambda mangled: mangled,
                  log_dir=None, label=""):
    """Build the sources ``names`` with ``ptxas -v``, one nvcc each, all
    started together: (every instance's resources, each source's seconds
    from the start; ``log_dir``: each log written there)."""
    t0 = time.monotonic()
    jobs = {n: build._start(n, ("-Xptxas", "-v")) for n in names}
    resources, seconds = {}, {}
    for n, job in jobs.items():
        log = build._finish(n, *job)
        seconds[n] = time.monotonic() - t0
        resources.update(ptxas(log, lambda m, n=n: f"{n} {name(m)}"))
        if log_dir is not None:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            (Path(log_dir) / f"{label}_{n}_nvcc.log").write_text(log)
    return resources, seconds


def sass(build, names):
    """{library: {function: digest of its SASS}} of the built libraries
    ``names`` (``cuobjdump -sass``; each instruction's address and
    encoding comments dropped), so that two trees' instances compare
    instruction for instruction."""
    import hashlib
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for n in names:
        text = subprocess.run(
            [str(tool), "-sass", str(build.BUILD_DIR / f"lib{n}.so")],
            capture_output=True, text=True, check=True).stdout
        # the anonymous namespace's id differs from tree to tree
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", text)
        funcs, name, body = {}, None, []
        for line in text.splitlines() + ["Function : <end>"]:
            m = re.search(r"Function : (\S+)", line)
            if m:
                if name is not None:
                    funcs[name] = hashlib.sha1(
                        "\n".join(body).encode()).hexdigest()
                name, body = m.group(1), []
            elif name is not None:
                ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
                if ins:
                    body.append(ins)
        funcs.pop("<end>", None)
        out[n] = funcs
    return out


def same_sass(a, b):
    """Compare two ``sass`` records: {library: {"functions": n,
    "identical": n, "differ": [names], "only_one_side": [names]}}."""
    out = {}
    for lib in sorted(set(a) | set(b)):
        fa, fb = a.get(lib, {}), b.get(lib, {})
        both = set(fa) & set(fb)
        out[lib] = dict(functions=len(both),
                        identical=sum(fa[f] == fb[f] for f in both),
                        differ=sorted(f for f in both if fa[f] != fb[f]),
                        only_one_side=sorted(set(fa) ^ set(fb)))
    return out


def medians(runs, side, keys):
    """{case: {key: median over ``side``'s runs}} for each of ``keys``
    that the runs hold."""
    mine = [r for r in runs if r["label"].startswith(side)]
    return {case: {k: statistics.median(v) for k in keys
                   if (v := [r["cases"][case][k] for r in mine
                             if r["cases"][case].get(k) is not None])}
            for case in mine[0]["cases"]}


def ab_main(script, doc, measure, summarize):
    """The command line of an A/B tool ``script``: ``--measure TREE``
    prints ``measure(TREE, label, out_dir)`` as JSON (a tree's run);
    ``--other DIR`` runs the two trees in ``ORDER``, each in a process of
    its own, writes ``<out>/<tool>.json`` with the card, the runs and
    ``summarize(runs, out_dir)``, and prints the card, each tree's
    build seconds, instances and spills, and the summary as the last
    line."""
    tool = Path(script).stem
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree to compare")
    ap.add_argument("--measure", help="(internal) measure this tree")
    ap.add_argument("--label", default="run")
    ap.add_argument("--out", default=str(ROOT / "build" / tool),
                    help="directory of the results (default %(default)s)")
    args = ap.parse_args()
    out_dir = Path(args.out).resolve()
    if args.measure:
        print(json.dumps(measure(args.measure, args.label, out_dir)))
        return
    if not args.other:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA card")
    trees = {"other": Path(args.other).resolve(), "this": ROOT}
    runs = []
    for side, label in ORDER:
        tree = trees[side]
        proc = subprocess.run(
            [sys.executable, str(script), "--measure", str(tree), "--label",
             label, "--out", str(out_dir)],
            env=dict(os.environ, PYTHONPATH=str(tree / "src")),
            capture_output=True, text=True, check=False)
        if proc.returncode:
            raise SystemExit(f"{tool}: {label} failed:\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    smi = card()
    summary = summarize(runs, out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tool}.json").write_text(json.dumps(
        {"card": smi, "runs": runs, "summary": summary}, indent=1))
    print(smi)
    for side in ("other", "this"):
        first = next(r for r in runs if r["label"] == f"{side}_1")
        res = first["resources"]
        print(side, "build seconds", json.dumps(first.get("build_seconds")))
        print(side, "instances", len(res), json.dumps(res))
        print(side, "with spills", json.dumps(
            {k: v for k, v in res.items()
             if v.get("spill_stores") or v.get("spill_loads")}))
    print(json.dumps(summary))
