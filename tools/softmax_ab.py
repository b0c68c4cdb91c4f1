"""Time ``row_softmax`` under launch plans, beside another tree's kernel
and ``torch.softmax``, on one GPU.

Builds ``csrc/row_softmax.cu`` from this checkout (and, with
``--other``, from another tree of the repository, for example the parent
commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists), and at the pipeline lane's layer-0 shape (B 4, 25
reps, S 1024) and the QK pair's long shape (B 1, 25 reps, S = 65,536),
scores of std 2 with one row masked everywhere, records in one process:

* this tree's kernel under its own plan (``softmax_launch_config``) and
  under each plan of ``PLANS`` (vecs, team, cluster; chunks and blocks
  follow), each held to the plain version (2e-5) with the masked row
  zeros;
* the other tree's kernel (its own launcher, as that tree defines it);
* with ``--variants``, each directory's ``row_softmax.cu`` (a variant of
  this tree's source with its launcher) under the same plans;
* ``torch.softmax``;
the profiled device time of each (20 calls), taken in turns three times,
and the ``ptxas -v`` registers and spills of this tree's instances.

    python tools/softmax_ab.py [--other build/parent] [--variants DIR ...]
        [--out DIR]

writes ``DIR/softmax_ab.json`` (default ``build/softmax_ab``, which
``.gitignore`` lists) and prints one line a case; the last line is the
JSON of the median device times. Needs a CUDA card and ``nvcc``. The
profiler and the ``ptxas`` parse are ``tools/_ab.py``'s.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _ab  # noqa: E402
from _ab import ROOT  # noqa: E402

sys.path.insert(0, str(ROOT / "src"))
OUT_DIR = ROOT / "build" / "softmax_ab"
# (vecs, team, cluster) at each shape; the plan's own comes first.
PLANS = {
    "layer0": ((8, 32, 1), (4, 64, 1), (2, 128, 1), (1, 256, 1),
               (1, 128, 2)),
    "s65536": ((8, 256, 8), (4, 256, 8), (2, 256, 8), (8, 256, 4),
               (8, 256, 2)),
}
SHAPES = {"layer0": (4, 25, 1024), "s65536": (1, 25, 65536)}


def _plan(ck, rows, s, vecs, team, cluster):
    """A plan of ``ck.SoftmaxLaunch`` with these sizes (chunks and blocks
    derived as ``softmax_launch_config`` derives them)."""
    base = ck.softmax_launch_config(rows, s)
    threads = team * cluster
    chunks = -(-base.n_vec // (threads * vecs))
    blocks = rows * cluster if cluster > 1 else rows
    return base._replace(vecs=vecs, team=team, rows_per_block=1,
                         cluster=cluster, chunks=chunks, blocks=blocks)


def _build(src, name):
    """``src`` compiled by nvcc with the port's flags into ``name``'s
    library under OUT_DIR; returns the ctypes library."""
    from repro_torch.kernels import build
    lib = OUT_DIR / f"librow_softmax_{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def _variant(src, name):
    """A launcher of this tree's signature from another source."""
    fn = _build(src, name).row_softmax_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(torch, ck, x, cfg, fn=None):
    out = torch.empty_like(x)
    fn = fn or ck._launcher("row_softmax", 2, 8)
    b, r, s = x.shape
    err = fn(x.data_ptr(), out.data_ptr(), b * r, s, cfg.vw, cfg.vecs,
             cfg.team, cfg.rows_per_block, cfg.cluster, cfg.chunks,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row_softmax {cfg}: CUDA error {err}")
    return out


def _other(torch, tree):
    """The other tree's ``row_softmax`` launcher (built here), called with
    the arguments its own wrapper passes."""
    src = Path(tree) / "src/repro_torch/kernels/csrc/row_softmax.cu"
    fn = _build(src, "other").row_softmax_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x):
        out = torch.empty_like(x)
        b, r, s = x.shape
        if fn(x.data_ptr(), out.data_ptr(), b * r, s,
              torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("the other tree's row_softmax failed")
        return out
    return call


def _ptxas():
    """"vecs<loads> vw<width>" of each ``row_softmax.cu`` instance."""
    from repro_torch.kernels import build

    def name(mangled):
        ints = re.findall(r"Li(\d+)E", mangled)
        return f"vecs{ints[0]} vw{ints[1]}" if len(ints) > 1 else mangled
    return _ab.ptxas(build._finish("row_softmax", *build._start(
        "row_softmax", ("-Xptxas", "-v"))), name)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another tree to time beside")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="directories holding a variant row_softmax.cu")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the results (default %(default)s)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("softmax_ab: no CUDA card")
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import ref as kref
    resources = _ptxas()
    other = _other(torch, args.other) if args.other else None
    variant_fns = {Path(d).name: _variant(Path(d) / "row_softmax.cu",
                                          Path(d).name)
                   for d in args.variants}
    gen = torch.Generator("cuda").manual_seed(0)
    record = {"resources": resources, "cases": {}}
    for shape, (b, r, s) in SHAPES.items():
        x = 2 * torch.randn(b, r, s, generator=gen, device="cuda")
        x[0, 1] = kref.NEG_INF
        want = kref.row_softmax_ref(x)
        own = ck.softmax_launch_config(b * r, s)
        variants = {"plan": lambda own=own: _launch(torch, ck, x, own)}
        for vecs, team, cluster in PLANS[shape]:
            cfg = _plan(ck, b * r, s, vecs, team, cluster)
            tag = f"v{vecs}_t{team}_c{cluster}_k{cfg.chunks}"
            variants[tag] = lambda cfg=cfg: _launch(torch, ck, x, cfg)
            for vname, vfn in variant_fns.items():
                variants[f"{vname}:{tag}"] = (
                    lambda cfg=cfg, vfn=vfn: _launch(torch, ck, x, cfg, vfn))
        if other:
            variants["other"] = lambda: other(x)
        case = {"plan": own._asdict(), "variants": {}, "refused": {}}
        for name, fn in list(variants.items()):
            try:                  # a plan this source does not take
                got = fn()
            except RuntimeError as err:
                case["refused"][name] = str(err)
                del variants[name]
                continue
            torch.cuda.synchronize()
            case["variants"][name] = dict(
                max_abs_err=float((got - want).abs().max()),
                masked_row_zero=not bool(got[0, 1].any()),
                repeat_equal=bool(torch.equal(fn(), got)), device_ms=[])
        lib = lambda: torch.softmax(x, -1)  # noqa: E731
        case["torch_softmax_device_ms"] = []
        for _ in range(3):                  # in turns
            for name, fn in variants.items():
                case["variants"][name]["device_ms"].append(
                    _ab.device_ms(torch, fn, r"row_softmax_kernel",
                                  per_call=True))
            case["torch_softmax_device_ms"].append(
                _ab.device_ms(torch, lib, r"(?i)softmax", per_call=True))
        record["cases"][shape] = case
        print(shape, json.dumps(case), flush=True)
    smi = _ab.card()
    record["card"] = smi
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "softmax_ab.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps(resources))
    print(json.dumps({shape: {**{n: statistics.median(v["device_ms"])
                                 for n, v in c["variants"].items()},
                              "torch.softmax": statistics.median(
                                  c["torch_softmax_device_ms"])}
                      for shape, c in record["cases"].items()}))


if __name__ == "__main__":
    main()
