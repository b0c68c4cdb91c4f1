"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` launcher
``<kernel>_launch`` for each kernel it holds (``SOURCE_OF`` names the
kernels that share a source with others: the pipeline's QK and AV
bodies) and is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
A variant (``VARIANTS``) is a kernel's source built again with extra
compile definitions into a library of its own: the wide head's (head dim
fixed at 320, gemma3-4b's), ``lib<kernel>_wide.so`` for the fused decode
pair's serving pairings and the prefill pair, and
``lib<kernel>_wide_kv.so`` for the fused pair's general pairings.
A library newer than its source and than every header in ``csrc/`` (the
tile steps the decode, relay, prefill and flash decode kernels include)
is reused. A missing ``nvcc`` or a failed build raises: nothing falls
back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("chai_fused_decode", "paged_chai_fused_decode", "flash_prefill",
           "paged_prefix_attend", "relay_prefix_decode", "chai_qk",
           "row_softmax", "chai_av", "flash_decode", "paged_decode")
# Kernels whose launcher lives in another kernel's source.
SOURCE_OF = {"chai_qk_i8": "chai_qk", "paged_chai_qk": "chai_qk",
             "paged_chai_av": "chai_av"}
# Libraries built from a kernel's source with extra compile definitions:
# {library: (source, flags)}. The wide-head instances (gemma3-4b's
# head_dim 320) get libraries of their own, so the instances of head dims
# up to 256 keep their code and every library builds in parallel: the
# fused decode pair's serving pairings (``_wide``) and general pairings
# (``_wide_kv``), and the prefill pair (``_wide``).
_FUSED = ("chai_fused_decode", "paged_chai_fused_decode")
VARIANTS = {
    **{f"{k}_wide": (k, ("-DCHAI_FIXED_HD=320",)) for k in _FUSED},
    **{f"{k}_wide_kv": (k, ("-DCHAI_FIXED_HD=320", "-DCHAI_WIDE_GENERAL=1"))
       for k in _FUSED},
    **{f"{k}_wide": (k, ("-DFLASH_FIXED_HD=320",))
       for k in ("flash_prefill", "paged_prefix_attend")}}
LIBRARIES = KERNELS + tuple(VARIANTS)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _paths(name):
    source = VARIANTS.get(name, (name,))[0]
    return CSRC / f"{source}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name) -> bool:
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in (src, *CSRC.glob("*.cuh")))
    return lib.stat().st_mtime < newest


def _start(name, extra_flags=()):
    """Start one nvcc; returns (process, temp output path)."""
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    defs = VARIANTS[name][1] if name in VARIANTS else ()
    cmd = [nvcc_path(), *NVCC_FLAGS, *defs, *extra_flags, "-o", str(tmp),
           str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name, proc, tmp):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _paths(name)[1])
    return out


def build_all(names=LIBRARIES, extra_flags=(), seconds=None):
    """Compile every stale library, one nvcc per library, all started
    together. Returns {name: compiler output} for the ones it built; a
    ``seconds`` dict given receives each one's time from the start of all
    to its own end."""
    t0 = time.monotonic()
    jobs = {n: _start(n, extra_flags) for n in names if _stale(n)}

    def finish(name):
        out = _finish(name, *jobs[name])
        if seconds is not None:
            seconds[name] = time.monotonic() - t0
        return out
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        outs = dict(zip(jobs, pool.map(finish, jobs)))
    return outs


def load(name) -> ctypes.CDLL:
    """The shared library that holds kernel ``name``'s launcher (or the
    variant library ``name``), built first if missing or stale."""
    name = SOURCE_OF.get(name, name)
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib
