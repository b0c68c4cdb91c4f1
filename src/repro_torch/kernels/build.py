"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain ``extern "C"`` launcher and is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/lib<name>.so csrc/<name>.cu

into ``build/kernels/`` at the repository root (listed in ``.gitignore``).
A library newer than its source and than every header in ``csrc/`` (the
tile steps the decode kernels and the prefill kernels include) is reused. A missing ``nvcc`` or
a failed build raises: nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("chai_fused_decode", "paged_chai_fused_decode", "flash_prefill",
           "paged_prefix_attend")
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
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


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
    cmd = [nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
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


def build_all(names=KERNELS, extra_flags=()):
    """Compile every stale kernel, one nvcc per source, all started
    together. Returns {name: compiler output} for the ones it built."""
    jobs = {n: _start(n, extra_flags) for n in names if _stale(n)}
    return {n: _finish(n, proc, tmp) for n, (proc, tmp) in jobs.items()}


def load(name) -> ctypes.CDLL:
    """The kernel's shared library, built first if missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        _LIBS[name] = lib
    return lib
