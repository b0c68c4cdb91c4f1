"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. environment: versions, the card's name and power limit, TF32 off;
2. build: every CUDA kernel of the serving paths, one ``nvcc`` per
   source, all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the full-width main path gives it (fp32 and bf16 K/V) and at a
   GQA shape, with CUDA-event timings and the bound the card could reach;
   the paged kernel also on shuffled pages, on a WARMUP-like row whose K
   table is all null page 0, and bitwise (``torch.equal``) against the
   dense kernel at page = tile; the prefill kernels at a full chunk's
   shapes (bf16 and fp32, GQA, ``flash_prefill`` finalized and as state,
   with an offset, ``paged_prefix_attend`` on shuffled pages at plen
   128/256/384 and at plen 0, which must be the merge identity exactly);
4. a reduced model on the card against the same model on the CPU (the
   plain path): teacher-forced cohort steps, logits held at 1e-4; then
   the continuous engine, paged and dense, cuda against cpu; then the
   chunked continuous engine, cuda against cpu;
5. the cohort main path: full-width chai-llama-7b (bf16, random weights
   from a seed) served through the cohort ``ServingEngine`` — 4
   requests, 32 new tokens each — with every kernel's launches counted
   over that run, and the kernel held against its plain version on the
   layer-0 tensors of the first STEADY step; then the same requests with
   CHAI off (the MHA baseline): exactly 32 ``flash_decode`` launches per
   decode step, no eager decode attention;
6. the continuous main path: the same model through the default
   continuous ``ServingEngine``, 4 slots, 8 requests, once per KV layout
   (paged, then dense), with the launches counted over each run, the
   greedy tokens of the two layouts identical, the KV bytes falling at
   every CLUSTER transition and both pools empty at the end; then the MHA
   baseline (``use_chai=False``) on the same traffic and layouts: every
   decode step launches ``paged_decode`` (paged) or ``flash_decode``
   (dense) once per layer and nothing else, the eager decode attention
   never runs, paged == dense tokens, wall, tok/s and step ms logged
   beside the CHAI runs', and both kernels held against their plain
   versions (and bitwise against each other) on the layer-0 inputs of the
   first decode step with every slot occupied, timed there beside
   PyTorch's ``scaled_dot_product_attention``;
7. the chunked continuous path: the paged run of phase 6 again with
   ``prefill_chunk_tokens=128`` (20 chunks, so 640 launches of each
   prefill kernel), its greedy tokens held against phase 6's on every
   step whose phase-6 top-2 logit margin exceeds ``CHUNK_MARGIN``, the
   prefill kernels held against their plain versions on the layer-0
   inputs of its chunks and timed there;
8. the prefix-cache and relay path: the continuous paged engine with
   ``prefix_cache=True`` serves a 256-token system prompt (warmed by one
   request), eight requests of it plus a private suffix of 32-144
   tokens, then the first of them again (a snapshot hit) and once more
   with a budget its warmup tokens cover (a replay), once with
   ``relay_decode=False`` and once with ``True``: the plan kinds, exactly
   32 launches of each prefill kernel per suffix prefill and of
   ``relay_prefix_decode`` per relay step, identical memberships, the
   warm, snapshot and replay requests' tokens identical and the others'
   held on margins, empty pools after a clear, and the relay kernel held
   against its plain version on the layer-0 inputs of the first relay
   step;
9. the GQA path: chai-llama-7b's weights freed, full-width
   nemotron-4-15b (bf16, random weights from a seed; 8 KV groups of 6
   heads, r_max = 5 reps per group) through the default continuous
   ``ServingEngine`` with phase 6's traffic, on the paged layout and
   then the dense one: launches of the own fused kernel only, each with
   ``reps_per_group = r_max``, identical greedy tokens on both layouts,
   the KV bytes unchanged at every CLUSTER transition (GQA keeps its
   dense pages until retirement), empty pools, and both fused kernels
   held against their plain versions on the layer-0 GQA tensors of the
   first all-STEADY step; then nemotron's MHA baseline as in phase 6, and
   phase 8's prefix traffic with relay off then on (every request a
   ``"prefix"`` hit: a GQA model takes no CHAI snapshot; relay launches,
   relay tokens held against plain ones on margins, no page left after a
   clear);
10. the fused-vs-pipeline lane (the reference's
   ``benchmarks/bench_latency.py`` lane): the three-kernel pipeline
   (``kernels.ops.chai_three_kernel_decode`` /
   ``paged_chai_three_kernel_decode``) and the fused kernel on the same
   inputs, the counts set to 0 just before each call and read just
   after: exactly 3 launches against 1, the outputs equal at 1e-4, on
   the reference lane's shape (b=4, h=8, r=5, s=256, hd=32, ts=64; also
   with int8 K through ``chai_qk_i8``, the fused side then its plain
   version) and on the layer-0 inputs of the first STEADY step of phases
   5, 6 and 9; each kernel's device time, back-to-back and single-call
   times, and ``decode_hbm_bytes_estimate`` of both; then the six
   pipeline kernels against their plain versions at the main path's and
   nemotron's shapes;
11. a ``kernels`` JSON line (thirteen kernels), the card's name and power
   limit, and, last, ``{"ok": true, "device": {...}}``.

Phase 3 also holds ``flash_decode`` and ``paged_decode`` against their
plain versions on the reference's sweep shapes (MHA, GQA 4:1, MQA, one
tile, a window of 24; fp32 and bf16) and at full width (chai-llama-7b's
32 heads and nemotron's 48 over 8 KV heads, bf16, with SDPA timed
beside), paged == dense bitwise at ts == page on every case, and a null
page (and dense positions past pos) poisoned with 999 changing no output
bit; phase 4 also runs the MHA baseline (paged, dense, cohort) and the
prefix cache + relay engine on reduced nemotron, cuda against cpu. The
CHAI runs of phases 5-9 launch neither flash decode kernel (their
WARMUP keeps the eager attention, which needs the probabilities).

Phase 3 also holds the six pipeline kernels (``chai_qk``, ``chai_qk_i8``,
``paged_chai_qk``, ``row_softmax``, ``chai_av``, ``paged_chai_av``) at
the full-width shapes: fp32 and bf16, MHA and GQA, a window, a row at
pos 2, shuffled pages with the null page 0 past pos, int8 K from the
port's ``quant_rows``, masked scores ``torch.equal`` to -2e38 and a fully
masked row's softmax all zeros; phase 4 also runs reduced nemotron (2 KV
groups of 6 heads, head_dim 8) cuda against cpu.

Phase 3 also holds ``relay_prefix_decode`` on synthetic groups (G = 2,
4 and 3 members of 25 reps, plen 200 and 256, bf16 and fp32) and both
decode kernels' ``emit_state`` mode (against the plain versions; paged
== dense bitwise; emit + merge with the empty state + finalize equal to
the finalized launch bit for bit); phase 4 also runs the reduced engine
with ``prefix_cache=True, relay_decode=True``, cuda against cpu.

The fused decode pair's block body cuts S into whole-tile splits (the
plan of ``kernels.chai_attention.split_plan``) merged in split order
inside the launch, with fixed shared memory. Phase 3 also holds both
kernels at 2e-5 on split cases at full width (bf16, page 16): several
splits with a partial last one, rows whose splits past the first lie
beyond pos (one at pos 0), a WARMUP-like row (every head in rep 0, an
all-null K table), nemotron's GQA shape, and one row of S = 65,536 (MHA
and GQA), above the shared-memory cap the first design had; on each,
paged == dense ``torch.equal`` at page = tile, two launches bitwise
equal, and emit + empty-state merge + finalize bitwise equal to the
finalized launch; and ``relay_prefix_decode`` at Sp = 65,536 (two
groups, plen 65,536 and 50,000; each acc row held over its l at 2e-5,
since the raw sums over that many positions round apart by ~1e-7 of
l). Phase 10 also logs, for each input,
the fused kernel's device time over the pipeline's three-kernel device
time and over its bound. The ``kernels`` rows of ``row_softmax``,
``flash_decode`` and ``flash_prefill`` carry the library call's device
time (``library_device_ms``, every kernel of the call in a
``torch.profiler`` trace) beside its back-to-back ``library_ms``.
"""
from __future__ import annotations

import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.core import cache as chai_cache  # noqa: E402
from repro_torch.core import chai_attention as chai_core  # noqa: E402
from repro_torch.core import clustering  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import chai_attention as ck  # noqa: E402
from repro_torch.kernels import flash_attention as fk  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig, ServingEngine)
from repro_torch.serving.sampling import FINISH_LENGTH  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
TOL = dict(atol=2e-5, rtol=2e-5)
# A finalized bf16 output rounds the fp32 result once, and the kernel and
# the plain version may round a value whose fp32 forms differ in the last
# bits to neighbouring bf16 values: one bf16 step (2^-7 relative).
BF16_OUT_TOL = dict(atol=2e-5, rtol=2 ** -7)
ARCH = "chai-llama-7b"
NEMO = "nemotron-4-15b"        # the GQA model (8 KV groups of 6 heads)
PROMPT_LENS = (200, 320, 450, 500)
MAX_NEW = 32
CONT_PROMPT_LENS = (200, 320, 450, 500, 96, 160, 384, 256)
CONT_MAX_NEW = (32, 48) * 4
MAX_SEQ = 1024
PAGE = 16
SLOTS = 4
CHUNK = 128
# Phase 7 holds a chunked run's greedy token to the monolithic run's where
# the monolithic top-2 logit margin exceeds this. The two prefills round
# bf16 activations at different places (the chunk's two-pass attention
# against the whole-prompt one); logits of this model are ~N(0, 1), and
# their rounding differences are expected around 1e-2.
CHUNK_MARGIN = 0.1
# Phase 8: a 256-token system prompt, warmed by one request, then eight
# requests of the prompt plus a private suffix, then the first of them
# again (a snapshot hit) and once more with a budget its warmup tokens
# cover (a replay).
SYS_LEN = 256
SUFFIX_LENS = (32, 64, 96, 128, 48, 80, 112, 144)
SUFFIX_NEW = (32, 48) * 4
KERNEL_ROWS = {
    "chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:487"),
    "paged_chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:579"),
    "flash_prefill": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_attention.py:273"),
    "paged_prefix_attend": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefix_attend.cu",
        replaces="src/repro/kernels/flash_attention.py:413"),
    "relay_prefix_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/relay_prefix_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:766"),
    "chai_qk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:76"),
    "chai_qk_i8": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:203"),
    "row_softmax": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/row_softmax.cu",
        replaces="src/repro/kernels/chai_attention.py:115"),
    "chai_av": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_av.cu",
        replaces="src/repro/kernels/chai_attention.py:255"),
    "paged_chai_qk": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_qk.cu",
        replaces="src/repro/kernels/chai_attention.py:146"),
    "paged_chai_av": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/chai_av.cu",
        replaces="src/repro/kernels/chai_attention.py:296"),
    "flash_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:74"),
    "paged_decode": dict(
        route="cuda", source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/flash_attention.py:158"),
}
# Calls of the eager decode attention (``models.transformer.
# _decode_attention_batched``, kept for CHAI WARMUP, which needs the
# probabilities); ``count_eager_decode`` installs the counter.
EAGER = {"calls": 0}


def count_eager_decode():
    inner = tfm._decode_attention_batched

    def counted(*args):
        EAGER["calls"] += 1
        return inner(*args)
    tfm._decode_attention_batched = counted


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


# ------------------------------------------------------------ phase 1 ----
def environment():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    release = [ln for ln in nvcc.splitlines() if "release" in ln]
    log(f"nvcc: {(release or nvcc.strip().splitlines())[-1].strip()}")
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line()}")


# ------------------------------------------------------------ phase 2 ----
def build_kernels():
    t0 = time.time()
    outputs = build.build_all(extra_flags=("-Xptxas", "-v"))
    log(f"built {sorted(outputs) or 'nothing (up to date)'} in "
        f"{time.time() - t0:.3f} s")
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name in KERNEL_ROWS:
        build.load(name)


# ------------------------------------------------------------ phase 3 ----
def time_ms(fn, reps=20, warmup=3):
    """Device time of one call: ``reps`` calls back to back between two
    CUDA events, after ``warmup`` calls, over the count. The host
    enqueues ahead of the card, so a wrapper's Python time hides behind
    the kernels unless it is the longer of the two."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel, reps=20, tries=3):
    """Device time per launch of the CUDA kernel named ``kernel`` over
    ``reps`` calls of ``fn``, from a ``torch.profiler`` trace of the card:
    no host time in it, whichever side is the slower. A trace sometimes
    comes back without device times; up to ``tries`` traces are taken.
    None when none holds device time for that kernel."""
    from torch.profiler import ProfilerActivity, profile
    pat = re.compile(rf"\b{kernel}\b")
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if pat.search(e.key)]
        count = sum(e.count for e in hits)
        total_us = sum(e.device_time_total for e in hits)
        if count and total_us:
            return total_us / count / 1e3
    return None


def library_device_ms(fn):
    """Device time of one call of a PyTorch library ``fn``: every CUDA
    kernel it launches, from a ``torch.profiler`` trace (``device_profile``);
    None when no trace holds device time."""
    prof = device_profile(fn)
    return sum(prof.values()) if prof else None


def single_call_ms(fn, reps=20):
    """Median over ``reps`` single calls, each between two CUDA events: the
    method of the earlier runs, whose interval also holds the wrapper's
    host time before the launch (the card idles through it)."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def fused_decode_bound(q, k, v, h2c, pos, rpg, tables=()):
    """Least time for the work these inputs need: K rows of reps that
    have members and every head's V row, positions 0..pos, read once
    (``k``/``v`` give the element size and the V row count: a dense cache
    or a page pool); q, h2c, pos and the block ``tables`` read and the
    (B, H, hd) fp32 output written once; the QK and AV multiply-adds in
    fp32."""
    b, _, hd = q.shape
    h = h2c.shape[1]
    esize = k.element_size()
    n_bytes = (q.numel() + h2c.numel() + pos.numel() + b * h * hd
               + sum(t.numel() for t in tables)) * 4
    flops = 0
    for i in range(b):
        n = int(pos[i]) + 1
        k_rows = len({int(j) // rpg for j in h2c[i].tolist()})
        reps = len(set(h2c[i].tolist()))
        n_bytes += (k_rows + v.shape[1]) * n * hd * esize
        flops += 2 * (reps + h) * n * hd
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_decode_case(q, k, v, h2c, pos, *, rpg, ts):
    """Kernel vs plain on one input; returns (max_abs_err, ms, plain_ms)."""
    out = ck.chai_fused_decode(q, k, v, h2c, pos, reps_per_group=rpg, ts=ts)
    torch.cuda.synchronize()
    want = kref.chai_fused_decode_ref(q, k, v, h2c, pos, reps_per_group=rpg)
    torch.cuda.synchronize()
    if out.shape != want.shape or not torch.isfinite(out).all():
        raise AssertionError(f"kernel output {tuple(out.shape)} not finite "
                             "or of the wrong shape")
    err = float((out - want).abs().max())
    torch.testing.assert_close(out, want, **TOL)
    ms = time_ms(lambda: ck.chai_fused_decode(q, k, v, h2c, pos,
                                              reps_per_group=rpg, ts=ts))
    plain_ms = time_ms(lambda: kref.chai_fused_decode_ref(
        q, k, v, h2c, pos, reps_per_group=rpg))
    return err, ms, plain_ms


def synthetic_case(gen, *, b, h, kv, rpg, s, hd, dtype, empty_rep):
    dev = "cuda"
    r = kv * rpg
    q = torch.randn(b, r, hd, generator=gen, device=dev)
    k = torch.randn(b, kv, s, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, kv if rpg > 1 else h, s, hd, generator=gen,
                    device=dev).to(dtype)
    pos = torch.randint(300, 1001, (b,), generator=gen, device=dev,
                        dtype=torch.int32)
    if rpg == 1:
        choices = torch.tensor([j for j in range(r) if j != empty_rep],
                               device=dev, dtype=torch.int32)
        h2c = choices[torch.randint(0, len(choices), (b, h), generator=gen,
                                    device=dev)]
    else:
        group = torch.arange(h, device=dev) // (h // kv)
        h2c = (group[None] * rpg + torch.randint(
            0, rpg, (b, h), generator=gen, device=dev)).to(torch.int32)
    return q, k, v, h2c, pos


def kernel_checks():
    gen = torch.Generator("cuda").manual_seed(1)
    full = get_config(ARCH)
    cases = []
    for name, kw in (
            ("mha_fp32", dict(b=4, h=32, kv=full.k_max, rpg=1,
                              dtype=torch.float32, empty_rep=7)),
            ("mha_bf16", dict(b=4, h=32, kv=full.k_max, rpg=1,
                              dtype=torch.bfloat16, empty_rep=7)),
            ("gqa_bf16", dict(b=4, h=48, kv=8, rpg=2,
                              dtype=torch.bfloat16, empty_rep=None))):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        err, ms, plain_ms = fused_decode_case(q, k, v, h2c, pos,
                                              rpg=kw["rpg"], ts=PAGE)
        bound, by = fused_decode_bound(q, k, v, h2c, pos, kw["rpg"])
        cases.append(dict(case=name, q=list(q.shape), k=list(k.shape),
                          v=list(v.shape), dtype=str(k.dtype), ts=PAGE,
                          pos=pos.tolist(), max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=bound, bound_by=by))
        log(f"chai_fused_decode {name}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} v {tuple(v.shape)} max_abs_err {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound:.4f} "
            f"ms ({by})")
    return cases


def to_pages(gen, x, n_extra=7):
    """Dense (B, rows, S, hd) -> (pool, block table): every row's pages
    at shuffled ids of a pool whose other pages hold random values."""
    b, rows, s, hd = x.shape
    n = s // PAGE
    n_pool = b * n + n_extra
    pool = torch.randn((n_pool, rows, PAGE, hd), generator=gen,
                       device="cuda").to(x.dtype)
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:b * n]
    bt = (ids + 1).reshape(b, n).to(torch.int32)
    pool[bt.long()] = x.reshape(b, rows, n, PAGE, hd).movedim(2, 1)
    return pool, bt


def paged_decode_case(q, k_pool, bt_k, v_pool, bt_v, h2c, pos, *, rpg):
    """Paged kernel vs its plain version and, bitwise, vs the dense
    kernel on the densified pools at tile = page; returns
    (max_abs_err, ms, plain_ms)."""
    args = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
    out = ck.paged_chai_fused_decode(*args, reps_per_group=rpg)
    torch.cuda.synchronize()
    want = kref.paged_chai_fused_decode_ref(*args, reps_per_group=rpg)
    if out.shape != want.shape or not torch.isfinite(out).all():
        raise AssertionError(f"paged kernel output {tuple(out.shape)} not "
                             "finite or of the wrong shape")
    err = float((out - want).abs().max())
    torch.testing.assert_close(out, want, **TOL)
    dense = ck.chai_fused_decode(
        q, kref.gather_pages_ref(k_pool, bt_k),
        kref.gather_pages_ref(v_pool, bt_v), h2c, pos, reps_per_group=rpg,
        ts=k_pool.shape[2])
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        raise AssertionError("paged kernel differs from the dense kernel "
                             "at page = tile: max abs diff "
                             f"{float((out - dense).abs().max()):.3e}")
    ms = time_ms(lambda: ck.paged_chai_fused_decode(*args,
                                                    reps_per_group=rpg))
    plain_ms = time_ms(lambda: kref.paged_chai_fused_decode_ref(
        *args, reps_per_group=rpg))
    return err, ms, plain_ms


def paged_kernel_checks():
    gen = torch.Generator("cuda").manual_seed(2)
    full = get_config(ARCH)
    cases = []
    for name, kw, warmup_row in (
            ("paged_mha_fp32", dict(b=4, h=32, kv=full.k_max, rpg=1,
                                    dtype=torch.float32, empty_rep=7), None),
            ("paged_mha_bf16", dict(b=4, h=32, kv=full.k_max, rpg=1,
                                    dtype=torch.bfloat16, empty_rep=7),
             None),
            ("paged_mha_bf16_warmup_row", dict(
                b=4, h=32, kv=full.k_max, rpg=1, dtype=torch.bfloat16,
                empty_rep=7), 1),
            ("paged_gqa_bf16", dict(b=4, h=48, kv=8, rpg=2,
                                    dtype=torch.bfloat16, empty_rep=None),
             None)):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        if warmup_row is not None:
            # a WARMUP slot in a mixed step: all-null K table, every head
            # in cluster 0
            bt_k[warmup_row] = 0
            h2c[warmup_row] = 0
        err, ms, plain_ms = paged_decode_case(
            q, k_pool, bt_k, v_pool, bt_v, h2c, pos, rpg=kw["rpg"])
        bound, by = fused_decode_bound(q, k_pool, v_pool, h2c, pos,
                                       kw["rpg"], tables=(bt_k, bt_v))
        cases.append(dict(case=name, q=list(q.shape),
                          k_pool=list(k_pool.shape),
                          v_pool=list(v_pool.shape), dtype=str(k.dtype),
                          page=PAGE, pos=pos.tolist(), max_abs_err=err,
                          ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, bitwise_equal_dense=True))
        log(f"paged_chai_fused_decode {name}: q {tuple(q.shape)} k_pool "
            f"{tuple(k_pool.shape)} v_pool {tuple(v_pool.shape)} "
            f"max_abs_err {err:.3e} (bitwise = dense kernel) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound:.4f} ms "
            f"({by})")
    return cases


def _max_err(got, want):
    """Largest |got - want| over a tensor or a state triple."""
    if isinstance(got, tuple):
        return max(_max_err(g, w) for g, w in zip(got, want))
    return float((got.float() - want.float()).abs().max())


def _hold(got, want, tol=TOL):
    """Shapes, finiteness (a state's m may hold the identity's -2e38,
    which is finite) and ``tol``; returns the max abs error."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"kernel output {tuple(g.shape)} not "
                                 f"finite or not of the plain version's "
                                 f"shape {tuple(w.shape)}")
        torch.testing.assert_close(g.float(), w.float(), **tol)
    return _max_err(got, want)


def flash_prefill_bound(q, k, offset, emit_state):
    """Least time for ``flash_prefill``'s work: q, k and v read once, the
    output (q's dtype) or the fp32 state written once; the QK and PV
    multiply-adds of the causal pairs (query offset + t sees keys
    0..offset + t) at the inputs' peak rate (bf16 tensor cores, or fp32)."""
    b, t, h, hd = q.shape
    s = k.shape[1]
    es = q.element_size()
    n_bytes = (q.numel() + 2 * k.numel()) * es + 4
    n_bytes += (2 * b * h * t + b * h * t * hd) * 4 if emit_state else (
        q.numel() * es)
    pairs = sum(min(s, offset + i + 1) for i in range(t))
    flops = 4 * b * h * hd * pairs
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def prefix_bound(q, pool, bt_k, plen):
    """Least time for ``paged_prefix_attend``'s work: q, the K and V rows
    of the positions < plen and the table entries of their pages read
    once, the fp32 state written once; 4 * hd flops per (query, head,
    position) at the inputs' peak rate."""
    b, t, h, hd = q.shape
    kv, page = pool.shape[1], pool.shape[2]
    es = q.element_size()
    lens = [min(int(n), bt_k.shape[1] * page) for n in plen.tolist()]
    n_bytes = (q.numel() * es + sum(2 * n * kv * hd * es for n in lens)
               + sum(2 * 4 * -(-n // page) for n in lens) + 4 * b
               + (2 * b * h * t + b * h * t * hd) * 4)
    flops = sum(4 * h * hd * t * n for n in lens)
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_case(q, k, v, *, offset=0, emit_state=True, library=False):
    """``flash_prefill`` against its plain version on one input (2e-5,
    or one bf16 step for a finalized bf16 output); returns the case's
    record with its times and bound. ``library``: also time PyTorch's
    ``scaled_dot_product_attention(is_causal=True)`` beside the finalized
    mode on the same (MHA, offset 0, T == S) inputs."""
    got = fk.flash_prefill(q, k, v, offset=offset, emit_state=emit_state)
    torch.cuda.synchronize()
    if emit_state:
        want, tol = kref.flash_prefill_state_ref(q, k, v, offset=offset), TOL
    else:
        if got.dtype != q.dtype:
            raise AssertionError(f"finalized output in {got.dtype}")
        want = kref.flash_prefill_ref(q, k, v, offset=offset)
        tol = TOL if q.dtype == torch.float32 else BF16_OUT_TOL
    err = _hold(got, want, tol)
    ms = time_ms(lambda: fk.flash_prefill(q, k, v, offset=offset,
                                          emit_state=emit_state))
    plain = (kref.flash_prefill_state_ref if emit_state
             else kref.flash_prefill_ref)
    plain_ms = time_ms(lambda: plain(q, k, v, offset=offset))
    bound, by = flash_prefill_bound(q, k, offset, emit_state)
    rec = dict(q=list(q.shape), k=list(k.shape), dtype=str(q.dtype),
               offset=offset, emit_state=emit_state, max_abs_err=err,
               tolerance="2e-5" if tol is TOL else "one bf16 step",
               ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    if library:
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = sdpa(qh, kh, vh, is_causal=True).transpose(1, 2)
        fin = fk.flash_prefill(q, k, v)
        rec["library_ms"] = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True))
        rec["library_device_ms"] = library_device_ms(
            lambda: sdpa(qh, kh, vh, is_causal=True))
        rec["finalized_ms"] = time_ms(lambda: fk.flash_prefill(q, k, v))
        rec["library_vs_kernel_max_abs_diff"] = _max_err(lib, fin)
    return rec


def prefix_case(q, pool, bt_k, bt_v, plen):
    """``paged_prefix_attend`` against its plain version (2e-5); rows with
    plen == 0 must hold the merge identity exactly. Returns the record."""
    got = fk.paged_prefix_attend(q, pool, bt_k, bt_v, plen)
    torch.cuda.synchronize()
    want = kref.paged_prefix_attend_ref(q, pool, bt_k, bt_v, plen)
    err = _hold(got, want)
    empty = plen == 0
    if empty.any():
        m, l, acc = (x[empty] for x in got)
        if not ((m == kref.NEG_INF).all() and (l == 0).all()
                and (acc == 0).all()):
            raise AssertionError("paged_prefix_attend: a plen == 0 row is "
                                 "not the merge identity")
    ms = time_ms(lambda: fk.paged_prefix_attend(q, pool, bt_k, bt_v, plen))
    plain_ms = time_ms(lambda: kref.paged_prefix_attend_ref(
        q, pool, bt_k, bt_v, plen))
    bound, by = prefix_bound(q, pool, bt_k, plen)
    return dict(q=list(q.shape), pool=list(pool.shape), dtype=str(q.dtype),
                plen=plen.tolist(), identity_rows=int(empty.sum()),
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by)


def _log_case(name, case):
    log(f"{name} {case['case']}: q {tuple(case['q'])} {case['dtype']} "
        + (f"plen {case['plen']} " if "plen" in case else
           f"offset {case['offset']} emit_state {case['emit_state']} ")
        + f"max_abs_err {case['max_abs_err']:.3e} kernel {case['ms']:.4f} "
        f"ms plain {case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms"
        f" ({case['bound_by']})"
        + (f" library {case['library_ms']:.4f} ms (kernel finalized "
           f"{case['finalized_ms']:.4f} ms)" if "library_ms" in case else ""))


def prefill_kernel_checks():
    """Both prefill kernels at a full chunk's shapes (T = 128 queries of 32
    heads of 128, a pool of 513 pages of 16) and at the edges."""
    gen = torch.Generator("cuda").manual_seed(3)
    dev = "cuda"

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    flash = []
    for name, (t, s, h, kv, dtype, offset, emit, lib) in {
            "chunk_bf16_state": (128, 128, 32, 32, torch.bfloat16, 0, True,
                                 False),
            "chunk_bf16_finalized": (128, 128, 32, 32, torch.bfloat16, 0,
                                     False, True),
            "chunk_fp32_state": (128, 128, 32, 32, torch.float32, 0, True,
                                 False),
            "chunk_fp32_finalized": (128, 128, 32, 32, torch.float32, 0,
                                     False, False),
            "offset384_bf16_state": (128, 512, 32, 32, torch.bfloat16, 384,
                                     True, False),
            "ragged_t40_offset60_fp32": (40, 100, 32, 32, torch.float32, 60,
                                         True, False),
            "gqa_h48_kv8_bf16_state": (128, 128, 48, 8, torch.bfloat16, 0,
                                       True, False)}.items():
        q = rand(1, t, h, 128, dtype=dtype)
        k, v = rand(1, s, kv, 128, dtype=dtype), rand(1, s, kv, 128,
                                                      dtype=dtype)
        case = dict(case=name, **flash_case(q, k, v, offset=offset,
                                            emit_state=emit, library=lib))
        flash.append(case)
        _log_case("flash_prefill", case)
    # a device tensor offset gives the int offset's bits
    q, k, v = rand(1, 128, 32, 128), rand(1, 512, 32, 128), rand(1, 512, 32,
                                                                  128)
    a = fk.flash_prefill(q, k, v, offset=384, emit_state=True)
    b = fk.flash_prefill(q, k, v, offset=torch.tensor([384], device=dev),
                         emit_state=True)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("flash_prefill: tensor offset differs from int")

    prefix = []
    n_pool, p_slot = 2 * SLOTS * MAX_SEQ // PAGE + 1, MAX_SEQ // PAGE
    for name, (b, h, kv, dtype, plens) in {
            "plen128_bf16": (1, 32, 32, torch.bfloat16, (128,)),
            "plen256_bf16": (1, 32, 32, torch.bfloat16, (256,)),
            "plen384_bf16": (1, 32, 32, torch.bfloat16, (384,)),
            "plen0_bf16": (1, 32, 32, torch.bfloat16, (0,)),
            "rows_0_200_384_bf16": (3, 32, 32, torch.bfloat16, (0, 200, 384)),
            "plen384_fp32": (1, 32, 32, torch.float32, (384,)),
            "gqa_h48_kv8_plen384_bf16": (1, 48, 8, torch.bfloat16,
                                         (384,))}.items():
        pool = rand(n_pool, kv, PAGE, 128, dtype=dtype)
        ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
               + 1).to(torch.int32)
        bt_k = ids[:b * p_slot].reshape(b, p_slot)
        bt_v = ids[b * p_slot:2 * b * p_slot].reshape(b, p_slot)
        plen = torch.tensor(plens, dtype=torch.int32, device=dev)
        q = rand(b, 128, h, 128, dtype=dtype)
        case = dict(case=name, **prefix_case(q, pool, bt_k, bt_v, plen))
        prefix.append(case)
        _log_case("paged_prefix_attend", case)
        del pool
    return flash, prefix


def _identity_state(b, r, h, hd):
    """The empty decode state: the exact merge identity."""
    return (torch.full((b, r), kref.NEG_INF, device="cuda"),
            torch.zeros((b, r), device="cuda"),
            torch.zeros((b, h, hd), device="cuda"))


def emit_state_checks():
    """Both decode kernels' ``emit_state`` mode at the continuous path's
    shapes (B = 4, R = k_max = 25, H = 32, S = 1024, page 16, a rep with
    no member head): each against its plain version at 2e-5; paged ==
    dense bitwise; and emit + merge with the identity + finalize equal
    to the finalized launch bit for bit."""
    gen = torch.Generator("cuda").manual_seed(4)
    full = get_config(ARCH)
    cases = {"chai_fused_decode": [], "paged_chai_fused_decode": []}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, h2c, pos = synthetic_case(
            gen, b=4, h=32, kv=full.k_max, rpg=1, s=MAX_SEQ, hd=128,
            dtype=dtype, empty_rep=7)
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        pa = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
        dense = ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE,
                                     emit_state=True)
        paged = ck.paged_chai_fused_decode(*pa, emit_state=True)
        fin_dense = ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE)
        fin_paged = ck.paged_chai_fused_decode(*pa)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(paged, dense)):
            raise AssertionError("emit_state: paged kernel differs from the "
                                 "dense kernel at page = tile")
        ident = _identity_state(4, full.k_max, 32, 128)
        for st, fin, label in ((dense, fin_dense, "dense"),
                               (paged, fin_paged, "paged")):
            merged = kops.finalize_decode_state(
                kops.merge_decode_states(st, ident, h2c), h2c)
            if not torch.equal(merged, fin):
                raise AssertionError(
                    f"emit_state {label}: emit + identity merge + finalize "
                    "differs from the finalized launch: max abs diff "
                    f"{float((merged - fin).abs().max()):.3e}")
        for name, got, want, call, plain in (
                ("chai_fused_decode", dense,
                 kref.chai_fused_decode_ref(q, k, v, h2c, pos,
                                            emit_state=True),
                 lambda: ck.chai_fused_decode(q, k, v, h2c, pos, ts=PAGE,
                                              emit_state=True),
                 lambda: kref.chai_fused_decode_ref(q, k, v, h2c, pos,
                                                    emit_state=True)),
                ("paged_chai_fused_decode", paged,
                 kref.paged_chai_fused_decode_ref(*pa, emit_state=True),
                 lambda: ck.paged_chai_fused_decode(*pa, emit_state=True),
                 lambda: kref.paged_chai_fused_decode_ref(
                     *pa, emit_state=True))):
            err = _hold(got, want)
            kk, vv = (k, v) if name == "chai_fused_decode" else (k_pool,
                                                                 v_pool)
            bound, by = fused_decode_bound(q, kk, vv, h2c, pos, 1)
            if by == "bytes":   # the state mode writes m and l (B, R) too
                bound += 2 * q.numel() // q.shape[2] * 4 / HBM_BYTES_PER_S \
                    * 1e3
            case = dict(case=f"emit_state_{str(dtype)[6:]}", emit_state=True,
                        q=list(q.shape), dtype=str(dtype), pos=pos.tolist(),
                        max_abs_err=err, ms=time_ms(call),
                        plain_ms=time_ms(plain), bound_ms=bound, bound_by=by,
                        bitwise_equal_dense=True,
                        identity_merge_finalize_equal=True)
            cases[name].append(case)
            log(f"{name} {case['case']}: max_abs_err {err:.3e}, kernel "
                f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                f"bound {bound:.4f} ms; paged == dense bitwise, emit + "
                "identity merge + finalize == finalized launch bitwise")
    return cases


def relay_bound(q, k, k_row, a_row, v_row, plen):
    """Least time for ``relay_prefix_decode``'s work: per group the K rows
    its query rows name and the V rows its acc rows name, positions <
    plen, read once; q, the maps and plen read and the fp32 state (m, l
    and acc) written once; the QK and AV multiply-adds in fp32."""
    g, nr, hd = q.shape
    a = a_row.shape[1]
    es = k.element_size()
    n_bytes = (q.numel() + k_row.numel() + a_row.numel() + v_row.numel()
               + plen.numel() + 2 * g * nr + g * a * hd) * 4
    flops = 0
    for i in range(g):
        n = int(plen[i])
        rows = len(set(k_row[i].tolist())) + len(set(v_row[i].tolist()))
        n_bytes += rows * n * hd * es
        flops += 2 * (nr + a) * n * hd
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _per_l(state, a_row):
    """A relay state with each acc row over its query row's l: the
    quantity the merge and the finalize carry on, at the scale of one
    attention output."""
    m, l, acc = state
    return m, l, acc / torch.gather(l, 1, a_row.long())[..., None]


def relay_case(q, k, v, k_row, a_row, v_row, plen, ts, *, per_l=False):
    """``relay_prefix_decode`` against its plain version (2e-5); returns
    the case's record with its times and bound. ``per_l``: hold each acc
    row over its l (and record the raw acc's error): over tens of
    thousands of positions the raw acc and l are sums of that many terms
    of up to 1, which two summation orders round apart by ~1e-7 of l."""
    args = (q, k, v, k_row, a_row, v_row, plen)
    got = ck.relay_prefix_decode(*args, ts=ts)
    torch.cuda.synchronize()
    want = kref.relay_prefix_decode_ref(*args)
    if per_l:
        raw_err = _max_err(got, want)
        got, want = _per_l(got, a_row), _per_l(want, a_row)
    err = _hold(got, want)
    bound, by = relay_bound(q, k, k_row, a_row, v_row, plen)
    extra = dict(held="acc / l", raw_max_abs_err=raw_err) if per_l else {}
    return dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                a=a_row.shape[1], dtype=str(k.dtype), ts=ts,
                plen=plen.tolist(), max_abs_err=err, **extra,
                ms=time_ms(lambda: ck.relay_prefix_decode(*args, ts=ts)),
                plain_ms=time_ms(lambda: kref.relay_prefix_decode_ref(*args)),
                bound_ms=bound, bound_by=by)


def relay_kernel_checks():
    """``relay_prefix_decode`` on synthetic groups at the full-width
    shapes: G = 2 groups of 4 and 3 members (the fourth slot of group 1
    is a padded member, index 0 in every map), R = 25 reps of H = 32
    heads (one rep of each member without a head), hd 128, plen 200 and
    256 in a view of Sp = 256 whose tail past plen is zero, bf16 and
    fp32."""
    gen = torch.Generator("cuda").manual_seed(5)
    dev = "cuda"
    r, h, hd, sp, nmax = get_config(ARCH).k_max, 32, 128, 256, 4
    plen = torch.tensor([200, 256], dtype=torch.int32, device=dev)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        g = len(plen)
        q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
        k = torch.randn(g, h, sp, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(g, h, sp, hd, generator=gen, device=dev).to(dtype)
        for i, n in enumerate(plen.tolist()):
            k[i, :, n:] = 0
            v[i, :, n:] = 0
        k_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
        a_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
        v_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
        for i, n_mem in enumerate((4, 3)):
            for j in range(n_mem):
                reps = torch.randperm(h, generator=gen, device=dev)[:r]
                h2c = torch.randint(0, r - 1, (h,), generator=gen,
                                    device=dev)
                k_row[i, j * r:(j + 1) * r] = reps
                a_row[i, j * h:(j + 1) * h] = j * r + h2c
                v_row[i, j * h:(j + 1) * h] = torch.arange(h, device=dev)
        case = dict(case=f"synthetic_g2_{str(dtype)[6:]}",
                    **relay_case(q, k, v, k_row, a_row, v_row, plen, PAGE))
        cases.append(case)
        log(f"relay_prefix_decode {case['case']}: q {tuple(q.shape)} k "
            f"{tuple(k.shape)} plen {case['plen']} max_abs_err "
            f"{case['max_abs_err']:.3e} kernel {case['ms']:.4f} ms plain "
            f"{case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']})")
    return cases


# ------------------------------------------ phase 3: split-S decode ----
def _bitwise(name, got, want):
    """``torch.equal`` of two outputs or two state triples, or raise."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{name}: max abs diff "
                             f"{_max_err(got, want):.3e}")


def fused_pair_case(tag, q, k, v, h2c, pos, *, rpg, gen, null_k_rows=()):
    """Both fused kernels on one input, the same K/V also on shuffled
    pool pages (rows ``null_k_rows`` with an all-null K table, as a
    WARMUP row of a mixed step): each against the plain version (2e-5),
    paged ``torch.equal`` to dense at page = tile (dense reads the
    densified pools), each launched twice with equal bits, and emit +
    merge with the empty state + finalize equal to the finalized launch
    bit for bit. Returns {kernel: record}."""
    k_pool, bt_k = to_pages(gen, k)
    v_pool, bt_v = to_pages(gen, v)
    for row in null_k_rows:
        bt_k[row] = 0
    kd = kref.gather_pages_ref(k_pool, bt_k)
    vd = kref.gather_pages_ref(v_pool, bt_v)
    pa = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
    calls = {
        "chai_fused_decode": lambda emit=False: ck.chai_fused_decode(
            q, kd, vd, h2c, pos, reps_per_group=rpg, ts=PAGE,
            emit_state=emit),
        "paged_chai_fused_decode": lambda emit=False: (
            ck.paged_chai_fused_decode(*pa, reps_per_group=rpg,
                                       emit_state=emit))}
    want = kref.paged_chai_fused_decode_ref(*pa, reps_per_group=rpg)
    plain = lambda: kref.chai_fused_decode_ref(  # noqa: E731
        q, kd, vd, h2c, pos, reps_per_group=rpg)
    outs, states = {}, {}
    for name, call in calls.items():
        outs[name] = call()
        again = call()
        states[name] = call(True)
        torch.cuda.synchronize()
        _bitwise(f"{tag} {name}: two launches", again, outs[name])
        merged = kops.finalize_decode_state(kops.merge_decode_states(
            states[name], _identity_state(*q.shape[:2], h2c.shape[1],
                                          q.shape[2]), h2c), h2c)
        _bitwise(f"{tag} {name}: emit + identity merge + finalize vs the "
                 "finalized launch", merged, outs[name])
    _bitwise(f"{tag}: paged vs dense at page = tile",
             outs["paged_chai_fused_decode"], outs["chai_fused_decode"])
    _bitwise(f"{tag}: paged vs dense state",
             states["paged_chai_fused_decode"], states["chai_fused_decode"])
    cfg, _ = ck.dense_launch_config(q, kd, h2c, reps_per_group=rpg, ts=PAGE)
    lib_smem = build.load("chai_fused_decode").chai_decode_smem_bytes(
        rpg, q.shape[2], h2c.shape[1], cfg.n_cap)
    if lib_smem != cfg.smem_bytes:
        raise AssertionError(f"{tag}: the kernel's block takes {lib_smem} B "
                             "of shared memory, the host's mirror says "
                             f"{cfg.smem_bytes}")
    plain_ms = time_ms(plain, reps=5, warmup=1)
    recs = {}
    for name, call in calls.items():
        kk, vv, tables = ((kd, vd, ()) if name == "chai_fused_decode"
                          else (k_pool, v_pool, (bt_k, bt_v)))
        bound, by = fused_decode_bound(q, kk, vv, h2c, pos, rpg,
                                       tables=tables)
        recs[name] = dict(
            case=tag, q=list(q.shape), k=list(k.shape), v=list(v.shape),
            dtype=str(k.dtype), page=PAGE, rpg=rpg, pos=pos.tolist(),
            n_split=cfg.n_split, tiles_per_split=cfg.tiles_per_split,
            smem_bytes=cfg.smem_bytes,
            max_abs_err=_hold(outs[name], want), ms=time_ms(call),
            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            bitwise_equal_dense=True, repeat_bitwise=True,
            identity_merge_finalize_equal=True)
        r = recs[name]
        log(f"{name} {tag}: q {tuple(q.shape)} k {tuple(k.shape)} rpg "
            f"{rpg} pos {r['pos']} splits {cfg.n_split} x "
            f"{cfg.tiles_per_split} tiles; max_abs_err "
            f"{r['max_abs_err']:.3e}; paged == dense, repeat == repeat, "
            f"emit identity: bitwise; kernel {r['ms']:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {bound:.4f} ms ({by})")
    return recs


def split_decode_checks():
    """The fused decode pair's split-S cases at full width (hd 128, bf16,
    page 16): several splits with a partial last one, all live; rows whose
    splits past the first lie beyond pos (one at pos 0); a WARMUP-like
    row (every head in rep 0, an all-null K table); nemotron's GQA shape
    (48 heads over 8 KV groups, 5 reps each); and one row of S = 65,536,
    above the old shared-memory cap (about 48,800 positions dense), MHA
    and GQA. Then ``relay_prefix_decode`` at Sp = 65,536 against its
    plain version. Returns ({kernel: [records]}, [relay records])."""
    gen = torch.Generator("cuda").manual_seed(6)
    k_max = get_config(ARCH).k_max
    mha = dict(h=32, kv=k_max, rpg=1, hd=128, dtype=torch.bfloat16,
               empty_rep=7)
    gqa = dict(h=48, kv=8, rpg=5, hd=128, dtype=torch.bfloat16,
               empty_rep=None)
    cases = {"chai_fused_decode": [], "paged_chai_fused_decode": []}
    for tag, kw, b, s, pos, warm in (
            ("splits_partial_last", mha, 4, MAX_SEQ, (1023, 1000, 900, 885),
             False),
            ("first_split_only_rows", mha, 4, MAX_SEQ, (10, 0, 150, 700),
             False),
            ("warmup_row", mha, 4, MAX_SEQ, None, True),
            ("nemotron_gqa", gqa, 4, MAX_SEQ, None, False),
            ("long_65536_mha", mha, 1, 65536, (65535,), False),
            ("long_65536_gqa", gqa, 1, 65536, (65535,), False)):
        q, k, v, h2c, p = synthetic_case(gen, b=b, s=s, **kw)
        if pos is not None:
            p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        if warm:
            h2c[1] = 0
        recs = fused_pair_case(tag, q, k, v, h2c, p, rpg=kw["rpg"], gen=gen,
                               null_k_rows=(1,) if warm else ())
        for name, rec in recs.items():
            cases[name].append(rec)
        del q, k, v
        torch.cuda.empty_cache()
    relay = []
    dev = "cuda"
    r, h, hd, sp, nmax = k_max, 32, 128, 65536, 4
    plen = torch.tensor([sp, 50000], dtype=torch.int32, device=dev)
    g = len(plen)
    q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
    k = torch.randn(g, h, sp, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    v = torch.randn(g, h, sp, hd, generator=gen,
                    device=dev).to(torch.bfloat16)
    k_row = torch.stack([torch.cat([torch.randperm(
        h, generator=gen, device=dev)[:r] for _ in range(nmax)])
        for _ in range(g)]).int()
    a_row = torch.stack([torch.cat([j * r + torch.randint(
        0, r, (h,), generator=gen, device=dev) for j in range(nmax)])
        for _ in range(g)]).int()
    v_row = torch.arange(h, device=dev).repeat(g, nmax).int()
    case = dict(case="long_65536_g2_bfloat16",
                **relay_case(q, k, v, k_row, a_row, v_row, plen, PAGE,
                             per_l=True))
    relay.append(case)
    log(f"relay_prefix_decode {case['case']}: q {tuple(q.shape)} k "
        f"{tuple(k.shape)} plen {case['plen']} max_abs_err (acc / l) "
        f"{case['max_abs_err']:.3e} (raw state "
        f"{case['raw_max_abs_err']:.3e}) kernel {case['ms']:.4f} ms plain "
        f"{case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})")
    del q, k, v
    torch.cuda.empty_cache()
    return cases, relay


# ------------------------------------------- phase 3: the pipeline ----
PIPE_KERNELS = ("chai_qk", "chai_qk_i8", "paged_chai_qk", "row_softmax",
                "chai_av", "paged_chai_av")
# each pipeline kernel's CUDA function, as a torch.profiler trace names it
PIPE_FUNCS = {"chai_qk": "qk_kernel", "chai_qk_i8": "qk_kernel",
              "paged_chai_qk": "qk_kernel",
              "row_softmax": "row_softmax_kernel", "chai_av": "av_kernel",
              "paged_chai_av": "av_kernel"}


def _bound(n_bytes, flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _valid_positions(p, s, window):
    """Positions a QK row at ``pos`` = p scores (idx <= p, and p - idx <
    window when window > 0), within 0..s-1."""
    lo = max(0, p - window + 1) if window else 0
    return max(0, min(p, s - 1) - lo + 1)


def qk_bound(q, k, pos, s, *, window=0, k_scale=None, tables=()):
    """Least time for a QK kernel's work: every KV row's K elements (and
    int8 scales) at the valid positions read once, whatever reps share
    the row; q, pos and the block ``tables`` read and the (B, R, S) fp32
    scores written once; 2 * hd fp32 flops per (rep, valid position)."""
    b, r, hd = q.shape
    kv = k.shape[1]
    n_bytes = (q.numel() + pos.numel() + b * r * s
               + sum(t.numel() for t in tables)) * 4
    flops = 0
    for p in pos.tolist():
        n = _valid_positions(int(p), s, window)
        n_bytes += kv * n * (hd * k.element_size()
                             + (4 if k_scale is not None else 0))
        flops += 2 * r * n * hd
    return _bound(n_bytes, flops)


def softmax_bound(scores):
    """One read and one write of the (B, R, S) fp32 rows."""
    return _bound(2 * scores.numel() * 4, 3 * scores.numel())


def av_bound(a, v, h2c, *, tables=()):
    """Least time for an AV kernel's work: the A rows the heads name and
    every head's V row over all S read once (``v`` gives the element
    size), h2c and ``tables`` read and the (B, H, hd) fp32 output written
    once; 2 * hd fp32 flops per (head, position)."""
    b, _, s = a.shape
    h, hd = h2c.shape[-1], v.shape[-1]
    h2c = h2c.expand(b, h) if h2c.ndim == 1 else h2c
    rows = sum(len(set(r.tolist())) for r in h2c)
    n_bytes = ((rows * s + b * h * hd + h2c.numel()
                + sum(t.numel() for t in tables)) * 4
               + b * h * s * hd * v.element_size())
    return _bound(n_bytes, 2 * b * h * s * hd)


def pipe_case(name, call, plain, bound, *, library=None, profile=False):
    """One pipeline kernel against its plain version (2e-5; a QK kernel's
    masked entries ``torch.equal`` to -2e38 where the plain version has
    them, and nowhere else); returns (its record, the kernel's output).
    ``profile``: also its single-call and profiled device times."""
    got = call()
    torch.cuda.synchronize()
    want = plain()
    err = _hold(got, want)
    if name in ("chai_qk", "chai_qk_i8", "paged_chai_qk"):
        masked = want == kref.NEG_INF
        if not torch.equal(got == kref.NEG_INF, masked):
            raise AssertionError(f"{name}: masked entries differ from the "
                                 "plain version's")
        n_masked = int(masked.sum())
    rec = dict(max_abs_err=err, ms=time_ms(call), plain_ms=time_ms(plain),
               bound_ms=bound[0], bound_by=bound[1],
               library_ms=time_ms(library) if library else None)
    if library and profile:
        rec["library_device_ms"] = library_device_ms(library)
    if name in ("chai_qk", "chai_qk_i8", "paged_chai_qk"):
        rec["masked_entries"] = n_masked
    if profile:
        rec["single_call_ms"] = single_call_ms(call)
        rec["device_ms"] = device_ms(call, PIPE_FUNCS[name])
    return rec, got


def null_past_pos(bt, pos):
    """Block tables as the engine holds them: entries past a row's last
    live page name the null page 0."""
    bt = bt.clone()
    for i, p in enumerate(pos.tolist()):
        bt[i, max(int(p), 0) // PAGE + 1:] = 0
    return bt


def pipeline_stage_cases(tag, q, k, v, h2c, pos, *, rpg, window=0,
                         pages=None, h2c_flat=None,
                         mask_row=True, profile=False):
    """The six pipeline kernels on one decode input, each against its
    plain version. ``k``/``v``: dense (B, KV, S, hd) / (B, H, S, hd), and
    with ``pages`` = (k_pool, bt_k, v_pool, bt_v) holding the same logical
    K/V the paged kernels run on the pools too (paged QK bitwise equal to
    dense QK); the int8 QK on K from ``quant_rows``. ``mask_row``: a
    second softmax launch with row 1's scores masked everywhere, which
    must give zeros. ``h2c_flat`` ((H,)): the AV kernels once more with a
    batch-shared h2c. ``profile``: single-call and profiled device times
    too. Returns {kernel: [records]}."""
    out = {n: [] for n in PIPE_KERNELS}
    s = k.shape[2]

    def add(name, rec, **extra):
        rec = dict(case=f"{tag}", q=list(q.shape), k=list(k.shape),
                   dtype=str(k.dtype), pos=pos.tolist(), window=window,
                   **extra, **rec)
        out[name].append(rec)
        log(f"{name} {rec['case']}: max_abs_err {rec['max_abs_err']:.3e} "
            f"kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            + (f" library {rec['library_ms']:.4f} ms"
               if rec["library_ms"] is not None else "")
            + (f" masked {rec['masked_entries']}" if "masked_entries" in rec
               else ""))

    kw = dict(reps_per_group=rpg, window=window)
    rec, sc = pipe_case(
        "chai_qk", lambda: ck.chai_qk(q, k, pos, ts=PAGE, **kw),
        lambda: kref.chai_qk_ref(q, k, pos, **kw),
        qk_bound(q, k, pos, s, window=window), profile=profile)
    add("chai_qk", rec)
    kq, ks = chai_cache.quant_rows(k)
    rec, _ = pipe_case(
        "chai_qk_i8", lambda: ck.chai_qk_i8(q, kq, ks, pos, ts=PAGE, **kw),
        lambda: kref.chai_qk_i8_ref(q, kq, ks, pos, **kw),
        qk_bound(q, kq, pos, s, window=window, k_scale=ks), profile=profile)
    add("chai_qk_i8", rec)
    rec, a = pipe_case(
        "row_softmax", lambda: ck.row_softmax(sc),
        lambda: kref.row_softmax_ref(sc), softmax_bound(sc),
        library=lambda: torch.softmax(sc, -1), profile=profile)
    add("row_softmax", rec)
    if mask_row:
        masked = sc.clone()
        masked[1] = kref.NEG_INF
        rec, am = pipe_case(
            "row_softmax", lambda: ck.row_softmax(masked),
            lambda: kref.row_softmax_ref(masked), softmax_bound(masked),
            library=lambda: torch.softmax(masked, -1))
        if am[1].any():
            raise AssertionError("row_softmax: a fully masked row is not "
                                 "zeros")
        add("row_softmax", rec, masked_row=1)
    for idx, label in ((h2c, "h2c_BH"), (h2c_flat, "h2c_H")):
        if idx is None:
            continue
        rec, _ = pipe_case(
            "chai_av", lambda: ck.chai_av(a, v, idx, ts=PAGE),
            lambda: kref.chai_av_ref(a, v, idx), av_bound(a, v, idx),
            profile=profile and label == "h2c_BH")
        add("chai_av", rec, h2c=label)
    if pages is None:
        return out
    k_pool, bt_k, v_pool, bt_v = pages
    rec, psc = pipe_case(
        "paged_chai_qk",
        lambda: ck.paged_chai_qk(q, k_pool, bt_k, pos, **kw),
        lambda: kref.paged_chai_qk_ref(q, k_pool, bt_k, pos, **kw),
        qk_bound(q, k_pool, pos, s, window=window, tables=(bt_k,)),
        profile=profile)
    if not torch.equal(psc, sc):
        raise AssertionError("paged_chai_qk differs from chai_qk on the "
                             "same logical K")
    add("paged_chai_qk", rec, k_pool=list(k_pool.shape),
        bitwise_equal_dense=True)
    for idx, label in ((h2c, "h2c_BH"), (h2c_flat, "h2c_H")):
        if idx is None:
            continue
        rec, _ = pipe_case(
            "paged_chai_av",
            lambda: ck.paged_chai_av(a, v_pool, bt_v, idx),
            lambda: kref.paged_chai_av_ref(a, v_pool, bt_v, idx),
            av_bound(a, v_pool, idx, tables=(bt_v,)),
            profile=profile and label == "h2c_BH")
        add("paged_chai_av", rec, v_pool=list(v_pool.shape), h2c=label)
    return out


def pipeline_kernel_checks():
    """The six pipeline kernels on synthetic inputs at the full-width
    shapes (B = 4, S = 1024, hd = 128): MHA (R = k_max = 25 reps of 32
    heads, fp32 and bf16, and with a window of 200) and GQA (8 KV groups
    of 5 reps of 6 heads, nemotron-4-15b's r_max, bf16); int8 K from the
    port's ``quant_rows``; row 0 at pos 2; shuffled pages with the null
    page 0 past each row's pos; row 1's scores masked everywhere before
    the softmax; h2c (B, H) and (H,)."""
    gen = torch.Generator("cuda").manual_seed(6)
    k_max = get_config(ARCH).k_max
    cases = {n: [] for n in PIPE_KERNELS}
    for tag, kw, window in (
            ("mha_fp32", dict(b=4, h=32, kv=k_max, rpg=1,
                              dtype=torch.float32, empty_rep=7), 0),
            ("mha_bf16", dict(b=4, h=32, kv=k_max, rpg=1,
                              dtype=torch.bfloat16, empty_rep=7), 0),
            ("mha_bf16_window200", dict(b=4, h=32, kv=k_max, rpg=1,
                                        dtype=torch.bfloat16, empty_rep=7),
             200),
            ("gqa_bf16", dict(b=4, h=48, kv=8, rpg=5, dtype=torch.bfloat16,
                              empty_rep=None), 0)):
        q, k, v, h2c, pos = synthetic_case(gen, s=MAX_SEQ, hd=128, **kw)
        if kw["rpg"] > 1:      # the pipeline's AV takes per-head V rows
            v = v.repeat_interleave(kw["h"] // kw["kv"], dim=1)
        pos[0] = 2
        k_pool, bt_k = to_pages(gen, k)
        v_pool, bt_v = to_pages(gen, v)
        pages = (k_pool, null_past_pos(bt_k, pos), v_pool,
                 null_past_pos(bt_v, pos))
        got = pipeline_stage_cases(tag, q, k, v, h2c, pos, rpg=kw["rpg"],
                                   window=window, pages=pages,
                                   h2c_flat=h2c[2] if tag == "mha_fp32"
                                   else None)
        for name in PIPE_KERNELS:
            cases[name] += got[name]
    return cases


# ------------------------------------- phase 3: the flash decode pair ----
# Each flash decode kernel's CUDA function, as a torch.profiler trace names
# it.
FLASH_FUNCS = {"flash_decode": "flash_decode_kernel",
               "paged_decode": "paged_decode_kernel"}


def flash_decode_bound(q, k, pos, *, window=0, s=None, page=0):
    """Least time for a flash decode's work: q read, the (B, H, hd) fp32
    output written, and per batch row the K and V rows of its KV groups at
    the live positions (idx <= pos, and pos - idx < window) read once,
    with, paged (``page``), the two table entries of each live page; the
    QK and AV multiply-adds in fp32. ``k``: the cache or the pool (element
    size, KV rows); ``s``: the logical length."""
    b, h, hd = q.shape
    kv, es = k.shape[1], k.element_size()
    n_bytes = q.numel() * q.element_size() + b * 4 + b * h * hd * 4
    flops = 0
    for p in pos.tolist():
        hi = min(int(p), s - 1)
        lo = max(0, int(p) - window + 1) if window else 0
        n = max(0, hi - lo + 1)
        n_bytes += 2 * kv * n * hd * es
        if page and n:
            n_bytes += 2 * 4 * (hi // page - lo // page + 1)
        flops += 4 * h * n * hd
    return _bound(n_bytes, flops)


def sdpa_call(q, k, v, pos, window=0):
    """PyTorch's ``scaled_dot_product_attention`` computing
    ``flash_decode``'s function on the same inputs (one query per head,
    GQA through ``enable_gqa``, the positions as a boolean mask): the
    library yardstick, timed beside the kernel and never on the path."""
    b, h, hd = q.shape
    s = k.shape[2]
    idx = torch.arange(s, device=q.device)
    p = pos.long()[:, None]
    valid = idx[None, :] <= p
    if window:
        valid &= (p - idx[None, :]) < window
    mask = valid[:, None, None, :]
    q4 = q.to(k.dtype)[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q4, k, v, attn_mask=mask,
                        enable_gqa=k.shape[1] != h)[:, :, 0]


def flash_decode_case(name, args, *, window=0, ts=0, library=False,
                      profile=False):
    """One flash decode kernel (``name``) against its plain version on
    ``args`` (2e-5: both compute in fp32 from the same inputs); the case's
    record with back-to-back, plain and bound times, and with ``profile``
    the single-call and profiled device times, and with ``library`` the
    SDPA call's time (dense only)."""
    if name == "flash_decode":
        q, k, v, pos = args
        call = lambda: fk.flash_decode(q, k, v, pos, window=window,  # noqa
                                       ts=ts)
        plain = lambda: kref.flash_decode_ref(q, k, v, pos,  # noqa: E731
                                              window=window)
        bound, by = flash_decode_bound(q, k, pos, window=window,
                                       s=k.shape[2])
        shapes = dict(k=list(k.shape), ts=ts)
    else:
        q, pool, bt_k, bt_v, pos = args
        call = lambda: fk.paged_decode(q, pool, bt_k, bt_v, pos,  # noqa
                                       window=window)
        plain = lambda: kref.paged_decode_ref(q, pool, bt_k, bt_v, pos,  # noqa
                                              window=window)
        bound, by = flash_decode_bound(
            q, pool, pos, window=window, s=bt_k.shape[1] * pool.shape[2],
            page=pool.shape[2])
        shapes = dict(pool=list(pool.shape), page=pool.shape[2])
    got = call()
    torch.cuda.synchronize()
    err = _hold(got, plain())
    rec = dict(q=list(q.shape), dtype=str(args[1].dtype),
               q_dtype=str(q.dtype), window=window, pos=pos.tolist(),
               **shapes, max_abs_err=err, ms=time_ms(call),
               plain_ms=time_ms(plain), bound_ms=bound, bound_by=by)
    if profile:
        rec["single_call_ms"] = single_call_ms(call)
        rec["device_ms"] = device_ms(call, FLASH_FUNCS[name])
    if library:
        lib = sdpa_call(q, k, v, pos, window)
        rec["library_ms"] = time_ms(lib)
        rec["library_vs_kernel_max_abs_diff"] = _max_err(lib(), got)
        if profile:
            rec["library_device_ms"] = library_device_ms(lib)
    return rec, got


def _log_flash_decode(name, case):
    log(f"{name} {case['case']}: q {tuple(case['q'])} {case['q_dtype']}, "
        + (f"k {tuple(case['k'])} ts {case['ts']}" if "k" in case else
           f"pool {tuple(case['pool'])}")
        + f" {case['dtype']} window {case['window']}: max_abs_err "
        f"{case['max_abs_err']:.3e} kernel {case['ms']:.4f} ms plain "
        f"{case['plain_ms']:.4f} ms bound {case['bound_ms']:.4f} ms "
        f"({case['bound_by']})"
        + (f" single call {case['single_call_ms']:.4f} ms, device "
           f"{case['device_ms']} ms" if "device_ms" in case else "")
        + (f" library (SDPA) {case['library_ms']:.4f} ms, SDPA vs kernel "
           f"{case['library_vs_kernel_max_abs_diff']:.3e}"
           if "library_ms" in case else ""))


def flash_decode_pair(tag, q, k, v, pos, *, window=0, page=PAGE,
                     library=False, profile=False, gen=None):
    """Both kernels on one logical cache: ``flash_decode`` on the dense
    K/V at ts == page, ``paged_decode`` on a pool holding the same rows
    at shuffled pages (table entries past each row's pos name the null
    page 0), their outputs bitwise equal. Returns {kernel: record}."""
    b, kv, s, hd = k.shape
    n = s // page
    n_pool = 2 * b * n + 5
    pool = torch.randn((n_pool, kv, page, hd), generator=gen,
                       device="cuda").to(k.dtype)
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:2 * b * n]
    bt_k = (ids[:b * n] + 1).reshape(b, n).to(torch.int32)
    bt_v = (ids[b * n:] + 1).reshape(b, n).to(torch.int32)
    pool[bt_k.long()] = k.reshape(b, kv, n, page, hd).movedim(2, 1)
    pool[bt_v.long()] = v.reshape(b, kv, n, page, hd).movedim(2, 1)
    hi_page = (pos.long().clamp(max=s - 1) // page)[:, None]
    past = torch.arange(n, device="cuda")[None, :] > hi_page
    bt_k, bt_v = bt_k.masked_fill(past, 0), bt_v.masked_fill(past, 0)
    dense, d_out = flash_decode_case(
        "flash_decode", (q, k, v, pos), window=window, ts=page,
        library=library, profile=profile)
    paged, p_out = flash_decode_case(
        "paged_decode", (q, pool, bt_k, bt_v, pos), window=window,
        profile=profile)
    if not torch.equal(d_out, p_out):
        raise AssertionError(f"{tag}: paged_decode differs from flash_decode"
                             f" at ts == page: max abs diff "
                             f"{_max_err(d_out, p_out):.3e}")
    out = {}
    for name, rec in (("flash_decode", dense), ("paged_decode", paged)):
        rec = dict(case=tag, **rec, bitwise_equal_dense=True)
        out[name] = rec
        _log_flash_decode(name, rec)
    return out, (pool, bt_k, bt_v)


def flash_decode_checks():
    """``flash_decode`` and ``paged_decode`` against their plain versions:
    the reference's sweep shapes (``tests/test_kernels.py``: MHA, GQA 4:1,
    MQA, one tile, a window of 24; fp32 and bf16), the full-width
    chai-llama-7b shape (B 4, H = KV = 32, hd 128, S 1024, bf16) and
    nemotron-4-15b's (48 query heads over 8 KV heads); paged == dense
    bitwise at ts == page on every case; the null page poisoned with 999,
    and every dense position past pos, change no output bit. The
    full-width cases also time PyTorch's SDPA on the same inputs."""
    gen = torch.Generator("cuda").manual_seed(7)
    dev = "cuda"
    cases = {"flash_decode": [], "paged_decode": []}

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    sweep = (("mha", 1, 4, 4, 32, 16, 8, 0), ("gqa4", 2, 8, 2, 64, 32, 16, 0),
             ("mqa", 3, 6, 1, 48, 8, 16, 0),
             ("single_tile", 2, 4, 4, 64, 32, 64, 0),
             ("window24", 2, 8, 4, 64, 16, 16, 24))
    for dtype in (torch.float32, torch.bfloat16):
        for tag, b, h, kv, s, hd, ts, window in sweep:
            q, k, v = (rand(b, h, hd, dtype=dtype),
                       rand(b, kv, s, hd, dtype=dtype),
                       rand(b, kv, s, hd, dtype=dtype))
            pos = torch.randint(1, s, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
            got, _ = flash_decode_pair(f"sweep_{tag}_{str(dtype)[6:]}", q,
                                       k, v, pos, window=window, page=ts,
                                       gen=gen)
            for name in cases:
                cases[name].append(got[name])
    for tag, h, kv in (("chai_llama_7b_full_width", 32, 32),
                       ("nemotron_gqa_full_width", 48, 8)):
        q = rand(4, h, 128, dtype=torch.bfloat16)
        k = rand(4, kv, MAX_SEQ, 128, dtype=torch.bfloat16)
        v = rand(4, kv, MAX_SEQ, 128, dtype=torch.bfloat16)
        pos = torch.randint(300, MAX_SEQ, (4,), generator=gen, device=dev,
                            dtype=torch.int32)
        got, (pool, bt_k, bt_v) = flash_decode_pair(
            f"synthetic_{tag}_bf16", q, k, v, pos, library=True,
            profile=True, gen=gen)
        for name in cases:
            cases[name].append(got[name])
        # poison: the null page, and every dense position past pos
        ref_p = fk.paged_decode(q, pool, bt_k, bt_v, pos)
        pool[0] = 999.0
        ref_d = fk.flash_decode(q, k, v, pos, ts=PAGE)
        past = (torch.arange(MAX_SEQ, device=dev)[None, :]
                > pos.long()[:, None])[:, None, :, None]
        kp, vp = k.masked_fill(past, 999.0), v.masked_fill(past, 999.0)
        torch.cuda.synchronize()
        if not (torch.equal(fk.paged_decode(q, pool, bt_k, bt_v, pos), ref_p)
                and torch.equal(fk.flash_decode(q, kp, vp, pos, ts=PAGE),
                                ref_d)):
            raise AssertionError(f"{tag}: a poisoned null page or position "
                                 "past pos changed the output")
        log(f"{tag}: null page 0 and positions past pos poisoned with 999: "
            "outputs bitwise unchanged")
    return cases


# ------------------------------------------------------------ phase 4 ----
def reduced_cfg(arch=ARCH):
    """The reduced model of phase 4: 2 layers, fp32. nemotron-4-15b at 12
    heads of d_model 96: 2 KV groups of 6 heads, head_dim 8 (the default
    d_model 64 would give head_dim 5; the kernels need an even one)."""
    kw = dict(n_heads=12, d_model=96) if arch == NEMO else {}
    return reduced(get_config(arch), n_layers=2, **kw)


def reduced_reference_check(arch=ARCH):
    """The reduced model on the card (kernel path) against the same model
    on the CPU (plain path), teacher-forced: prefill, 5 WARMUP steps,
    membership from the CPU buffer used on both, 3 STEADY steps."""
    cfg = reduced_cfg(arch)
    b, s = 3, 64
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, 32)))
    lens = torch.tensor([32, 19, 5])
    prefill = steps.make_serve_prefill(cfg, b, s)
    mha = steps.make_serve_step(cfg, chai=False, decode_ts=PAGE)
    chai = steps.make_serve_step(cfg, chai=True, decode_ts=PAGE)
    worst = 0.0

    def hold(lg, lc):
        nonlocal worst
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((lg.cpu() - lc).abs().max()))

    lc, sc = prefill(params_cpu, {"tokens": toks, "true_lens": lens})
    lg, sg = prefill(params_gpu, {"tokens": toks.cuda(),
                                  "true_lens": lens.cuda()})
    hold(lg, lc)
    sc = chai_cache.add_score_buffer(sc, cfg, b)
    sg = chai_cache.add_score_buffer(sg, cfg, b)
    nxt = lc.argmax(-1)
    for _ in range(cfg.chai.warmup_tokens):
        lc, sc = mha(params_cpu, {"tokens": nxt}, sc)
        lg, sg = mha(params_gpu, {"tokens": nxt.cuda()}, sg)
        hold(lg, lc)
        nxt = lc.argmax(-1)
    sc, scores = chai_cache.pop_score_buffer(sc)
    sg, scores_g = chai_cache.pop_score_buffer(sg)
    torch.testing.assert_close(scores_g.cpu(), scores, atol=1e-5, rtol=1e-4)
    ctx = clustering.identify_membership(scores, cfg)
    ctx_g = clustering.identify_membership(scores.cuda(), cfg)
    for key in ctx:   # same buffer -> same membership on either device
        if not torch.equal(ctx_g[key].cpu(), ctx[key]):
            raise AssertionError(f"membership {key} differs cpu vs cuda")
    sc = chai_cache.compact_kv(sc, ctx, cfg)
    sg = chai_cache.compact_kv(sg, ctx_g, cfg)
    before = ck.LAUNCHES["chai_fused_decode"]
    for _ in range(3):
        lc, sc = chai(params_cpu, {"tokens": nxt}, sc, ctx)
        lg, sg = chai(params_gpu, {"tokens": nxt.cuda()}, sg, ctx_g)
        hold(lg, lc)
        nxt = lc.argmax(-1)
    launched = ck.LAUNCHES["chai_fused_decode"] - before
    if launched != 3 * cfg.n_layers:
        raise AssertionError(f"reduced STEADY launched {launched} kernels")
    log(f"reduced {cfg.name} (2 layers, fp32) cuda vs cpu: logits max abs "
        f"diff {worst:.3e} over prefill + 5 WARMUP + 3 STEADY steps")


def _reset_launches():
    for counts in (ck.LAUNCHES, fk.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _launches():
    """Every kernel's launch count since the last reset."""
    return {**ck.LAUNCHES, **fk.LAUNCHES}


def _reduced_model(arch=ARCH):
    cfg = reduced_cfg(arch)
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    return cfg, params_cpu, params_gpu


def _reduced_serve(cfg, params, device, prompts, budgets, identify=None,
                   stats=None, **ecfg):
    """Serve ``prompts`` on a 2-slot continuous engine; returns ({uid:
    tokens}, [(argmax input, live rows)], [(WARMUP buffer, membership)]).
    ``identify(sc, n)``: the n-th CLUSTER transition's membership in place
    of the engine's own; ``stats``: a dict given the engine's decode step
    count."""
    eng = ServingEngine(cfg, params, EngineConfig(batch_slots=2,
                                                  page_size=PAGE, **ecfg),
                        device=device)
    calls, idents = [], []
    argmax, own = eng._argmax, getattr(eng, "_identify", None)

    def rec_argmax(lg):
        live = ([True] * lg.shape[0]
                if lg.shape[0] == 1 or eng.ecfg.scheduler == "cohort" else
                [r is not None and eng._phases[i] != chai_cache.PHASE_PREFILL
                 for i, r in enumerate(eng._slot_req)])
        calls.append((lg.detach().cpu(), live))
        return argmax(lg)

    def rec_identify(sc):
        out = identify(sc, len(idents)) if identify else own(sc)
        idents.append((sc.cpu(), {k: v.cpu() for k, v in out.items()}))
        return out

    eng._argmax = rec_argmax
    if own is not None:
        eng._identify = rec_identify
    for i, (pr, m) in enumerate(zip(prompts, budgets)):
        eng.submit(pr, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in eng.run()}
    if [len(done[u]) for u in sorted(done)] != list(budgets):
        raise AssertionError(f"{device} {ecfg}: token counts wrong")
    if eng.paged and eng.dense_pool.pages_in_use:
        raise AssertionError(f"{device} {ecfg}: pages left in use")
    if stats is not None:
        stats["steps"] = eng.steps_executed
    return done, calls, idents


def _forced_identify(cpu_idents):
    """Cluster a cuda run through the cpu run's memberships, after holding
    its WARMUP buffer to the cpu one."""
    def forced(sc, n):
        want, ctx = cpu_idents[n]
        torch.testing.assert_close(sc.cpu(), want, atol=1e-5, rtol=1e-4)
        return {k: v.cuda() for k, v in ctx.items()}
    return forced


def _hold_calls(gpu_calls, cpu_calls, label):
    """Logits of every live row at 1e-4, call by call, until the first
    greedy token that differs, which must sit on a cpu top-2 margin <=
    1e-3. Returns (calls held, logits max abs diff)."""
    worst, held = 0.0, 0
    for (lg, live), (lc, _) in zip(gpu_calls, cpu_calls):
        rows = [i for i, a in enumerate(live) if a]
        g, c = lg[rows], lc[rows]
        differ = g.argmax(-1) != c.argmax(-1)
        if differ.any():
            top2 = c.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])[differ]
            if (margin > 1e-3).any():
                raise AssertionError(f"{label}: cuda token differs at "
                                     f"margin {margin.tolist()}")
            log(f"{label}: tokens part at a near-tie (margin "
                f"{margin.tolist()}) after {held} held steps")
            break
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((g - c).abs().max()))
        held += 1
    return held, worst


def reduced_continuous_check(arch=ARCH):
    """The continuous engine on the reduced model: cpu (plain versions)
    against cuda (the kernels), paged and dense. The cuda runs cluster
    through the cpu run's membership (after holding their WARMUP buffers
    to it), so the two devices decode the same clustered attention;
    logits of every live row are held at 1e-4 until the first greedy
    token that differs, which must sit on a cpu top-2 margin <= 1e-3.
    The two cuda layouts must give identical tokens."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    rng = np.random.default_rng(1)
    budgets = (12, 7, 10, 4, 9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (11, 6, 17, 9, 14)]
    cpu_done, cpu_calls, cpu_idents = _reduced_serve(
        cfg, params_cpu, "cpu", prompts, budgets, max_seq=64)
    gpu = {}
    for layout in ("paged", "dense"):
        _reset_launches()
        gpu[layout] = _reduced_serve(
            cfg, params_gpu, "cuda", prompts, budgets,
            _forced_identify(cpu_idents), max_seq=64, kv_layout=layout)
        launched = _launches()
        own, other = (("paged_chai_fused_decode", "chai_fused_decode")
                      if layout == "paged" else
                      ("chai_fused_decode", "paged_chai_fused_decode"))
        if (not launched[own] or launched[other]
                or launched["flash_prefill"]
                or launched["paged_prefix_attend"]):
            raise AssertionError(f"reduced continuous {layout}: launches "
                                 f"{launched}")
    if gpu["paged"][0] != gpu["dense"][0]:
        raise AssertionError("reduced continuous: paged and dense layouts "
                             "gave different tokens on the card")
    held, worst = _hold_calls(gpu["paged"][1], cpu_calls,
                              "reduced continuous")
    log(f"reduced {cfg.name} continuous engine cuda vs cpu: {held} of "
        f"{len(cpu_calls)} argmax calls held, logits max abs diff "
        f"{worst:.3e}; tokens paged == dense on the card; cpu == cuda "
        f"tokens: {cpu_done == gpu['paged'][0]}")


def reduced_mha_check(arch=ARCH):
    """The MHA baseline (``use_chai=False``) on the reduced model, cuda
    (the flash decode kernels) against cpu (their plain versions): the
    continuous engine paged and dense and the cohort engine; logits held
    at 1e-4 until a near-tie; ``paged_decode`` (paged) or
    ``flash_decode`` launched n_layers times per decode step, no other
    kernel, and the eager decode attention never; paged == dense tokens
    on the card."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    rng = np.random.default_rng(4)
    budgets = (12, 7, 10, 4, 9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (11, 6, 17, 9, 14)]
    tokens = {}
    for name, kw in (("paged", dict(kv_layout="paged")),
                     ("dense", dict(kv_layout="dense")),
                     ("cohort", dict(scheduler="cohort"))):
        kw = dict(kw, max_seq=64, use_chai=False)
        _, cpu_calls, _ = _reduced_serve(cfg, params_cpu, "cpu", prompts,
                                         budgets, **kw)
        _reset_launches()
        EAGER["calls"] = 0
        stats = {}
        tokens[name], gpu_calls, _ = _reduced_serve(
            cfg, params_gpu, "cuda", prompts, budgets, stats=stats, **kw)
        launched = _launches()
        own = "paged_decode" if name == "paged" else "flash_decode"
        want = {k: 0 for k in launched}
        want[own] = cfg.n_layers * stats["steps"]
        if launched != want or EAGER["calls"]:
            raise AssertionError(f"reduced MHA {name}: launches {launched}, "
                                 f"expected {want}; eager decode calls "
                                 f"{EAGER['calls']}")
        held, worst = _hold_calls(gpu_calls, cpu_calls,
                                  f"reduced MHA {name}")
        log(f"reduced {cfg.name} MHA baseline ({name}) cuda vs cpu: "
            f"{held} of {len(cpu_calls)} argmax calls held, logits max abs "
            f"diff {worst:.3e}, launches {want[own]} of {own}")
    if tokens["paged"] != tokens["dense"]:
        raise AssertionError("reduced MHA: paged and dense tokens differ on "
                             "the card")


def reduced_chunked_check():
    """The chunked continuous engine (chunks of 16 tokens, max_seq 128) on
    the reduced model, cuda against cpu as in ``reduced_continuous_check``:
    5 prompts of 40/9/33/20/50 tokens take 3 + 3 + 2 + 4 = 12 chunks, so
    each prefill kernel launches 12 x 2 layers times; logits held at 1e-4
    until a near-tie."""
    cfg, params_cpu, params_gpu = _reduced_model()
    rng = np.random.default_rng(2)
    lens, budgets = (40, 9, 33, 20, 50), (10, 6, 8, 5, 7)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    kw = dict(max_seq=128, prefill_chunk_tokens=16)
    cpu_done, cpu_calls, cpu_idents = _reduced_serve(
        cfg, params_cpu, "cpu", prompts, budgets, **kw)
    _reset_launches()
    gpu_done, gpu_calls, _ = _reduced_serve(
        cfg, params_gpu, "cuda", prompts, budgets,
        _forced_identify(cpu_idents), **kw)
    launched = _launches()
    n_chunks = sum(-(-n // 16) for n in lens if n > 16)
    if (launched["flash_prefill"] != n_chunks * cfg.n_layers
            or launched["paged_prefix_attend"] != n_chunks * cfg.n_layers
            or not launched["paged_chai_fused_decode"]):
        raise AssertionError(f"reduced chunked: launches {launched}, "
                             f"{n_chunks} chunks")
    held, worst = _hold_calls(gpu_calls, cpu_calls, "reduced chunked")
    mono, _, _ = _reduced_serve(cfg, params_gpu, "cuda", prompts, budgets,
                                max_seq=128)
    log(f"reduced chunked engine cuda vs cpu: {n_chunks} chunks, launches "
        f"{launched}; {held} of {len(cpu_calls)} argmax calls held, logits "
        f"max abs diff {worst:.3e}; cpu == cuda tokens: "
        f"{cpu_done == gpu_done}; information only: chunked == monolithic "
        f"tokens on the card: {gpu_done == mono}")


def _prefix_traffic(rng, vocab, prefix_len, suffix_lens, suffix_new,
                    replay_new):
    """(warm request, the rest) as (uid, prompt, max_new): a shared prompt
    warmed by a request of 4 tokens (it retires in WARMUP), requests of
    the prompt plus a private suffix, then the first of them again (a
    snapshot hit) and once more with ``replay_new`` tokens (a replay)."""
    prefix = rng.integers(0, vocab, size=prefix_len).tolist()
    warm = (0, prefix + [int(rng.integers(0, vocab))], 4)
    rest = [(i + 1, prefix + rng.integers(0, vocab, size=n).tolist(), m)
            for i, (n, m) in enumerate(zip(suffix_lens, suffix_new))]
    first = rest[0][1]
    rest += [(len(rest) + 1, first, suffix_new[0]),
             (len(rest) + 2, first, replay_new)]
    return warm, rest


def _expected_hits(warm, rest, prefix_len, snapshots=True):
    """{uid: (cache_hit, cached_tokens, prefill_tokens)} of that traffic.
    Without CHAI snapshots (a GQA model), the repeated prompt is a
    ``"prefix"`` hit on every block of it the first request's prefill
    indexed, but the last token's."""
    hits = {warm[0]: ("", 0, len(warm[1]))}
    for uid, prompt, _ in rest[:-2]:
        hits[uid] = ("prefix", prefix_len, len(prompt) - prefix_len)
    for (uid, prompt, _), kind in zip(rest[-2:], ("snapshot", "replay")):
        cached = (len(prompt) - 1) // PAGE * PAGE
        hits[uid] = ((kind, len(prompt), 0) if snapshots else
                     ("prefix", cached, len(prompt) - cached))
    return hits


def reduced_prefix_relay_check(arch=ARCH):
    """The continuous engine with ``prefix_cache=True, relay_decode=True``
    on the reduced model (2 slots, max_seq 64), cuda against cpu: a
    32-token prompt warmed by one request, three suffix requests (the
    first two decode as a relay group of 2), a snapshot hit and a replay
    (a GQA model: two more prefix hits). The cuda run clusters through the
    cpu run's memberships; logits held at 1e-4 until a near-tie; the plan
    kinds as expected on both; exactly 2 x relay steps launches of
    ``relay_prefix_decode`` and 2 x each suffix prefill of each prefill
    kernel; the pools empty after a clear."""
    cfg, params_cpu, params_gpu = _reduced_model(arch)
    warm, rest = _prefix_traffic(np.random.default_rng(3), cfg.vocab_size,
                                 32, (4, 6, 5), (10, 12, 10),
                                 cfg.chai.warmup_tokens + 1)
    want_hits = _expected_hits(warm, rest, 32, snapshots=cfg.is_mha)
    runs = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, page_size=PAGE, num_pages=33,
            num_chai_pages=25, prefix_cache=True, relay_decode=True),
            device=device)
        calls, idents = [], []
        argmax, own = eng._argmax, eng._identify
        forced = (None if device == "cpu"
                  else _forced_identify(runs["cpu"]["idents"]))

        def rec_argmax(lg, eng=eng, calls=calls, argmax=argmax):
            live = ([True] if lg.shape[0] == 1 else
                    [r is not None
                     and eng._phases[i] != chai_cache.PHASE_PREFILL
                     for i, r in enumerate(eng._slot_req)])
            calls.append((lg.detach().cpu(), live))
            return argmax(lg)

        def rec_identify(sc, idents=idents, own=own, forced=forced):
            out = forced(sc, len(idents)) if forced else own(sc)
            idents.append((sc.cpu(), {k: v.cpu() for k, v in out.items()}))
            return out

        eng._argmax, eng._identify = rec_argmax, rec_identify
        _reset_launches()
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
        eng.run()
        for uid, prompt, m in rest:
            eng.submit(prompt, max_new_tokens=m, uid=uid)
        done = {r.uid: r for r in eng.run()}
        launched = _launches()
        hits = {u: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
                for u, r in done.items()}
        if hits != want_hits or not eng.relay_steps:
            raise AssertionError(f"reduced prefix/relay {device}: hits "
                                 f"{hits}, relay steps {eng.relay_steps}")
        eng.prefix_cache.clear()
        if eng.dense_pool.pages_in_use or (eng.chai_pool is not None
                                           and eng.chai_pool.pages_in_use):
            raise AssertionError(f"reduced prefix/relay {device}: pages "
                                 "left in use after clear()")
        runs[device] = dict(tokens={u: r.generated for u, r in done.items()},
                            calls=calls, idents=idents,
                            relay_steps=eng.relay_steps, launched=launched)
    gpu = runs["cuda"]
    n_suffix = len(rest) - (2 if cfg.is_mha else 0)
    if (gpu["launched"]["relay_prefix_decode"]
            != cfg.n_layers * gpu["relay_steps"]
            or gpu["launched"]["flash_prefill"] != cfg.n_layers * n_suffix
            or gpu["launched"]["paged_prefix_attend"]
            != cfg.n_layers * n_suffix
            or not gpu["launched"]["paged_chai_fused_decode"]):
        raise AssertionError(f"reduced prefix/relay: launches "
                             f"{gpu['launched']}, relay steps "
                             f"{gpu['relay_steps']}")
    held, worst = _hold_calls(gpu["calls"], runs["cpu"]["calls"],
                              "reduced prefix/relay")
    log(f"reduced {cfg.name} prefix cache + relay engine cuda vs cpu: "
        f"relay steps {gpu['relay_steps']} (cpu "
        f"{runs['cpu']['relay_steps']}), launches"
        f" {gpu['launched']}; {held} of {len(runs['cpu']['calls'])} argmax "
        f"calls held, logits max abs diff {worst:.3e}; plan kinds "
        f"{want_hits}; cpu == cuda tokens: "
        f"{runs['cpu']['tokens'] == gpu['tokens']}")


# ------------------------------------------------------------ phase 5 ----
class _Capture:
    """Stands in for ``kernels.ops`` inside ``core.chai_attention`` and
    keeps a copy of a decode op's inputs (layer 0 of the step) the first
    time ``when()`` names a step kind, under (op, kind), with the value
    ``note()`` gives; every call goes on to the real dispatch."""

    def __init__(self, when=lambda: "first", note=lambda: None):
        self.first = {}
        self.when, self.note = when, note

    def _keep(self, op, tensors, kw):
        kind = self.when()
        if kind is not None and (op, kind) not in self.first:
            self.first[op, kind] = dict(
                {k: t.clone() for k, t in tensors.items()}, kw=kw,
                note=self.note())

    def chai_decode_attention(self, q_rep, k, v, h2c, pos, **kw):
        self._keep("dense", dict(q=q_rep, k=k, v=v, h2c=h2c, pos=pos), kw)
        return kops.chai_decode_attention(q_rep, k, v, h2c, pos, **kw)

    def paged_chai_decode_attention(self, q_rep, k_pool, bt_k, v_pool, bt_v,
                                    h2c, pos, **kw):
        self._keep("paged", dict(q=q_rep, k_pool=k_pool, bt_k=bt_k,
                                 v_pool=v_pool, bt_v=bt_v, h2c=h2c, pos=pos),
                   kw)
        return kops.paged_chai_decode_attention(q_rep, k_pool, bt_k, v_pool,
                                                bt_v, h2c, pos, **kw)

    def relay_prefix_attention(self, q, k, v, k_row, a_row, v_row, plen,
                               **kw):
        self._keep("relay", dict(q=q, k=k, v=v, k_row=k_row, a_row=a_row,
                                 v_row=v_row, plen=plen), kw)
        return kops.relay_prefix_attention(q, k, v, k_row, a_row, v_row,
                                           plen, **kw)

    merge_decode_states = staticmethod(kops.merge_decode_states)
    finalize_decode_state = staticmethod(kops.finalize_decode_state)


def _timed(fn, phase, acc, calls=None):
    """``fn`` with its device time added to ``acc[phase]`` (host clock
    between two synchronizations; the engine synchronizes after every
    step anyway, when it reads the sampled tokens) and its calls counted
    in ``calls[phase]``."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[phase] = acc.get(phase, 0.0) + time.perf_counter() - t0
        if calls is not None:
            calls[phase] = calls.get(phase, 0) + 1
        return out
    return wrapped


def _check_logits(eng, vocab):
    argmax = eng._argmax

    def checked_argmax(logits):
        if logits.shape[-1] != vocab or not torch.isfinite(logits).all():
            raise AssertionError("non-finite or misshapen logits")
        return argmax(logits)
    eng._argmax = checked_argmax


def serve(cfg, params, use_chai):
    """Serve the cohort path's requests; returns (engine, requests sorted
    by uid, wall seconds, {phase: seconds})."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, scheduler="cohort",
        use_chai=use_chai, page_size=PAGE))
    phases = {}
    for attr, phase in (("_prefill", "prefill"), ("_mha_step", "mha_decode"),
                        ("_identify", "cluster"), ("_compact", "compact"),
                        ("_chai_step", "chai_decode")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, phases))
    _check_logits(eng, cfg.vocab_size)
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPT_LENS):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=MAX_NEW, uid=i)
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    return eng, sorted(done, key=lambda r: r.uid), time.time() - t0, phases


def init_full_model(arch=ARCH):
    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for grp in params.values() for t in grp.values())
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params in {cfg.dtype} "
        f"({n_params * 2 / 1e9:.2f} GB), init {time.time() - t0:.1f} s, "
        f"device memory peak during init "
        f"{torch.cuda.max_memory_allocated():,} B, allocated after "
        f"{torch.cuda.memory_allocated():,} B")
    return cfg, params


def main_path(cfg, params):
    """The cohort path (phase 5)."""
    cap = _Capture()
    chai_core.kops = cap
    try:
        _reset_launches()
        EAGER["calls"] = 0
        eng, done, wall, phases = serve(cfg, params, use_chai=True)
        launches = _launches()
        chai_eager = EAGER["calls"]
    finally:
        chai_core.kops = kops
    n_tok = sum(len(r.generated) for r in done)
    counts = [len(r.generated) for r in done]
    if counts != [MAX_NEW] * len(PROMPT_LENS):
        raise AssertionError(f"token counts {counts}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    steady = MAX_NEW - 1 - cfg.chai.warmup_tokens
    want = {name: 0 for name in launches}
    want["chai_fused_decode"] = steady * cfg.n_layers
    if launches != want:
        raise AssertionError(f"cohort path launches {launches}, expected "
                             f"{want}")
    kc, km = eng.kv_bytes(chai=True), eng.kv_bytes(chai=False)
    log(f"cohort: served {len(done)} requests (prompts {PROMPT_LENS}, "
        f"{MAX_NEW} new tokens each) in {wall:.3f} s: {n_tok / wall:.1f} "
        f"tok/s, TTFT {[round(r.ttft, 4) for r in done]} s, decode steps "
        f"{eng.steps_executed}, launches {launches} (none of flash_decode "
        f"or paged_decode: WARMUP keeps the eager attention, {chai_eager} "
        "calls)")
    log("cohort CHAI run by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()))
    log(f"KV bytes at capacity: CHAI {kc:,} vs MHA {km:,} "
        f"(saving {100 * (1 - kc / km):.2f}%)")

    first = cap.first["dense", "first"]
    rpg = first["kw"].get("reps_per_group", 1)
    err, ms, plain_ms = fused_decode_case(
        first["q"], first["k"], first["v"], first["h2c"], first["pos"],
        rpg=rpg, ts=first["kw"]["ts"])
    bound, by = fused_decode_bound(first["q"], first["k"], first["v"],
                                   first["h2c"], first["pos"], rpg)
    dense_call = (lambda: ck.chai_fused_decode(
        first["q"], first["k"], first["v"], first["h2c"], first["pos"],
        reps_per_group=rpg, ts=first["kw"]["ts"]))
    single = single_call_ms(dense_call)
    dev_ms = device_ms(dense_call, "chai_fused_decode_kernel")
    log(f"cohort layer 0, first STEADY step: q {tuple(first['q'].shape)}"
        f" {first['q'].dtype}, k {tuple(first['k'].shape)} "
        f"{first['k'].dtype}, pos {first['pos'].tolist()}: max_abs_err "
        f"{err:.3e}, kernel {ms:.4f} ms (single call {single:.4f} ms, "
        f"profiled device time {dev_ms} ms), "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")

    # The MHA baseline on the same requests: every decode step of every
    # layer through flash_decode (the cohort's dense cache, tile = page),
    # never through the eager attention the CHAI run's WARMUP keeps.
    _reset_launches()
    EAGER["calls"] = 0
    mha_eng, mha_done, mha_wall, mha_phases = serve(cfg, params,
                                                    use_chai=False)
    mha_launches = _launches()
    want = {name: 0 for name in mha_launches}
    want["flash_decode"] = cfg.n_layers * mha_eng.steps_executed
    if mha_launches != want or EAGER["calls"]:
        raise AssertionError(f"cohort MHA launches {mha_launches}, expected "
                             f"{want}; eager decode calls {EAGER['calls']}")
    agree = sum(a == b for r, m in zip(done, mha_done)
                for a, b in zip(r.generated, m.generated))
    log(f"cohort MHA baseline: {mha_eng.steps_executed} decode steps, "
        f"launches {want['flash_decode']} of flash_decode, 0 eager decode "
        f"attention calls; {n_tok / mha_wall:.1f} tok/s in {mha_wall:.3f} s "
        f"(CHAI run {n_tok / wall:.1f} tok/s in {wall:.3f} s); by phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in mha_phases.items())
        + f"; information only (random weights): CHAI vs MHA greedy token "
        f"agreement {agree}/{n_tok}")
    main = dict(case="main_path_layer0", q=list(first["q"].shape),
                k=list(first["k"].shape), v=list(first["v"].shape),
                dtype=str(first["k"].dtype), ts=first["kw"]["ts"],
                pos=first["pos"].tolist(), max_abs_err=err, ms=ms,
                single_call_ms=single, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
    return launches, main, first, mha_launches


# ------------------------------------------------------------ phase 6 ----
class _TransformerCapture:
    """Stands in for ``kernels.ops`` inside ``models.transformer`` and keeps
    a copy of each prefill op's inputs the first time ``when()`` names a
    chunk start (layer 0 of that chunk), and of each flash decode op's
    (the MHA baseline's) the first time it names an occupancy; every call
    goes on to the real dispatch."""

    def __init__(self, when):
        self.first = {}
        self.when = when

    def _keep(self, op, tensors):
        key = (op, self.when())
        if key not in self.first:
            self.first[key] = {k: t.clone() for k, t in tensors.items()}

    def paged_prefix_attention(self, q, kv_pool, bt_k, bt_v, plen):
        self._keep("paged_prefix_attend", dict(q=q, pool=kv_pool, bt_k=bt_k,
                                               bt_v=bt_v, plen=plen))
        return kops.paged_prefix_attention(q, kv_pool, bt_k, bt_v, plen)

    def flash_prefill_attention(self, q, k, v, offset=0, **kw):
        self._keep("flash_prefill", dict(q=q, k=k, v=v))
        return kops.flash_prefill_attention(q, k, v, offset, **kw)

    def flash_decode_attention(self, q, k, v, pos, **kw):
        self._keep("flash_decode", dict(q=q, k=k, v=v, pos=pos,
                                        ts=torch.tensor(kw.get("ts", 0))))
        return kops.flash_decode_attention(q, k, v, pos, **kw)

    def paged_decode_attention(self, q, kv_pool, bt_k, bt_v, pos, **kw):
        self._keep("paged_decode", dict(q=q, pool=kv_pool, bt_k=bt_k,
                                        bt_v=bt_v, pos=pos))
        return kops.paged_decode_attention(q, kv_pool, bt_k, bt_v, pos, **kw)

    merge_prefill_states = staticmethod(kops.merge_prefill_states)
    finalize_prefill_state = staticmethod(kops.finalize_prefill_state)


def _record_margins(eng):
    """Wrap the engine's argmax: {uid: [top-2 logit margin behind each of
    its greedy tokens]} (the first from the prefill's batch-1 logits,
    then one row per decode step)."""
    margins, prefilling = {}, []
    argmax, finish = eng._argmax, eng._finish_prefill

    def finish_prefill(i, req, logits):
        prefilling.append(req.uid)
        try:
            return finish(i, req, logits)
        finally:
            prefilling.pop()

    def rec_argmax(logits):
        top2 = logits.float().topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        uids = (prefilling[-1:] if prefilling else
                [r.uid if r is not None
                 and eng._phases[i] != chai_cache.PHASE_PREFILL else None
                 for i, r in enumerate(eng._slot_req)])
        for uid, gap in zip(uids, gaps):
            if uid is not None:
                margins.setdefault(uid, []).append(gap)
        return argmax(logits)

    eng._argmax, eng._finish_prefill = rec_argmax, finish_prefill
    return margins


def serve_continuous(cfg, params, layout, chunk=0, membership=None,
                     use_chai=True):
    """Serve the continuous path's requests on one KV layout (``chunk``:
    with chunked prefill), with the launches counted over the run, each
    step kind and each ``step()`` timed, the KV bytes read around every
    CLUSTER transition, the decode ops' layer-0 inputs kept at the first
    all-STEADY and mixed steps, the prefill ops' at the first chunk of
    each start position, the top-2 margin behind every greedy token and
    each request's WARMUP buffer and membership. ``membership`` ({uid:
    (buffer, ctx, _)}, another run's): cluster each request through it,
    noting whether its own membership was the same. ``use_chai=False``:
    the MHA baseline, every decode step an "mha_step", the flash decode
    ops' layer-0 inputs kept at the first step of each occupancy."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        kv_layout=layout, prefill_chunk_tokens=chunk, use_chai=use_chai))
    times, calls = {}, {}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_chunk_prefill", "chunk"),
                        ("_mha_step",
                         "warmup_step" if use_chai else "mha_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, times,
                                      calls))
    idents, own = {}, getattr(eng, "_identify", None)

    def identify(sc):
        i = int(np.flatnonzero(eng._phases == chai_cache.PHASE_CLUSTER)[0])
        uid = eng._slot_req[i].uid
        out = own(sc)        # run either way: both runs pay for K-Means
        if membership is not None:
            forced = membership[uid][1]
            same = all(torch.equal(out[k], forced[k]) for k in out)
            out = forced
        else:
            same = True
        idents[uid] = (sc.clone(), out, same)
        return out
    transitions = []
    if use_chai:
        eng._identify = identify
        cluster = eng._cluster_fn()

        def watched_cluster(*args):
            before = eng.kv_bytes()
            out = cluster(*args)
            transitions.append((before, len(eng.kv_bytes_history)))
            return out
        eng._cluster_slot = _timed(watched_cluster, "cluster", times, calls)
    _check_logits(eng, cfg.vocab_size)
    margins = _record_margins(eng)
    chunk_start = [None]
    if chunk:
        chunk_fn = eng._chunk_prefill

        def noted_chunk(*args):
            chunk_start[0] = args[3]          # prefix_len: the chunk start
            return chunk_fn(*args)
        eng._chunk_prefill = noted_chunk
    step, step_s = eng.step, []
    in_flight = {"mixed": 0, "no_decode": 0}

    def timed_step():
        mixed0 = calls.get("mixed_step", 0)
        n0 = eng.steps_executed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if any(st is not None for st in eng._slot_prefill_state):
            in_flight["mixed"] += calls.get("mixed_step", 0) > mixed0
            in_flight["no_decode"] += eng.steps_executed == n0
        return out
    eng.step = timed_step

    def step_kind():
        """"steady" when every occupied slot is STEADY, else "mixed" (the
        decode ops run only in these two kinds of step)."""
        occupied = eng._phases[eng._phases != chai_cache.PHASE_FREE]
        return ("steady" if (occupied == chai_cache.PHASE_STEADY).all()
                else "mixed")
    cap = _Capture(step_kind, lambda: torch.from_numpy(
        eng._phases.copy()).cuda())
    pcap = _TransformerCapture(
        (lambda: chunk_start[0]) if use_chai else
        (lambda: int((eng._phases != chai_cache.PHASE_FREE).sum())))
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate(zip(CONT_PROMPT_LENS, CONT_MAX_NEW)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=m, uid=i)
    chai_core.kops, tfm.kops = cap, pcap
    try:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.time()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches()
    finally:
        chai_core.kops, tfm.kops = kops, kops
    return dict(eng=eng, done=sorted(done, key=lambda r: r.uid), wall=wall,
                times=times, calls=calls, transitions=transitions,
                launches=launches, capture=cap.first, prefill=pcap.first,
                margins=margins, idents=idents, step_s=step_s,
                in_flight=in_flight)


def _check_served(cfg, run, label):
    """Token counts, vocabulary, and both step kinds ran."""
    done, calls = run["done"], run["calls"]
    counts = [len(r.generated) for r in done]
    if (counts != list(CONT_MAX_NEW)
            or any(r.finish_reason != FINISH_LENGTH for r in done)):
        raise AssertionError(f"{label}: token counts {counts}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    if not (calls.get("mixed_step") and calls.get("steady_step")):
        raise AssertionError(f"{label}: step kinds {calls}")
    if [len(run["margins"][r.uid]) for r in done] != counts:
        raise AssertionError(f"{label}: margins not recorded per token")


def _log_served(run, label):
    eng, done, calls = run["eng"], run["done"], run["calls"]
    n_tok = sum(len(r.generated) for r in done)
    per_call = {k: 1e3 * run["times"][k] / calls[k] for k in calls}
    log(f"{label}: served {len(done)} requests (prompts {CONT_PROMPT_LENS}, "
        f"new {CONT_MAX_NEW}) in {run['wall']:.3f} s: "
        f"{n_tok / run['wall']:.1f} tok/s, TTFT "
        f"{[round(r.ttft, 4) for r in done]} s (mean "
        f"{statistics.mean(r.ttft for r in done):.4f}), decode steps "
        f"{eng.steps_executed} {calls}, launches {run['launches']}")
    log(f"{label} by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["times"].items())
        + "; ms per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_call.items())
        + f"; engine steps {len(run['step_s'])}, longest "
        f"{1e3 * max(run['step_s']):.2f} ms")


def _check_kv_bytes(run, label):
    """The allocated KV bytes fall at every CLUSTER transition, and both
    pools are empty at the end."""
    eng = run["eng"]
    hist = eng.kv_bytes_history
    falls = [(before, hist[idx]["kv_bytes"])
             for before, idx in run["transitions"]]
    if (len(falls) != len(CONT_PROMPT_LENS)
            or not all(after < before for before, after in falls)):
        raise AssertionError(f"{label}: KV bytes around CLUSTER: {falls}")
    if eng.dense_pool.pages_in_use or eng.chai_pool.pages_in_use:
        raise AssertionError(f"{label}: pools not empty after the run")
    log(f"{label} KV bytes (before -> after) at each CLUSTER transition: "
        f"{falls}; peak {eng.kv_bytes_peak():,}, capacity "
        f"{eng.kv_bytes_capacity():,}, at the end {eng.kv_bytes():,}")


def continuous_path(cfg, params):
    """The continuous path on both layouts (phase 6); returns
    ({path: launches}, the paged kernel's main-path case at the first
    all-STEADY step, its case at the first mixed step, the paged run's
    tokens, margins and memberships for phase 7)."""
    runs = {}
    for layout in ("paged", "dense"):
        run = serve_continuous(cfg, params, layout)
        eng, calls = run["eng"], run["calls"]
        _check_served(cfg, run, layout)
        own = ("paged_chai_fused_decode" if layout == "paged"
               else "chai_fused_decode")
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * (calls["mixed_step"]
                                    + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{layout}: launches {run['launches']}, "
                                 f"expected {want}")
        _log_served(run, f"continuous {layout}")
        if layout == "paged":
            _check_kv_bytes(run, "continuous paged")
        else:
            log(f"continuous dense (unified layout) resident KV bytes "
                f"{eng.kv_bytes():,}")
        runs[layout] = run
        del eng
        run.pop("eng")
        run.pop("prefill")
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError("paged and dense layouts gave different "
                             "greedy tokens")
    # The same step of the same tokens on both layouts: the two kernels'
    # layer-0 inputs hold the same logical K/V for every occupied row, so
    # their outputs there are bitwise equal (a FREE row reads the null
    # page on one layout and its stale rectangle on the other).
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    if not torch.equal(pc["note"], dc["note"]):
        raise AssertionError("the layouts' first all-STEADY steps differ")
    live = pc["note"] != chai_cache.PHASE_FREE
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    paged_out = ck.paged_chai_fused_decode(*pa)
    dense_out = ck.chai_fused_decode(dc["q"], dc["k"], dc["v"], dc["h2c"],
                                     dc["pos"], ts=dc["kw"]["ts"])
    torch.cuda.synchronize()
    if not torch.equal(paged_out[live], dense_out[live]):
        raise AssertionError("paged vs dense kernel on the main path's "
                             "first all-STEADY step differ")
    err, ms, plain_ms = paged_decode_case(*pa, rpg=1)
    bound, by = fused_decode_bound(pc["q"], pc["k_pool"], pc["v_pool"],
                                   pc["h2c"], pc["pos"], 1,
                                   tables=(pc["bt_k"], pc["bt_v"]))
    dense_ms = time_ms(lambda: ck.chai_fused_decode(
        dc["q"], dc["k"], dc["v"], dc["h2c"], dc["pos"], ts=dc["kw"]["ts"]))
    single = single_call_ms(lambda: ck.paged_chai_fused_decode(*pa))
    dev_ms = device_ms(lambda: ck.paged_chai_fused_decode(*pa),
                       "paged_chai_fused_decode_kernel")
    # The first mixed step: its WARMUP rows run the kernel too (and their
    # output is discarded), with every head in cluster 0.
    mc = paged["capture"]["paged", "mixed"]
    ma = (mc["q"], mc["k_pool"], mc["bt_k"], mc["v_pool"], mc["bt_v"],
          mc["h2c"], mc["pos"])
    m_err, m_ms, m_plain_ms = paged_decode_case(*ma, rpg=1)
    log(f"continuous layer 0, first mixed step: phases "
        f"{mc['note'].tolist()}, pos {mc['pos'].tolist()}: paged kernel "
        f"{m_ms:.4f} ms (max_abs_err {m_err:.3e}, bitwise = dense kernel),"
        f" plain {m_plain_ms:.4f} ms")
    log(f"continuous layer 0, first all-STEADY step: q "
        f"{tuple(pc['q'].shape)}, k_pool {tuple(pc['k_pool'].shape)} "
        f"{pc['k_pool'].dtype}, v_pool {tuple(pc['v_pool'].shape)}, pos "
        f"{pc['pos'].tolist()}: paged kernel {ms:.4f} ms (single call "
        f"{single:.4f} ms, profiled device time {dev_ms} ms, max_abs_err "
        f"{err:.3e}, bitwise = dense kernel, dense kernel {dense_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    main = dict(case="continuous_main_path_layer0", q=list(pc["q"].shape),
                k_pool=list(pc["k_pool"].shape),
                v_pool=list(pc["v_pool"].shape),
                dtype=str(pc["k_pool"].dtype), page=PAGE,
                pos=pc["pos"].tolist(), max_abs_err=err, ms=ms,
                single_call_ms=single, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, dense_kernel_ms=dense_ms)
    mixed = dict(case="continuous_first_mixed_step_layer0",
                 phases=mc["note"].tolist(), pos=mc["pos"].tolist(),
                 max_abs_err=m_err, ms=m_ms, plain_ms=m_plain_ms)
    mono = dict(tokens={r.uid: r.generated for r in paged["done"]},
                ttft={r.uid: r.ttft for r in paged["done"]},
                margins=paged["margins"], membership=paged["idents"],
                longest_step_s=max(paged["step_s"]))
    return ({"continuous_paged": paged["launches"],
             "continuous_dense": dense["launches"]}, main, mixed, mono, pc,
            {layout: _run_summary(run) for layout, run in runs.items()})


def _run_summary(run):
    """Wall, tok/s and ms per call of each step kind of a served run."""
    n_tok = sum(len(r.generated) for r in run["done"])
    return dict(wall_s=run["wall"], tok_s=n_tok / run["wall"],
                ttft_mean_s=statistics.mean(r.ttft for r in run["done"]),
                step_ms={k: 1e3 * run["times"][k] / n
                         for k, n in run["calls"].items()})


# ------------------------------------------- phase 6b: the MHA baseline ----
def mha_baseline_path(cfg, params, chai, label):
    """The MHA baseline (``use_chai=False``) on the continuous engine with
    phase 6's traffic, paged then dense: every decode step runs
    ``paged_decode`` (paged) or ``flash_decode`` (dense) n_layers times
    and nothing else, the eager decode attention never; identical greedy
    tokens on both layouts; pools empty; wall, tok/s and step ms logged
    beside the CHAI runs of the same traffic (``chai``: their
    ``_run_summary``). Both kernels are then held against their plain
    versions on the layer-0 inputs of the first decode step with every
    slot occupied, timed there (with PyTorch's SDPA on the dense inputs),
    and held bitwise against each other there. Returns ({path: launches},
    {kernel: that case})."""
    runs, launches = {}, {}
    for layout in ("paged", "dense"):
        EAGER["calls"] = 0
        run = serve_continuous(cfg, params, layout, use_chai=False)
        eng, calls, done = run["eng"], run["calls"], run["done"]
        counts = [len(r.generated) for r in done]
        if (counts != list(CONT_MAX_NEW)
                or any(r.finish_reason != FINISH_LENGTH for r in done)
                or not all(0 <= t < cfg.vocab_size
                           for r in done for t in r.generated)):
            raise AssertionError(f"{label} {layout}: token counts {counts}")
        own = "paged_decode" if layout == "paged" else "flash_decode"
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * calls.get("mha_step", 0)
        if (run["launches"] != want or not want[own] or EAGER["calls"]
                or set(calls) - {"prefill", "mha_step"}):
            raise AssertionError(f"{label} {layout}: launches "
                                 f"{run['launches']}, expected {want}; "
                                 f"eager decode calls {EAGER['calls']}; "
                                 f"calls {calls}")
        if eng.paged and (eng.dense_pool.pages_in_use
                          or eng.chai_pool is not None):
            raise AssertionError(f"{label} {layout}: pages left in use")
        _log_served(run, f"{label} {layout}")
        mine, theirs = _run_summary(run), chai[layout]
        chai_ms = {k: theirs["step_ms"].get(f"{k}_step", float("nan"))
                   for k in ("steady", "mixed", "warmup")}
        log(f"{label} {layout} against CHAI on the same traffic: "
            f"{mine['tok_s']:.1f} tok/s against {theirs['tok_s']:.1f}, wall "
            f"{mine['wall_s']:.3f} s against {theirs['wall_s']:.3f} s, TTFT "
            f"mean {mine['ttft_mean_s']:.4f} s against "
            f"{theirs['ttft_mean_s']:.4f} s; MHA step "
            f"{mine['step_ms']['mha_step']:.2f} ms against CHAI all-STEADY "
            f"{chai_ms['steady']:.2f} ms, mixed {chai_ms['mixed']:.2f} ms, "
            f"WARMUP {chai_ms['warmup']:.2f} ms")
        run["summary"] = mine
        run.pop("eng")
        launches[f"{label}_{layout}"] = run["launches"]
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{label}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["prefill"]["paged_decode", SLOTS]
    dc = dense["prefill"]["flash_decode", SLOTS]
    if not (torch.equal(pc["pos"], dc["pos"]) and torch.equal(pc["q"],
                                                              dc["q"])):
        raise AssertionError(f"{label}: the layouts' first full steps differ")
    pa = (pc["q"], pc["pool"], pc["bt_k"], pc["bt_v"], pc["pos"])
    da = (dc["q"], dc["k"], dc["v"], dc["pos"])
    ts = int(dc["ts"])
    cases = {}
    for name, args, kw in (("flash_decode", da, dict(ts=ts, library=True)),
                           ("paged_decode", pa, {})):
        rec, _ = flash_decode_case(name, args, profile=True, **kw)
        cases[name] = dict(case=f"{label}_first_full_step_layer0", **rec)
        _log_flash_decode(name, cases[name])
    if not torch.equal(fk.paged_decode(*pa), fk.flash_decode(*da, ts=ts)):
        raise AssertionError(f"{label}: paged_decode and flash_decode differ "
                             "on the main path's first full step")
    log(f"{label}: paged_decode == flash_decode bitwise on the layer-0 "
        f"inputs of the first full step (pos {pc['pos'].tolist()}); paged "
        f"== dense tokens for all {sum(CONT_MAX_NEW)}")
    return launches, cases


# ------------------------------------------------------------ phase 7 ----
def _hold_tokens(run, mono):
    """Each request's greedy tokens against the monolithic run's, up to
    its first divergence, which must sit on a monolithic top-2 margin <=
    CHUNK_MARGIN. Returns (tokens held, tokens compared, divergences)."""
    held = compared = 0
    parted = []
    for r in run["done"]:
        want, gaps = mono["tokens"][r.uid], mono["margins"][r.uid]
        for k, (got, tok) in enumerate(zip(r.generated, want)):
            compared += 1
            if got != tok:
                if gaps[k] > CHUNK_MARGIN:
                    raise AssertionError(
                        f"chunked uid {r.uid} token {k}: {got} != {tok} at "
                        f"monolithic margin {gaps[k]:.4f} > {CHUNK_MARGIN}")
                parted.append((r.uid, k, round(gaps[k], 5)))
                break
            held += gaps[k] > CHUNK_MARGIN
    return held, compared, parted


def chunked_path(cfg, params, mono):
    """The chunked continuous path (phase 7): phase 6's paged run with
    ``prefill_chunk_tokens=CHUNK``, clustering each request through its
    phase-6 membership (its own K-Means still runs, so both runs pay for
    it, and is compared for information); returns
    (launches, the prefill kernels' main-path cases, their cases at the
    other chunk starts)."""
    run = serve_continuous(cfg, params, "paged", chunk=CHUNK,
                           membership=mono["membership"])
    eng, calls = run["eng"], run["calls"]
    _check_served(cfg, run, "chunked")
    n_chunks = sum(-(-n // CHUNK) for n in CONT_PROMPT_LENS if n > CHUNK)
    if calls.get("chunk") != n_chunks:
        raise AssertionError(f"chunked: {calls.get('chunk')} chunks, "
                             f"expected {n_chunks}")
    want = {name: 0 for name in run["launches"]}
    want["paged_chai_fused_decode"] = cfg.n_layers * (
        calls["mixed_step"] + calls["steady_step"])
    want["flash_prefill"] = want["paged_prefix_attend"] = (
        cfg.n_layers * n_chunks)
    if run["launches"] != want:
        raise AssertionError(f"chunked: launches {run['launches']}, "
                             f"expected {want}")
    _log_served(run, "continuous paged chunked")
    _check_kv_bytes(run, "continuous paged chunked")
    held, compared, parted = _hold_tokens(run, mono)
    own_same = sum(same for _, _, same in run["idents"].values())
    chunk_ms = 1e3 * run["times"]["chunk"] / calls["chunk"]
    log(f"chunked vs monolithic: {held} of {compared} tokens held at "
        f"margin > {CHUNK_MARGIN} (first divergences at near-ties: "
        f"{parted}); own K-Means membership equal to the monolithic run's "
        f"for {own_same} of {len(run['idents'])} requests; {n_chunks} "
        f"chunks, {chunk_ms:.2f} ms each; steps while chunks were in "
        f"flight: {run['in_flight']['mixed']} mixed, "
        f"{run['in_flight']['no_decode']} with no decode; TTFT mean "
        f"{statistics.mean(r.ttft for r in run['done']):.4f} s (monolithic "
        f"{statistics.mean(mono['ttft'].values()):.4f}); longest step "
        f"{1e3 * max(run['step_s']):.2f} ms (monolithic "
        f"{1e3 * mono['longest_step_s']:.2f})")
    cases = {"flash_prefill": [], "paged_prefix_attend": []}
    for (op, start), t in sorted(run["prefill"].items()):
        if op == "flash_prefill":
            case = flash_case(t["q"], t["k"], t["v"], library=start == 0)
        else:
            case = prefix_case(t["q"], t["pool"], t["bt_k"], t["bt_v"],
                               t["plen"])
        case = dict(case=f"chunk_start{start}_layer0", **case)
        cases[op].append(case)
        _log_case(f"{op} main path", case)
    mains = {"flash_prefill": cases["flash_prefill"][0],
             "paged_prefix_attend": cases["paged_prefix_attend"][-1]}
    f, p = (run["prefill"]["flash_prefill", 0],
            run["prefill"]["paged_prefix_attend", 3 * CHUNK])
    calls = {"flash_prefill": lambda: fk.flash_prefill(
        f["q"], f["k"], f["v"], emit_state=True),
             "paged_prefix_attend": lambda: fk.paged_prefix_attend(
        p["q"], p["pool"], p["bt_k"], p["bt_v"], p["plen"])}
    for op, call in calls.items():
        mains[op]["single_call_ms"] = single_call_ms(call)
        mains[op]["device_ms"] = device_ms(call, f"{op}_kernel")
        log(f"{op} main path: profiled device time "
            f"{mains[op]['device_ms']} ms, single call "
            f"{mains[op]['single_call_ms']:.4f} ms")
    if (mains["flash_prefill"]["q"][1] != CHUNK
            or mains["paged_prefix_attend"]["plen"] != [3 * CHUNK]):
        raise AssertionError(f"main-path prefill cases {mains}")
    return run["launches"], mains, cases


# ------------------------------------------------------------ phase 8 ----
def serve_prefix(cfg, params, relay):
    """Serve phase 8's traffic on a continuous paged engine with the
    prefix cache (and ``relay``: relay decode): the warm request to
    completion, then the rest. Launches counted over both; each step kind,
    each relay formation (the packed prefix views and their stack) and
    each ``step()`` timed; the decode ops' layer-0 inputs kept at the
    first step of each kind; the top-2 margin behind every greedy token
    and each request's membership recorded."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        prefix_cache=True, relay_decode=relay))
    times, calls, kind = {}, {}, {"now": None}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_suffix_prefill", "suffix_prefill"),
                        ("_mha_step", "warmup_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step"),
                        ("_relay_step", "relay_step"),
                        ("_build_relay", "relay_form")):
        if hasattr(eng, attr):
            fn = _timed(getattr(eng, attr), phase, times, calls)

            def noted(*a, _fn=fn, _k=phase.split("_")[0]):
                kind["now"] = _k
                try:
                    return _fn(*a)
                finally:
                    kind["now"] = None
            setattr(eng, attr, noted)
    idents, own = {}, eng._identify

    def identify(sc):
        i = int(np.flatnonzero(eng._phases == chai_cache.PHASE_CLUSTER)[0])
        out = own(sc)
        idents[eng._slot_req[i].uid] = {k: v.clone() for k, v in out.items()}
        return out
    eng._identify = identify
    _check_logits(eng, cfg.vocab_size)
    margins = _record_margins(eng)
    step, step_s = eng.step, []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    eng.step = timed_step
    cap = _Capture(lambda: kind["now"])
    warm, rest = _prefix_traffic(np.random.default_rng(0), cfg.vocab_size,
                                 SYS_LEN, SUFFIX_LENS, SUFFIX_NEW,
                                 cfg.chai.warmup_tokens + 1)
    chai_core.kops = cap
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.time()
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
        eng.run()
        torch.cuda.synchronize()
        warm_s = time.time() - t0
        for uid, prompt, m in rest:
            eng.submit(prompt, max_new_tokens=m, uid=uid)
        torch.cuda.synchronize()
        t0 = time.time()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _launches()
    finally:
        chai_core.kops = kops
    run = dict(eng=eng, done=sorted(done, key=lambda r: r.uid), wall=wall,
               warm_s=warm_s, times=times, calls=calls, launches=launches,
               capture=cap.first, margins=margins, idents=idents,
               step_s=step_s, warm=warm, rest=rest,
               device_peak=torch.cuda.max_memory_allocated())
    return run


def _check_prefix_run(cfg, run, label):
    """Plan kinds, token counts, launches and pools of one phase-8 run."""
    eng, done, calls = run["eng"], run["done"], run["calls"]
    warm, rest = run["warm"], run["rest"]
    want_hits = _expected_hits(warm, rest, SYS_LEN, snapshots=cfg.is_mha)
    hits = {r.uid: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for r in done}
    if hits != want_hits:
        raise AssertionError(f"{label}: plan kinds {hits}, expected "
                             f"{want_hits}")
    budgets = {uid: m for uid, _, m in [warm] + rest}
    if ({r.uid: len(r.generated) for r in done} != budgets
            or any(r.finish_reason != FINISH_LENGTH for r in done)):
        raise AssertionError(f"{label}: token counts")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    n_suffix = len(rest) - (2 if cfg.is_mha else 0)
    steps = (calls.get("relay_step", 0) + calls.get("mixed_step", 0)
             + calls.get("steady_step", 0))
    want = {name: 0 for name in run["launches"]}
    want["flash_prefill"] = want["paged_prefix_attend"] = (
        cfg.n_layers * n_suffix)
    want["paged_chai_fused_decode"] = cfg.n_layers * steps
    want["relay_prefix_decode"] = cfg.n_layers * eng.relay_steps
    if (run["launches"] != want or calls.get("suffix_prefill") != n_suffix
            or eng.relay_steps != calls.get("relay_step", 0)):
        raise AssertionError(f"{label}: launches {run['launches']}, "
                             f"expected {want}; calls {calls}")
    run["stats"] = eng.prefix_stats()
    run["kv_peak"] = eng.kv_bytes_peak()
    eng.prefix_cache.clear()
    if eng.dense_pool.pages_in_use or (eng.chai_pool is not None
                                       and eng.chai_pool.pages_in_use):
        raise AssertionError(f"{label}: pools not empty after clear()")


def _log_prefix_run(run, label):
    eng, done, calls = run["eng"], run["done"], run["calls"]
    rest = [r for r in done if r.uid != run["warm"][0]]
    n_tok = sum(len(r.generated) for r in rest)
    per_call = {k: 1e3 * run["times"][k] / calls[k] for k in calls}
    log(f"{label}: warm request {run['warm_s']:.3f} s; then {len(rest)} "
        f"requests, {n_tok} tokens in {run['wall']:.3f} s: "
        f"{n_tok / run['wall']:.1f} tok/s, TTFT "
        f"{[round(r.ttft, 4) for r in rest]} s (mean "
        f"{statistics.mean(r.ttft for r in rest):.4f}); decode steps "
        f"{eng.steps_executed}, by kind {calls}; relay steps "
        f"{eng.relay_steps}, grouped slot-steps {eng.relay_grouped_slots}; "
        f"launches {run['launches']}")
    log(f"{label} by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in run["times"].items())
        + "; ms per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in per_call.items())
        + f"; engine steps {len(run['step_s'])}, longest "
        f"{1e3 * max(run['step_s']):.2f} ms; KV bytes peak "
        f"{run['kv_peak']:,}; device memory peak {run['device_peak']:,} B; "
        f"prefix_stats {run['stats']}")


def prefix_path(cfg, params, tag="prefix"):
    """The prefix cache and relay decode at full width (phase 8, and for
    nemotron-4-15b phase 9): the same traffic with
    ``relay_decode=False``, then ``True``. A GQA model takes no CHAI
    snapshot, so its repeated prompt is a ``"prefix"`` hit like the
    others. Returns ({path: launches}, the relay kernel's main-path case,
    the paged kernel's state-mode case there)."""
    runs = {}
    for label, relay in ((f"{tag}_plain", False), (f"{tag}_relay", True)):
        run = serve_prefix(cfg, params, relay)
        _check_prefix_run(cfg, run, label)
        _log_prefix_run(run, label)
        run.pop("eng")
        runs[label] = run
        torch.cuda.empty_cache()
    plain, relay = runs[f"{tag}_plain"], runs[f"{tag}_relay"]
    if plain["calls"].get("relay_step") or not relay["calls"].get(
            "relay_step"):
        raise AssertionError(f"relay steps: plain {plain['calls']}, relay "
                             f"{relay['calls']}")
    # Relay touches only STEADY steps: every WARMUP buffer, hence every
    # membership, is the same in both runs.
    if sorted(plain["idents"]) != sorted(relay["idents"]) or not all(
            torch.equal(plain["idents"][u][k], relay["idents"][u][k])
            for u in plain["idents"] for k in plain["idents"][u]):
        raise AssertionError("relay and plain runs clustered differently")
    mono = dict(tokens={r.uid: r.generated for r in plain["done"]},
                margins=plain["margins"])
    # The warm request decodes alone (no group), and the snapshot and
    # replay requests of an MHA model take no relay step: theirs must be
    # identical; a GQA model's repeats decode in groups like the rest.
    exact = (relay["warm"][0],) + (tuple(r[0] for r in relay["rest"][-2:])
                                   if cfg.is_mha else ())
    for uid in exact:
        if mono["tokens"][uid] != [r.generated for r in relay["done"]
                                   if r.uid == uid][0]:
            raise AssertionError(f"{tag}_relay uid {uid}: tokens differ "
                                 "from the plain run")
    grouped = dict(relay, done=[r for r in relay["done"]
                                if r.uid not in exact])
    held, compared, parted = _hold_tokens(grouped, mono)
    def per(run, k):
        return (1e3 * run["times"][k] / run["calls"][k]
                if run["calls"].get(k) else float("nan"))
    form = relay["times"]["relay_form"] / relay["calls"]["relay_form"]
    same = sum(r.generated == mono["tokens"][r.uid] for r in relay["done"])
    log(f"{tag} relay vs plain: {held} of {compared} grouped-request tokens "
        f"held at plain margin > {CHUNK_MARGIN} (first divergences at "
        f"near-ties: {parted}); requests {exact} identical, and "
        f"{same} of {len(relay['done'])} requests identical in all; "
        f"memberships identical for {len(plain['idents'])} requests; mean "
        f"relay step {per(relay, 'relay_step'):.2f} ms against a plain "
        f"run's all-STEADY step {per(plain, 'steady_step'):.2f} ms and "
        f"mixed step {per(plain, 'mixed_step'):.2f} ms (the relay run's "
        f"own all-STEADY steps {per(relay, 'steady_step'):.2f} ms); relay "
        f"formation (packed views + stack) {1e3 * form:.3f} ms per step; "
        f"wall {relay['wall']:.3f} s against {plain['wall']:.3f} s")
    rc = relay["capture"]["relay", "relay"]
    ra = (rc["q"], rc["k"], rc["v"], rc["k_row"], rc["a_row"], rc["v_row"],
          rc["plen"])
    relay_main = dict(case=f"{tag}_relay_first_relay_step_layer0",
                      **relay_case(*ra, ts=rc["kw"]["ts"]))
    call = lambda: ck.relay_prefix_decode(*ra, ts=rc["kw"]["ts"])  # noqa
    relay_main["single_call_ms"] = single_call_ms(call)
    relay_main["device_ms"] = device_ms(call, "relay_prefix_decode_kernel")
    relay_main["stack_ms_per_step"] = 1e3 * form
    log(f"relay_prefix_decode {tag} (layer 0, first relay step): q "
        f"{relay_main['q']} k {relay_main['k']} {relay_main['dtype']} plen "
        f"{relay_main['plen']}: max_abs_err {relay_main['max_abs_err']:.3e},"
        f" kernel {relay_main['ms']:.4f} ms (single call "
        f"{relay_main['single_call_ms']:.4f} ms, profiled device time "
        f"{relay_main['device_ms']} ms), plain {relay_main['plain_ms']:.4f} "
        f"ms, bound {relay_main['bound_ms']:.4f} ms "
        f"({relay_main['bound_by']})")
    pc = relay["capture"]["paged", "relay"]
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    kw = dict(emit_state=True,
              reps_per_group=pc["kw"].get("reps_per_group", 1))
    got = ck.paged_chai_fused_decode(*pa, **kw)
    err = _hold(got, kref.paged_chai_fused_decode_ref(*pa, **kw))
    emit_main = dict(case=f"{tag}_relay_first_relay_step_layer0_emit_state",
                     emit_state=True, pos=pc["pos"].tolist(), max_abs_err=err,
                     ms=time_ms(lambda: ck.paged_chai_fused_decode(*pa,
                                                                   **kw)),
                     plain_ms=time_ms(lambda: kref.paged_chai_fused_decode_ref(
                         *pa, **kw)))
    log(f"paged_chai_fused_decode state mode at the same step (suffix-only "
        f"tables, pos {emit_main['pos']}): max_abs_err {err:.3e}, kernel "
        f"{emit_main['ms']:.4f} ms, plain {emit_main['plain_ms']:.4f} ms")
    return ({f"{tag}_plain": plain["launches"],
             f"{tag}_relay": relay["launches"]}, relay_main, emit_main)


# ------------------------------------------------------------ phase 9 ----
def _check_gqa_kv_bytes(run, label):
    """GQA keeps every dense K/V page until retirement (the reference's
    behaviour: no clustered pool, nothing freed at CLUSTER), so the
    allocated KV bytes do not move at a CLUSTER transition; the pool is
    empty at the end."""
    eng = run["eng"]
    hist = eng.kv_bytes_history
    around = [(before, hist[idx]["kv_bytes"])
              for before, idx in run["transitions"]]
    if (len(around) != len(CONT_PROMPT_LENS)
            or any(after != before for before, after in around)):
        raise AssertionError(f"{label}: KV bytes around CLUSTER: {around}")
    if eng.chai_pool is not None or eng.dense_pool.pages_in_use:
        raise AssertionError(f"{label}: a clustered pool, or pages left in "
                             "use")
    log(f"{label} KV bytes at each CLUSTER transition (unchanged, GQA keeps "
        f"its dense pages): {[b for b, _ in around]}; peak "
        f"{eng.kv_bytes_peak():,}, capacity {eng.kv_bytes_capacity():,}, at "
        f"the end {eng.kv_bytes():,}")


def nemotron_path(cfg, params):
    """Full-width nemotron-4-15b (GQA) through the default continuous
    engine, phase 6's traffic, on the paged layout and then the dense one
    (phase 9): launches of the own fused kernel only (n_layers per mixed
    or all-STEADY step, each with reps_per_group = r_max), identical
    greedy tokens, KV bytes unchanged at CLUSTER, empty pools, and both
    fused kernels held against their plain versions on the layer-0 GQA
    tensors of the first all-STEADY step. Returns ({path: launches},
    {kernel: [cases]}, the dense and paged captures of that step)."""
    _, r_max = clustering.chai_widths(cfg)
    runs = {}
    for layout in ("paged", "dense"):
        label = f"{cfg.name} {layout}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = serve_continuous(cfg, params, layout)
        run["device_peak"] = torch.cuda.max_memory_allocated()
        calls = run["calls"]
        _check_served(cfg, run, label)
        own, op = (("paged_chai_fused_decode", "paged") if layout == "paged"
                   else ("chai_fused_decode", "dense"))
        want = {name: 0 for name in run["launches"]}
        want[own] = cfg.n_layers * (calls["mixed_step"]
                                    + calls["steady_step"])
        if run["launches"] != want:
            raise AssertionError(f"{label}: launches {run['launches']}, "
                                 f"expected {want}")
        for kind in ("steady", "mixed"):
            rpg = run["capture"][op, kind]["kw"].get("reps_per_group")
            if rpg != r_max:
                raise AssertionError(f"{label}: reps_per_group {rpg}, "
                                     f"expected r_max = {r_max}")
        _log_served(run, label)
        log(f"{label}: device memory peak {run['device_peak']:,} B")
        if layout == "paged":
            _check_gqa_kv_bytes(run, label)
        else:
            log(f"{label} (unified layout) resident KV bytes "
                f"{run['eng'].kv_bytes():,}")
        run.pop("eng")
        run.pop("prefill")
        runs[layout] = run
        torch.cuda.empty_cache()
    paged, dense = runs["paged"], runs["dense"]
    if [r.generated for r in paged["done"]] != [r.generated
                                                for r in dense["done"]]:
        raise AssertionError(f"{cfg.name}: paged and dense layouts gave "
                             "different greedy tokens")
    pc = paged["capture"]["paged", "steady"]
    dc = dense["capture"]["dense", "steady"]
    pa = (pc["q"], pc["k_pool"], pc["bt_k"], pc["v_pool"], pc["bt_v"],
          pc["h2c"], pc["pos"])
    p_err, p_ms, p_plain = paged_decode_case(*pa, rpg=r_max)
    p_bound, p_by = fused_decode_bound(pc["q"], pc["k_pool"], pc["v_pool"],
                                       pc["h2c"], pc["pos"], r_max,
                                       tables=(pc["bt_k"], pc["bt_v"]))
    da = (dc["q"], dc["k"], dc["v"], dc["h2c"], dc["pos"])
    d_err, d_ms, d_plain = fused_decode_case(*da, rpg=r_max,
                                             ts=dc["kw"]["ts"])
    d_bound, d_by = fused_decode_bound(*da, r_max)
    cases = {
        "paged_chai_fused_decode": [dict(
            case="nemotron_paged_first_steady_layer0", q=list(pc["q"].shape),
            k_pool=list(pc["k_pool"].shape), rpg=r_max,
            dtype=str(pc["k_pool"].dtype), pos=pc["pos"].tolist(),
            max_abs_err=p_err, ms=p_ms, plain_ms=p_plain, bound_ms=p_bound,
            bound_by=p_by, bitwise_equal_dense=True)],
        "chai_fused_decode": [dict(
            case="nemotron_dense_first_steady_layer0", q=list(dc["q"].shape),
            k=list(dc["k"].shape), rpg=r_max, dtype=str(dc["k"].dtype),
            pos=dc["pos"].tolist(), max_abs_err=d_err, ms=d_ms,
            plain_ms=d_plain, bound_ms=d_bound, bound_by=d_by)]}
    n_tok = sum(len(r.generated) for r in paged["done"])
    log(f"{cfg.name} layer 0, first all-STEADY step (GQA, reps_per_group "
        f"{r_max}): paged kernel q {tuple(pc['q'].shape)} k_pool "
        f"{tuple(pc['k_pool'].shape)} pos {pc['pos'].tolist()}: {p_ms:.4f} ms"
        f" (max_abs_err {p_err:.3e}, bitwise = dense kernel), plain "
        f"{p_plain:.4f} ms, bound {p_bound:.4f} ms ({p_by}); dense kernel "
        f"{d_ms:.4f} ms (max_abs_err {d_err:.3e}), plain {d_plain:.4f} ms, "
        f"bound {d_bound:.4f} ms ({d_by}); paged == dense tokens for all "
        f"{n_tok}; TTFT mean paged "
        f"{statistics.mean(r.ttft for r in paged['done']):.4f} s, dense "
        f"{statistics.mean(r.ttft for r in dense['done']):.4f} s")
    return ({"nemotron_paged": paged["launches"],
             "nemotron_dense": dense["launches"]}, cases, dc, pc,
            {layout: _run_summary(run) for layout, run in runs.items()})


# ----------------------------------------------------------- phase 10 ----
def reference_lane_input(seed=0):
    """The reference's fused-vs-pipeline lane shape
    (``benchmarks/bench_latency.py``): b=4, h=8, r=5, s=256, hd=32, ts=64,
    fp32, made from ``seed`` with numpy as there."""
    rng = np.random.default_rng(seed)
    b, h, r, s, hd, ts = 4, 8, 5, 256, 32, 64

    def dev(x, dtype=np.float32):
        return torch.from_numpy(np.asarray(x, dtype)).cuda()
    return dict(q=dev(rng.normal(size=(b, r, hd))),
                k=dev(rng.normal(size=(b, r, s, hd))),
                v=dev(rng.normal(size=(b, h, s, hd))),
                h2c=dev(rng.integers(0, r, size=(b, h)), np.int32),
                pos=dev(rng.integers(s // 2, s, size=b), np.int32),
                kw=dict(ts=ts))


def lane_calls(kind, t, rpg, int8):
    """(pipeline call, fused call, the fused kernel's name) on one lane
    input. int8 K (the port's ``quant_rows`` of the input's K): the
    pipeline runs ``chai_qk_i8``; the fused CUDA kernel does not take int8
    yet, so the fused side is its plain version on the card."""
    if kind == "paged":
        args = (t["q"], t["k_pool"], t["bt_k"], t["v_pool"], t["bt_v"],
                t["h2c"], t["pos"])
        return (lambda: kops.paged_chai_three_kernel_decode(
                    *args, reps_per_group=rpg),
                lambda: ck.paged_chai_fused_decode(*args,
                                                   reps_per_group=rpg),
                "paged_chai_fused_decode")
    ts = t["kw"]["ts"]
    args = (t["q"], t["k"], t["v"], t["h2c"], t["pos"])
    if not int8:
        return (lambda: kops.chai_three_kernel_decode(
                    *args, reps_per_group=rpg, ts=ts),
                lambda: ck.chai_fused_decode(*args, reps_per_group=rpg,
                                             ts=ts),
                "chai_fused_decode")
    kq, ks = chai_cache.quant_rows(t["k"])
    args = (t["q"], kq, t["v"], t["h2c"], t["pos"])
    return (lambda: kops.chai_three_kernel_decode(
                *args, k_scale=ks, reps_per_group=rpg, ts=ts),
            lambda: kref.chai_fused_decode_ref(*args, k_scale=ks,
                                               reps_per_group=rpg),
            None)


def device_profile(fn, reps=20, tries=3):
    """{CUDA kernel: device ms per call of ``fn``} from a
    ``torch.profiler`` trace of ``reps`` calls (up to ``tries`` traces,
    as in ``device_ms``; empty when none holds device time)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for _ in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_time_total:
                out[e.key] = (out.get(e.key, 0.0)
                              + e.device_time_total / reps / 1e3)
        if out:
            break
    return out


def pipeline_lane(inputs):
    """The fused-vs-pipeline lane (phase 10) on each (label, kind,
    tensors, reps_per_group, int8) input: the pipeline driver (exactly 3
    launches) and the fused kernel (exactly 1) on the same inputs, with
    every count set to 0 just before each call and read just after; the
    pipeline's output held to the fused one's at 1e-4 (two summation
    orders, each held to the plain version at 2e-5 in phase 3); each
    kernel's profiled device time, back-to-back and single-call times of
    both, and ``decode_hbm_bytes_estimate`` of both. Returns (the lane's
    launches, its records)."""
    lane = {name: 0 for name in _launches()}
    records = []
    for label, kind, t, rpg, int8 in inputs:
        pipe, fused, fused_name = lane_calls(kind, t, rpg, int8)
        torch.cuda.synchronize()
        _reset_launches()
        out_p = pipe()
        n_pipe = _launches()
        _reset_launches()
        out_f = fused()
        n_fused = _launches()
        torch.cuda.synchronize()
        want_f = kops.decode_launch_count(fused=True) if fused_name else 0
        if (sum(n_pipe.values()) != kops.decode_launch_count(fused=False)
                or sum(n_fused.values()) != want_f):
            raise AssertionError(f"lane {label}: pipeline launches {n_pipe},"
                                 f" fused launches {n_fused}")
        for name in lane:
            lane[name] += n_pipe[name] + n_fused[name]
        err = _hold(out_p, out_f, dict(atol=1e-4, rtol=1e-4))
        b, r, hd = t["q"].shape
        h = t["h2c"].shape[-1]
        if kind == "paged":
            s = t["bt_k"].shape[1] * t["k_pool"].shape[2]
            cache = t["k_pool"].element_size()
        else:
            s, cache = t["k"].shape[2], (1 if int8 else t["k"].element_size())
        prof = device_profile(pipe)
        stages = {func: sum(ms for key, ms in prof.items()
                            if re.search(rf"\b{func}\b", key))
                  for func in ("qk_kernel", "row_softmax_kernel",
                               "av_kernel")}
        rec = dict(
            case=label, kind=kind, q=list(t["q"].shape), rpg=rpg, int8=int8,
            dtype=str((t["k_pool"] if kind == "paged" else t["k"]).dtype),
            pos=t["pos"].tolist(),
            launches_pipeline={k: v for k, v in n_pipe.items() if v},
            launches_fused={k: v for k, v in n_fused.items() if v},
            pipeline_vs_fused_max_abs_diff=err,
            pipeline_ms=time_ms(pipe), fused_ms=time_ms(fused),
            pipeline_single_call_ms=single_call_ms(pipe),
            fused_single_call_ms=single_call_ms(fused),
            pipeline_device_ms_by_stage=stages,
            pipeline_device_ms_three_kernels=sum(stages.values()),
            pipeline_device_ms_all=sum(prof.values()),
            fused_device_ms=(device_ms(fused, f"{fused_name}_kernel")
                             if fused_name else None),
            hbm_bytes_estimate={
                "pipeline": kops.decode_hbm_bytes_estimate(
                    b, h, r, s, hd, cache_bytes=cache, fused=False),
                "fused": kops.decode_hbm_bytes_estimate(
                    b, h, r, s, hd, cache_bytes=cache, fused=True)})
        if fused_name:
            h2c = t["h2c"]
            if h2c.ndim == 1:
                h2c = h2c.expand(b, h)
            kv = ((t["k_pool"], t["v_pool"]) if kind == "paged"
                  else (t["k"], t["v"]))
            tables = (t["bt_k"], t["bt_v"]) if kind == "paged" else ()
            bound, _ = fused_decode_bound(t["q"], *kv, h2c, t["pos"], rpg,
                                          tables=tables)
            rec.update(fused_bound_ms=bound)
            if rec["fused_device_ms"]:
                rec.update(
                    fused_over_pipeline_device=(
                        rec["fused_device_ms"]
                        / rec["pipeline_device_ms_three_kernels"]),
                    fused_over_bound=rec["fused_device_ms"] / bound)
                log(f"lane {label}: fused device "
                    f"{rec['fused_device_ms']:.4f} ms = "
                    f"{rec['fused_over_pipeline_device']:.3f} x the "
                    f"pipeline's three kernels "
                    f"({rec['pipeline_device_ms_three_kernels']:.4f} ms), "
                    f"{rec['fused_over_bound']:.1f} x its bound "
                    f"({bound:.4f} ms)")
        records.append(rec)
        log(f"lane {label} ({kind}, q {tuple(t['q'].shape)}, rpg {rpg}, "
            f"int8 {int8}): launches pipeline {rec['launches_pipeline']} "
            f"fused {rec['launches_fused']}; pipeline vs fused max abs diff "
            f"{err:.3e}; pipeline {rec['pipeline_ms']:.4f} ms back to back, "
            f"{rec['pipeline_single_call_ms']:.4f} single call, device "
            f"{rec['pipeline_device_ms_three_kernels']:.4f} (by stage "
            f"{ {k: round(v, 4) for k, v in stages.items()} }, all kernels "
            f"{rec['pipeline_device_ms_all']:.4f}); fused "
            f"{rec['fused_ms']:.4f} ms back to back, "
            f"{rec['fused_single_call_ms']:.4f} single call, device "
            f"{rec['fused_device_ms']}; HBM bytes estimate "
            f"{rec['hbm_bytes_estimate']}")
    return lane, records


def densified(t):
    """A paged capture's logical K/V views (the engine's own gather)."""
    return (chai_cache.gather_pages(t["k_pool"], t["bt_k"]),
            chai_cache.gather_pages(t["v_pool"], t["bt_v"]))


def main():
    environment()
    build_kernels()
    count_eager_decode()
    dense_cases = kernel_checks()
    paged_cases = paged_kernel_checks()
    emit_cases = emit_state_checks()
    relay_cases = relay_kernel_checks()
    split_cases, long_relay = split_decode_checks()
    flash_cases, prefix_cases = prefill_kernel_checks()
    pipe_cases = pipeline_kernel_checks()
    decode_cases = flash_decode_checks()
    for arch in (ARCH, NEMO):
        reduced_reference_check(arch)
        reduced_continuous_check(arch)
        reduced_mha_check(arch)
        reduced_prefix_relay_check(arch)
    reduced_chunked_check()
    cfg, params = init_full_model()
    cohort_launches, dense_main, cohort_cap, cohort_mha = main_path(cfg,
                                                                    params)
    (cont_launches, paged_main, paged_mixed, mono, cont_cap,
     cont_summary) = continuous_path(cfg, params)
    mha_launches, mha_mains = mha_baseline_path(cfg, params, cont_summary,
                                                "mha_continuous")
    chunked_launches, prefill_mains, path_cases = chunked_path(cfg, params,
                                                               mono)
    prefix_launches, relay_main, emit_main = prefix_path(cfg, params)
    # The engines of phases 5-8 sit in reference cycles (their wrapped
    # hooks); collect them so chai-llama-7b's weights are really freed.
    del params
    gc.collect()
    torch.cuda.empty_cache()
    ncfg, nparams = init_full_model(NEMO)
    (nemo_launches, nemo_cases, nemo_dc, nemo_pc,
     nemo_summary) = nemotron_path(ncfg, nparams)
    nemo_mha_launches, nemo_mha = mha_baseline_path(
        ncfg, nparams, nemo_summary, "nemotron_mha")
    nemo_prefix_launches, nemo_relay, nemo_emit = prefix_path(
        ncfg, nparams, tag="nemotron_prefix")
    del nparams
    gc.collect()
    torch.cuda.empty_cache()
    _, r_max = clustering.chai_widths(ncfg)
    ref_in = reference_lane_input()
    lane_launches, _ = pipeline_lane([
        ("reference_lane_shape", "dense", ref_in, 1, False),
        ("reference_lane_shape_int8", "dense", ref_in, 1, True),
        ("cohort_first_steady_layer0", "dense", cohort_cap, 1, False),
        ("cohort_first_steady_layer0_int8", "dense", cohort_cap, 1, True),
        ("continuous_paged_first_steady_layer0", "paged", cont_cap, 1,
         False),
        ("nemotron_dense_first_steady_layer0", "dense", nemo_dc, r_max,
         False),
        ("nemotron_paged_first_steady_layer0", "paged", nemo_pc, r_max,
         False)])
    # The six pipeline kernels at the continuous main path's shapes (its
    # first all-STEADY step, layer 0) and at nemotron's.
    k, v = densified(cont_cap)
    pipe_mains = pipeline_stage_cases(
        "continuous_paged_first_steady_layer0", cont_cap["q"], k, v,
        cont_cap["h2c"], cont_cap["pos"], rpg=1, mask_row=False,
        profile=True, pages=(cont_cap["k_pool"], cont_cap["bt_k"],
                             cont_cap["v_pool"], cont_cap["bt_v"]))
    k, v = densified(nemo_pc)
    qpk = ncfg.q_per_kv
    nemo_stage = pipeline_stage_cases(
        "nemotron_paged_first_steady_layer0", nemo_pc["q"], k,
        v.repeat_interleave(qpk, 1), nemo_pc["h2c"], nemo_pc["pos"],
        rpg=r_max, mask_row=False,
        pages=(nemo_pc["k_pool"], nemo_pc["bt_k"],
               nemo_pc["v_pool"].repeat_interleave(qpk, 1), nemo_pc["bt_v"]))
    by_path = {"cohort": cohort_launches, "mha_cohort": cohort_mha,
               **cont_launches, **mha_launches,
               "continuous_paged_chunked": chunked_launches,
               **prefix_launches, **nemo_launches, **nemo_mha_launches,
               **nemo_prefix_launches, "pipeline_lane": lane_launches}
    mains = {"chai_fused_decode": (
                 dense_main, "cohort",
                 dense_cases + emit_cases["chai_fused_decode"]
                 + split_cases["chai_fused_decode"]
                 + [dense_main] + nemo_cases["chai_fused_decode"]),
             "paged_chai_fused_decode": (
                 paged_main, "continuous_paged",
                 paged_cases + emit_cases["paged_chai_fused_decode"]
                 + split_cases["paged_chai_fused_decode"]
                 + [paged_mixed, emit_main, paged_main]
                 + nemo_cases["paged_chai_fused_decode"] + [nemo_emit]),
             "relay_prefix_decode": (relay_main, "prefix_relay",
                                     relay_cases + long_relay
                                     + [relay_main, nemo_relay]),
             "flash_decode": (mha_mains["flash_decode"],
                              "mha_continuous_dense",
                              decode_cases["flash_decode"]
                              + [mha_mains["flash_decode"],
                                 nemo_mha["flash_decode"]]),
             "paged_decode": (mha_mains["paged_decode"],
                              "mha_continuous_paged",
                              decode_cases["paged_decode"]
                              + [mha_mains["paged_decode"],
                                 nemo_mha["paged_decode"]]),
             "flash_prefill": (prefill_mains["flash_prefill"],
                               "continuous_paged_chunked",
                               flash_cases + path_cases["flash_prefill"]),
             "paged_prefix_attend": (
                 prefill_mains["paged_prefix_attend"],
                 "continuous_paged_chunked",
                 prefix_cases + path_cases["paged_prefix_attend"])}
    for name in PIPE_KERNELS:
        mains[name] = (pipe_mains[name][0], "pipeline_lane",
                       pipe_cases[name] + pipe_mains[name]
                       + nemo_stage[name])
    rows = []
    for name, info in KERNEL_ROWS.items():
        main_case, path, cases = mains[name]
        # A finalized bf16 output is held at one bf16 step; its error
        # stands in its own case.
        held = [c for c in cases if c.get("tolerance", "2e-5") == "2e-5"]
        rows.append(dict(
            name=name, **info, launches=by_path[path][name],
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in held),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case.get("library_ms"),
            library_device_ms=main_case.get("library_device_ms"),
            single_call_ms=main_case["single_call_ms"],
            device_ms=main_case["device_ms"], cases=cases))
        if not rows[-1]["launches"]:
            raise AssertionError(f"{name}: no launch on its path {path}")
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
