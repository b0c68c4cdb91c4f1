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
   layer-0 tensors of the first STEADY step;
6. the continuous main path: the same model through the default
   continuous ``ServingEngine``, 4 slots, 8 requests, once per KV layout
   (paged, then dense), with the launches counted over each run, the
   greedy tokens of the two layouts identical, the KV bytes falling at
   every CLUSTER transition and both pools empty at the end;
7. the chunked continuous path: the paged run of phase 6 again with
   ``prefill_chunk_tokens=128`` (20 chunks, so 640 launches of each
   prefill kernel), its greedy tokens held against phase 6's on every
   step whose phase-6 top-2 logit margin exceeds ``CHUNK_MARGIN``, the
   prefill kernels held against their plain versions on the layer-0
   inputs of its chunks and timed there;
8. a ``kernels`` JSON line, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
}


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


def device_ms(fn, kernel, reps=20):
    """Device time per launch of the CUDA kernel named ``kernel`` over
    ``reps`` calls of ``fn``, from a ``torch.profiler`` trace of the card:
    no host time in it, whichever side is the slower. None when the trace
    holds no device time for that kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    pat = re.compile(rf"\b{kernel}\b")
    hits = [e for e in prof.key_averages() if pat.search(e.key)]
    count = sum(e.count for e in hits)
    total_us = sum(e.device_time_total for e in hits)
    return total_us / count / 1e3 if count and total_us else None


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


# ------------------------------------------------------------ phase 4 ----
def reduced_reference_check():
    """The reduced model on the card (kernel path) against the same model
    on the CPU (plain path), teacher-forced: prefill, 5 WARMUP steps,
    membership from the CPU buffer used on both, 3 STEADY steps."""
    cfg = reduced(get_config(ARCH), n_layers=2)
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


def _reduced_model():
    cfg = reduced(get_config(ARCH), n_layers=2)
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    return cfg, params_cpu, params_gpu


def _reduced_serve(cfg, params, device, prompts, budgets, identify=None,
                   **ecfg):
    """Serve ``prompts`` on a 2-slot continuous engine; returns ({uid:
    tokens}, [(argmax input, live rows)], [(WARMUP buffer, membership)]).
    ``identify(sc, n)``: the n-th CLUSTER transition's membership in place
    of the engine's own."""
    eng = ServingEngine(cfg, params, EngineConfig(batch_slots=2,
                                                  page_size=PAGE, **ecfg),
                        device=device)
    calls, idents = [], []
    argmax, own = eng._argmax, eng._identify

    def rec_argmax(lg):
        live = ([True] if lg.shape[0] == 1 else
                [r is not None and eng._phases[i] != chai_cache.PHASE_PREFILL
                 for i, r in enumerate(eng._slot_req)])
        calls.append((lg.detach().cpu(), live))
        return argmax(lg)

    def rec_identify(sc):
        out = identify(sc, len(idents)) if identify else own(sc)
        idents.append((sc.cpu(), {k: v.cpu() for k, v in out.items()}))
        return out

    eng._argmax, eng._identify = rec_argmax, rec_identify
    for i, (pr, m) in enumerate(zip(prompts, budgets)):
        eng.submit(pr, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in eng.run()}
    if [len(done[u]) for u in sorted(done)] != list(budgets):
        raise AssertionError(f"{device} {ecfg}: token counts wrong")
    if eng.paged and eng.dense_pool.pages_in_use:
        raise AssertionError(f"{device} {ecfg}: pages left in use")
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


def reduced_continuous_check():
    """The continuous engine on the reduced model: cpu (plain versions)
    against cuda (the kernels), paged and dense. The cuda runs cluster
    through the cpu run's membership (after holding their WARMUP buffers
    to it), so the two devices decode the same clustered attention;
    logits of every live row are held at 1e-4 until the first greedy
    token that differs, which must sit on a cpu top-2 margin <= 1e-3.
    The two cuda layouts must give identical tokens."""
    cfg, params_cpu, params_gpu = _reduced_model()
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
    log(f"reduced continuous engine cuda vs cpu: {held} of "
        f"{len(cpu_calls)} argmax calls held, logits max abs diff "
        f"{worst:.3e}; tokens paged == dense on the card; cpu == cuda "
        f"tokens: {cpu_done == gpu['paged'][0]}")


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


def init_full_model():
    cfg = get_config(ARCH)
    t0 = time.time()
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for grp in params.values() for t in grp.values())
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params in {cfg.dtype} "
        f"({n_params * 2 / 1e9:.2f} GB), init {time.time() - t0:.1f} s")
    return cfg, params


def main_path(cfg, params):
    """The cohort path (phase 5)."""
    cap = _Capture()
    chai_core.kops = cap
    try:
        _reset_launches()
        eng, done, wall, phases = serve(cfg, params, use_chai=True)
        launches = _launches()
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
        f"{eng.steps_executed}, launches {launches}")
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

    _, mha_done, mha_wall, mha_phases = serve(cfg, params, use_chai=False)
    agree = sum(a == b for r, m in zip(done, mha_done)
                for a, b in zip(r.generated, m.generated))
    log(f"information only (random weights): CHAI vs MHA greedy token "
        f"agreement {agree}/{n_tok}; MHA run {mha_wall:.3f} s, by phase "
        + ", ".join(f"{k} {v:.4f}" for k, v in mha_phases.items()))
    main = dict(case="main_path_layer0", q=list(first["q"].shape),
                k=list(first["k"].shape), v=list(first["v"].shape),
                dtype=str(first["k"].dtype), ts=first["kw"]["ts"],
                pos=first["pos"].tolist(), max_abs_err=err, ms=ms,
                single_call_ms=single, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
    return launches, main


# ------------------------------------------------------------ phase 6 ----
class _PrefillCapture:
    """Stands in for ``kernels.ops`` inside ``models.transformer`` and keeps
    a copy of each prefill op's inputs the first time ``when()`` names a
    chunk start (layer 0 of that chunk); every call goes on to the real
    dispatch."""

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


def serve_continuous(cfg, params, layout, chunk=0, membership=None):
    """Serve the continuous path's requests on one KV layout (``chunk``:
    with chunked prefill), with the launches counted over the run, each
    step kind and each ``step()`` timed, the KV bytes read around every
    CLUSTER transition, the decode ops' layer-0 inputs kept at the first
    all-STEADY and mixed steps, the prefill ops' at the first chunk of
    each start position, the top-2 margin behind every greedy token and
    each request's WARMUP buffer and membership. ``membership`` ({uid:
    (buffer, ctx, _)}, another run's): cluster each request through it,
    noting whether its own membership was the same."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        kv_layout=layout, prefill_chunk_tokens=chunk))
    times, calls = {}, {}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_chunk_prefill", "chunk"),
                        ("_mha_step", "warmup_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, times,
                                      calls))
    idents, own = {}, eng._identify

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
    eng._identify = identify
    cluster = eng._cluster_fn()
    transitions = []

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
    pcap = _PrefillCapture(lambda: chunk_start[0])
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
             "continuous_dense": dense["launches"]}, main, mixed, mono)


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


def main():
    environment()
    build_kernels()
    dense_cases = kernel_checks()
    paged_cases = paged_kernel_checks()
    flash_cases, prefix_cases = prefill_kernel_checks()
    reduced_reference_check()
    reduced_continuous_check()
    reduced_chunked_check()
    cfg, params = init_full_model()
    cohort_launches, dense_main = main_path(cfg, params)
    cont_launches, paged_main, paged_mixed, mono = continuous_path(cfg,
                                                                   params)
    chunked_launches, prefill_mains, path_cases = chunked_path(cfg, params,
                                                               mono)
    by_path = {"cohort": cohort_launches, **cont_launches,
               "continuous_paged_chunked": chunked_launches}
    mains = {"chai_fused_decode": (dense_main, "cohort",
                                   dense_cases + [dense_main]),
             "paged_chai_fused_decode": (
                 paged_main, "continuous_paged",
                 paged_cases + [paged_mixed, paged_main]),
             "flash_prefill": (prefill_mains["flash_prefill"],
                               "continuous_paged_chunked",
                               flash_cases + path_cases["flash_prefill"]),
             "paged_prefix_attend": (
                 prefill_mains["paged_prefix_attend"],
                 "continuous_paged_chunked",
                 prefix_cases + path_cases["paged_prefix_attend"])}
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
            single_call_ms=main_case["single_call_ms"],
            device_ms=main_case["device_ms"], cases=cases))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
