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
   dense kernel at page = tile;
4. a reduced model on the card against the same model on the CPU (the
   plain path): teacher-forced cohort steps, logits held at 1e-4; then
   the continuous engine, paged and dense, cuda against cpu;
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
7. a ``kernels`` JSON line, the card's name and power limit, and, last,
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig, ServingEngine)
from repro_torch.serving.sampling import FINISH_LENGTH  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "chai-llama-7b"
PROMPT_LENS = (200, 320, 450, 500)
MAX_NEW = 32
CONT_PROMPT_LENS = (200, 320, 450, 500, 96, 160, 384, 256)
CONT_MAX_NEW = (32, 48) * 4
MAX_SEQ = 1024
PAGE = 16
SLOTS = 4
KERNEL_ROWS = {
    "chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:487"),
    "paged_chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/paged_chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:579"),
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
    """Median over ``reps`` single calls, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0


def reduced_continuous_check():
    """The continuous engine on the reduced model: cpu (plain versions)
    against cuda (the kernels), paged and dense. The cuda runs cluster
    through the cpu run's membership (after holding their WARMUP buffers
    to it), so the two devices decode the same clustered attention;
    logits of every live row are held at 1e-4 until the first greedy
    token that differs, which must sit on a cpu top-2 margin <= 1e-3.
    The two cuda layouts must give identical tokens."""
    cfg = reduced(get_config(ARCH), n_layers=2)
    params_cpu = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    params_gpu = {g: {n: t.cuda() for n, t in grp.items()}
                  for g, grp in params_cpu.items()}
    rng = np.random.default_rng(1)
    budgets = (12, 7, 10, 4, 9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (11, 6, 17, 9, 14)]

    def run(params, device, layout, identify=None):
        eng = ServingEngine(cfg, params, EngineConfig(
            batch_slots=2, max_seq=64, page_size=PAGE, kv_layout=layout),
            device=device)
        calls, idents = [], []
        argmax, own = eng._argmax, eng._identify

        def rec_argmax(lg):
            live = ([True] if lg.shape[0] == 1 else
                    [r is not None for r in eng._slot_req])
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
            raise AssertionError(f"{device} {layout}: token counts wrong")
        return done, calls, idents

    cpu_done, cpu_calls, cpu_idents = run(params_cpu, "cpu", "paged")

    def forced(sc, n):
        want, ctx = cpu_idents[n]
        torch.testing.assert_close(sc.cpu(), want, atol=1e-5, rtol=1e-4)
        return {k: v.cuda() for k, v in ctx.items()}

    gpu = {}
    for layout in ("paged", "dense"):
        _reset_launches()
        gpu[layout] = run(params_gpu, "cuda", layout, forced)
        launched = dict(ck.LAUNCHES)
        own, other = (("paged_chai_fused_decode", "chai_fused_decode")
                      if layout == "paged" else
                      ("chai_fused_decode", "paged_chai_fused_decode"))
        if not launched[own] or launched[other]:
            raise AssertionError(f"reduced continuous {layout}: launches "
                                 f"{launched}")
    if gpu["paged"][0] != gpu["dense"][0]:
        raise AssertionError("reduced continuous: paged and dense layouts "
                             "gave different tokens on the card")
    worst, held = 0.0, 0
    for (lg, live), (lc, _) in zip(gpu["paged"][1], cpu_calls):
        rows = [i for i, a in enumerate(live) if a]
        g, c = lg[rows], lc[rows]
        differ = g.argmax(-1) != c.argmax(-1)
        if differ.any():
            top2 = c.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1])[differ]
            if (margin > 1e-3).any():
                raise AssertionError(f"reduced continuous: cuda token "
                                     f"differs at margin {margin.tolist()}")
            log(f"reduced continuous: tokens part at a near-tie (margin "
                f"{margin.tolist()}) after {held} held steps")
            break
        torch.testing.assert_close(g, c, atol=1e-4, rtol=1e-4)
        worst = max(worst, float((g - c).abs().max()))
        held += 1
    log(f"reduced continuous engine cuda vs cpu: {held} of "
        f"{len(cpu_calls)} argmax calls held, logits max abs diff "
        f"{worst:.3e}; tokens paged == dense on the card; cpu == cuda "
        f"tokens: {cpu_done == gpu['paged'][0]}")


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
        launches = dict(ck.LAUNCHES)
    finally:
        chai_core.kops = kops
    n_tok = sum(len(r.generated) for r in done)
    counts = [len(r.generated) for r in done]
    if counts != [MAX_NEW] * len(PROMPT_LENS):
        raise AssertionError(f"token counts {counts}")
    if not all(0 <= t < cfg.vocab_size for r in done for t in r.generated):
        raise AssertionError("token id out of vocabulary")
    steady = MAX_NEW - 1 - cfg.chai.warmup_tokens
    want = {"chai_fused_decode": steady * cfg.n_layers,
            "paged_chai_fused_decode": 0}
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
    log(f"cohort layer 0, first STEADY step: q {tuple(first['q'].shape)}"
        f" {first['q'].dtype}, k {tuple(first['k'].shape)} "
        f"{first['k'].dtype}, pos {first['pos'].tolist()}: max_abs_err "
        f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{bound:.4f} ms ({by})")

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
                plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    return launches, main


# ------------------------------------------------------------ phase 6 ----
def serve_continuous(cfg, params, layout):
    """Serve the continuous path's requests on one KV layout, with the
    launches counted over the run, each step kind timed and counted,
    the KV bytes read around every CLUSTER transition and the decode
    ops' layer-0 inputs kept at the first all-STEADY step."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, page_size=PAGE,
        kv_layout=layout))
    times, calls = {}, {}
    for attr, phase in (("_slot_prefill", "prefill"),
                        ("_mha_step", "warmup_step"),
                        ("_mixed_step", "mixed_step"),
                        ("_chai_step", "steady_step")):
        setattr(eng, attr, _timed(getattr(eng, attr), phase, times, calls))
    cluster = eng._cluster_fn()
    transitions = []

    def watched_cluster(*args):
        before = eng.kv_bytes()
        out = cluster(*args)
        transitions.append((before, len(eng.kv_bytes_history)))
        return out
    eng._cluster_slot = _timed(watched_cluster, "cluster", times, calls)
    _check_logits(eng, cfg.vocab_size)

    def step_kind():
        """"steady" when every occupied slot is STEADY, else "mixed" (the
        decode ops run only in these two kinds of step)."""
        occupied = eng._phases[eng._phases != chai_cache.PHASE_FREE]
        return ("steady" if (occupied == chai_cache.PHASE_STEADY).all()
                else "mixed")
    cap = _Capture(step_kind, lambda: torch.from_numpy(
        eng._phases.copy()).cuda())
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate(zip(CONT_PROMPT_LENS, CONT_MAX_NEW)):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=m, uid=i)
    chai_core.kops = cap
    try:
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.time()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(ck.LAUNCHES)
    finally:
        chai_core.kops = kops
    return dict(eng=eng, done=sorted(done, key=lambda r: r.uid), wall=wall,
                times=times, calls=calls, transitions=transitions,
                launches=launches, capture=cap.first)


def continuous_path(cfg, params):
    """The continuous path on both layouts (phase 6); returns
    ({path: launches}, the paged kernel's main-path case at the first
    all-STEADY step, its case at the first mixed step)."""
    runs = {}
    for layout in ("paged", "dense"):
        run = serve_continuous(cfg, params, layout)
        eng, done, calls = run["eng"], run["done"], run["calls"]
        counts = [len(r.generated) for r in done]
        if (counts != list(CONT_MAX_NEW)
                or any(r.finish_reason != FINISH_LENGTH for r in done)):
            raise AssertionError(f"{layout}: token counts {counts}")
        if not all(0 <= t < cfg.vocab_size for r in done
                   for t in r.generated):
            raise AssertionError("token id out of vocabulary")
        n_mixed, n_steady = calls.get("mixed_step", 0), calls.get(
            "steady_step", 0)
        if not (n_mixed and n_steady):
            raise AssertionError(f"{layout}: step kinds {calls}")
        own = ("paged_chai_fused_decode" if layout == "paged"
               else "chai_fused_decode")
        want = {name: 0 for name in ck.LAUNCHES}
        want[own] = cfg.n_layers * (n_mixed + n_steady)
        if run["launches"] != want:
            raise AssertionError(f"{layout}: launches {run['launches']}, "
                                 f"expected {want}")
        n_tok = sum(counts)
        per_step = {k: 1e3 * run["times"][k] / calls[k]
                    for k in calls if k.endswith("_step")}
        log(f"continuous {layout}: served {len(done)} requests (prompts "
            f"{CONT_PROMPT_LENS}, new {CONT_MAX_NEW}) in {run['wall']:.3f}"
            f" s: {n_tok / run['wall']:.1f} tok/s, TTFT "
            f"{[round(r.ttft, 4) for r in done]} s (mean "
            f"{statistics.mean(r.ttft for r in done):.4f}), decode steps "
            f"{eng.steps_executed} {calls}, launches {run['launches']}")
        log(f"continuous {layout} by phase (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in run["times"].items())
            + "; ms per step: " + ", ".join(
                f"{k} {v:.2f}" for k, v in per_step.items()))
        if layout == "paged":
            hist = eng.kv_bytes_history
            falls = [(before, hist[idx]["kv_bytes"])
                     for before, idx in run["transitions"]]
            if (len(falls) != len(CONT_PROMPT_LENS)
                    or not all(after < before for before, after in falls)):
                raise AssertionError(f"KV bytes around CLUSTER: {falls}")
            if eng.dense_pool.pages_in_use or eng.chai_pool.pages_in_use:
                raise AssertionError("pools not empty after the run")
            log(f"continuous paged KV bytes (before -> after) at each "
                f"CLUSTER transition: {falls}; peak "
                f"{eng.kv_bytes_peak():,}, capacity "
                f"{eng.kv_bytes_capacity():,}, at the end "
                f"{eng.kv_bytes():,}")
        else:
            log(f"continuous dense (unified layout) resident KV bytes "
                f"{eng.kv_bytes():,}")
        runs[layout] = run
        del eng
        run.pop("eng")
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
        f"{pc['pos'].tolist()}: paged kernel {ms:.4f} ms (max_abs_err "
        f"{err:.3e}, bitwise = dense kernel, dense kernel {dense_ms:.4f} "
        f"ms), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    main = dict(case="continuous_main_path_layer0", q=list(pc["q"].shape),
                k_pool=list(pc["k_pool"].shape),
                v_pool=list(pc["v_pool"].shape),
                dtype=str(pc["k_pool"].dtype), page=PAGE,
                pos=pc["pos"].tolist(), max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                dense_kernel_ms=dense_ms)
    mixed = dict(case="continuous_first_mixed_step_layer0",
                 phases=mc["note"].tolist(), pos=mc["pos"].tolist(),
                 max_abs_err=m_err, ms=m_ms, plain_ms=m_plain_ms)
    return ({"continuous_paged": paged["launches"],
             "continuous_dense": dense["launches"]}, main, mixed)


def main():
    environment()
    build_kernels()
    dense_cases = kernel_checks()
    paged_cases = paged_kernel_checks()
    reduced_reference_check()
    reduced_continuous_check()
    cfg, params = init_full_model()
    cohort_launches, dense_main = main_path(cfg, params)
    cont_launches, paged_main, paged_mixed = continuous_path(cfg, params)
    by_path = {"cohort": cohort_launches, **cont_launches}
    mains = {"chai_fused_decode": (dense_main, "cohort", dense_cases),
             "paged_chai_fused_decode": (paged_main, "continuous_paged",
                                         paged_cases + [paged_mixed])}
    rows = []
    for name, info in KERNEL_ROWS.items():
        main_case, path, cases = mains[name]
        cases = cases + [main_case]
        rows.append(dict(
            name=name, **info, launches=by_path[path][name],
            launches_by_path={p: c[name] for p, c in by_path.items()},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=None, cases=cases))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
