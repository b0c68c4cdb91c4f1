"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. environment: versions, the card's name and power limit, TF32 off;
2. build: every CUDA kernel of the serving path, one ``nvcc`` per source,
   all started together;
3. each kernel against its plain PyTorch version on the card, at the
   shapes the full-width main path gives it (fp32 and bf16 K/V) and at a
   GQA shape, with CUDA-event timings and the bound the card could reach;
4. a reduced model teacher-forced on the card against the same model on
   the CPU (the plain path), logits held at 1e-4;
5. the main path: full-width chai-llama-7b (bf16, random weights from a
   seed) served through the cohort ``ServingEngine`` — 4 requests, 32 new
   tokens each — with every kernel's launches counted over that run, and
   the kernel held against its plain version on the layer-0 tensors of
   the first STEADY step;
6. a ``kernels`` JSON line, the card's name and power limit, and, last,
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = dict(atol=2e-5, rtol=2e-5)
ARCH = "chai-llama-7b"
PROMPT_LENS = (200, 320, 450, 500)
MAX_NEW = 32
MAX_SEQ = 1024
PAGE = 16
KERNEL_ROWS = {
    "chai_fused_decode": dict(
        route="cuda",
        source="src/repro_torch/kernels/csrc/chai_fused_decode.cu",
        replaces="src/repro/kernels/chai_attention.py:487"),
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


def fused_decode_bound(q, k, v, h2c, pos, rpg):
    """Least time for the work these inputs need: K rows of reps that
    have members and every head's V row, positions 0..pos, read once;
    q, h2c, pos read and the (B, H, hd) fp32 output written once; the
    QK and AV multiply-adds in fp32."""
    b, _, hd = q.shape
    h = h2c.shape[1]
    esize = k.element_size()
    n_bytes = (q.numel() + h2c.numel() + pos.numel() + b * h * hd) * 4
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


# ------------------------------------------------------------ phase 5 ----
class _Capture:
    """Stands in for ``kernels.ops`` inside ``core.chai_attention`` and
    keeps a copy of the first call's inputs (layer 0 of the first STEADY
    step); every call goes on to the real dispatch."""

    def __init__(self):
        self.first = None

    def chai_decode_attention(self, q_rep, k, v, h2c, pos, **kw):
        if self.first is None:
            self.first = dict(q=q_rep.clone(), k=k.clone(), v=v.clone(),
                              h2c=h2c.clone(), pos=pos.clone(), kw=kw)
        return kops.chai_decode_attention(q_rep, k, v, h2c, pos, **kw)


def _timed(fn, phase, acc):
    """``fn`` with its device time added to ``acc[phase]`` (host clock
    between two synchronizations; the engine synchronizes after every
    step anyway, when it reads the sampled tokens)."""
    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        acc[phase] = acc.get(phase, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def serve(cfg, params, use_chai):
    """Serve the main path's requests; returns (engine, requests sorted by
    uid, wall seconds, {phase: seconds})."""
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=4, max_seq=MAX_SEQ, scheduler="cohort",
        use_chai=use_chai, page_size=PAGE))
    phases = {}
    for attr, phase in (("_prefill", "prefill"), ("_mha_step", "mha_decode"),
                        ("_identify", "cluster"), ("_compact", "compact"),
                        ("_chai_step", "chai_decode")):
        if hasattr(eng, attr):
            setattr(eng, attr, _timed(getattr(eng, attr), phase, phases))
    argmax = eng._argmax

    def checked_argmax(logits):
        if logits.shape != (4, cfg.vocab_size) or not torch.isfinite(
                logits).all():
            raise AssertionError("non-finite or misshapen logits")
        return argmax(logits)
    eng._argmax = checked_argmax
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPT_LENS):
        eng.submit(rng.integers(0, cfg.vocab_size, size=n),
                   max_new_tokens=MAX_NEW, uid=i)
    torch.cuda.synchronize()
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    return eng, sorted(done, key=lambda r: r.uid), time.time() - t0, phases


def main_path():
    cfg = get_config(ARCH)
    t0 = time.time()
    params = tfm.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for grp in params.values() for t in grp.values())
    log(f"{cfg.name}: {n_params / 1e9:.3f} B params in {cfg.dtype} "
        f"({n_params * 2 / 1e9:.2f} GB), init {time.time() - t0:.1f} s")

    cap = _Capture()
    chai_core.kops = cap
    try:
        for name in ck.LAUNCHES:
            ck.LAUNCHES[name] = 0
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
    want = steady * cfg.n_layers
    if launches["chai_fused_decode"] != want:
        raise AssertionError(f"chai_fused_decode launched "
                             f"{launches['chai_fused_decode']} times on the "
                             f"main path, expected {want}")
    kc, km = eng.kv_bytes(chai=True), eng.kv_bytes(chai=False)
    log(f"served {len(done)} requests (prompts {PROMPT_LENS}, "
        f"{MAX_NEW} new tokens each) in {wall:.3f} s: {n_tok / wall:.1f} "
        f"tok/s, TTFT {[round(r.ttft, 4) for r in done]} s, decode steps "
        f"{eng.steps_executed}, launches {launches}")
    log("CHAI run by phase (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.items()))
    log(f"KV bytes at capacity: CHAI {kc:,} vs MHA {km:,} "
        f"(saving {100 * (1 - kc / km):.2f}%)")

    first = cap.first
    rpg = first["kw"].get("reps_per_group", 1)
    err, ms, plain_ms = fused_decode_case(
        first["q"], first["k"], first["v"], first["h2c"], first["pos"],
        rpg=rpg, ts=first["kw"]["ts"])
    bound, by = fused_decode_bound(first["q"], first["k"], first["v"],
                                   first["h2c"], first["pos"], rpg)
    log(f"main-path layer 0, first STEADY step: q {tuple(first['q'].shape)}"
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


def main():
    environment()
    build_kernels()
    cases = kernel_checks()
    reduced_reference_check()
    launches, main_case = main_path()
    cases.append(main_case)
    rows = []
    for name, info in KERNEL_ROWS.items():
        rows.append(dict(
            name=name, **info, launches=launches[name],
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
