"""Compare the prefill pair's plain mode between two source trees on one GPU.

Builds ``flash_prefill`` and ``paged_prefix_attend`` from this checkout
and from another tree of the repository (for example a parent commit,
unpacked with ``git archive`` into a directory that ``.gitignore``
lists), with ``ptxas -v``, and records for each tree:

* each kernel instance's registers, stack frame and spill bytes;
* the profiled device time of the plain mode (no window, no softcap) at
  the chunked prefill's shapes of ``chip_smoke.py``'s rows 12 and 13:
  chai-llama-7b's first chunk (T = 128 queries of 32 heads of 128 over
  their own keys, bf16 state), nemotron-4-15b's (48 heads over 8),
  fp32 at hd 128, bf16 at hd 256, and ``paged_prefix_attend`` over 384
  cached positions in pages of 16 (bf16 and int8);
* each case's max abs error against the plain PyTorch version
  (``kernels.ref``), fp32 on queries of std 1 and 4;
* each instance's SASS (``cuobjdump -sass``, addresses and encodings
  dropped), compared function by function between the trees.

Each tree is measured in its own process, in the order other, this,
this, other, so that a drift of the card's clocks shows as a difference
between the two runs of one tree. The outputs of the first run of each
tree are compared: bf16 cases must be bitwise equal between the trees
(printed either way), fp32 cases are reported by their max difference.

    python tools/prefill_ab.py --other build/parent [--out DIR]

writes ``DIR/prefill_ab.json`` (default ``build/prefill_ab``, which
``.gitignore`` lists) with each tree's nvcc logs and outputs beside it,
and prints a summary; the last line is the JSON summary. Needs a CUDA
card and ``nvcc``. The runner, the profiler and the ``ptxas`` parse are
``tools/_ab.py``'s.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _ab  # noqa: E402
from _ab import PAGE  # noqa: E402

KERNELS = ("flash_prefill", "paged_prefix_attend")


def _cases(torch, fk, kref):
    """{name: (call, plain call, kernel name)} on inputs made from seed 0."""
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    out = {}
    for name, h, kv, hd, dtype, qs in (
            ("flash_llama_chunk_bf16", 32, 32, 128, torch.bfloat16, 1.0),
            ("flash_nemotron_chunk_bf16", 48, 8, 128, torch.bfloat16, 1.0),
            ("flash_hd256_bf16", 16, 8, 256, torch.bfloat16, 1.0),
            ("flash_fp32_q1", 32, 32, 128, torch.float32, 1.0),
            ("flash_fp32_q4", 32, 32, 128, torch.float32, 4.0)):
        q = rand(1, 128, h, hd, dtype=dtype, scale=qs)
        k, v = (rand(1, 128, kv, hd, dtype=dtype) for _ in range(2))
        out[name] = (
            lambda q=q, k=k, v=v: fk.flash_prefill(q, k, v, emit_state=True),
            lambda q=q, k=k, v=v: kref.flash_prefill_state_ref(q, k, v),
            "flash_prefill_kernel")
    n_pool, plen = 2 * 512 // PAGE + 1, 384
    for name, int8 in (("prefix_plen384_bf16", False),
                       ("prefix_plen384_int8", True)):
        base = torch.randn(n_pool, 32, PAGE, 128, generator=gen,
                           device="cuda")
        sc = {}
        if int8:
            amax = base.abs().amax(-1).clamp_min(1e-8)
            pool = torch.round(base / (amax[..., None] / 127)).to(torch.int8)
            sc = dict(k_scale_pool=(amax / 127).contiguous(),
                      v_scale_pool=(amax / 127).contiguous())
        else:
            pool = base.to(torch.bfloat16)
        ids = (torch.randperm(n_pool - 1, generator=gen, device="cuda")
               + 1).to(torch.int32)
        p_slot = 512 // PAGE
        bt_k, bt_v = ids[:p_slot][None], ids[p_slot:2 * p_slot][None]
        plen_t = torch.tensor([plen], dtype=torch.int32, device="cuda")
        q = rand(1, 128, 32, 128)
        args = (q, pool, bt_k, bt_v, plen_t)
        out[name] = (
            lambda a=args, s=sc: fk.paged_prefix_attend(*a, **s),
            lambda a=args, s=sc: kref.paged_prefix_attend_ref(*a, **s),
            "paged_prefix_attend_kernel")
    return out


def _instance(mangled):
    """"<type> hd<HD> <bool args>" of a prefill instance, the bool
    template arguments as 0/1 in their order (flash_prefill: the modes
    instance; paged_prefix_attend: int8)."""
    hd = re.search(r"Li(\d+)E", mangled)
    typ = "bf16" if "bfloat16" in mangled else "fp32"
    flags = "".join(re.findall(r"Lb([01])E", mangled))
    return f"{typ} hd{hd.group(1) if hd else '?'} {flags}".strip()


def measure(tree, label, out_dir):
    """One tree, in this process: build with ptxas -v, time every case,
    save the outputs under ``out_dir``; returns the record."""
    build = _ab.open_tree(tree)
    import torch
    from repro_torch.kernels import flash_attention as fk
    from repro_torch.kernels import ref as kref
    resources, seconds = ({}, {})
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources, seconds = _ab.build_verbose(build, KERNELS, _instance,
                                               out_dir, label)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "build_seconds": seconds, "cases": {}}
    if label.endswith("_1"):
        rec["sass"] = _ab.sass(build, KERNELS)
    outs = {}
    for name, (call, plain, kernel) in _cases(torch, fk, kref).items():
        got = call()
        torch.cuda.synchronize()
        want = plain()
        pairs = [(g.float(), w.float()) for g, w in zip(got, want)]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        # > 1: outside chip_smoke's 2e-5 (atol and rtol)
        ratio = max(float(((g - w).abs() / (2e-5 + 2e-5 * w.abs())).max())
                    for g, w in pairs)
        outs[name] = [t.cpu() for t in got]
        rec["cases"][name] = dict(
            max_abs_err=err, tol_ratio=ratio,
            device_ms=_ab.device_ms(torch, call, rf"\b{kernel}\b",
                                    reps=50))
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(outs, out_dir / f"{label}.pt")
    return rec


def summarize(runs, out_dir):
    """The two trees' first outputs compared (bitwise, max difference)
    and each case's median device time a tree."""
    import torch
    a = torch.load(out_dir / "other_1.pt")
    b = torch.load(out_dir / "this_1.pt")
    same = {name: dict(
        bitwise=all(torch.equal(x, y) for x, y in zip(a[name], b[name])),
        max_abs_diff=max(float((x.float() - y.float()).abs().max())
                         for x, y in zip(a[name], b[name])))
        for name in a}
    first = {r["label"]: r for r in runs if r["label"].endswith("_1")}
    return {"other_vs_this": same,
            "sass_other_vs_this": _ab.same_sass(first["other_1"]["sass"],
                                                first["this_1"]["sass"]),
            "device_ms_median": {
        side: _ab.medians(runs, side, ("device_ms",))
        for side in ("other", "this")}}


if __name__ == "__main__":
    _ab.ab_main(__file__, __doc__, measure, summarize)
