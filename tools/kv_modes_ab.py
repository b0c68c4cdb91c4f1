"""Compare the K/V pairings the serving paths run between two source trees
on one GPU: the fused decode pair, the relay kernel and the prefix pass.

Builds ``csrc/chai_fused_decode.cu``, ``paged_chai_fused_decode.cu``,
``relay_prefix_decode.cu`` and ``paged_prefix_attend.cu`` from this
checkout and from another tree of the repository (for example the parent
commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), with ``ptxas -v``, and records for each tree:

* each source's build seconds (all four started together) and each
  kernel instance's registers and spill bytes;
* the SHA-256 of every output's bytes, so that the two trees' bits can
  be compared;
* the profiled device time of each case (20 calls back to back);
on ``chip_smoke.py``'s full-width shapes (hd 128, page 16, seed 0):
the fused pair at the lane's layer-0 shape (B 4, chai-llama-7b's 32
heads over 25 reps, S 1024, pos 300-1000) in bf16 (finalized and
``emit_state``), fp32, int8 K and V with their scales (the int8 cache)
and the share mode's int8 K with scales beside raw int8 V codes, and
nemotron's GQA shape (48 heads over 8 KV groups, 5 reps a group) in
bf16; the relay kernel on two MHA groups of 4 and 3 members at plen 200
and 256 (bf16; int8 with scales; int8 K with scales beside raw V codes);
the prefix pass over shuffled pages at plen 0, 200 and 384 (bf16; an int8
pool with its scales beside bf16 queries).

Each tree is measured in its own process, in the order other, this,
this, other, so that a drift of the card's clocks shows as a difference
between the two runs of one tree.

    python tools/kv_modes_ab.py --other build/parent [--out DIR]

writes ``DIR/kv_modes_ab.json`` (default ``build/kv_modes_ab``, which
``.gitignore`` lists) and prints a summary; the last line is the JSON of
each case's median device times and whether every output's bits agree
across the four runs. Needs a CUDA card and ``nvcc``. The runner, the
profiler and the ``ptxas`` parse are ``tools/_ab.py``'s.
"""
from __future__ import annotations

import hashlib
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _ab  # noqa: E402
from _ab import PAGE  # noqa: E402

SOURCES = ("chai_fused_decode", "paged_chai_fused_decode",
           "relay_prefix_decode", "paged_prefix_attend")


def _pages(torch, gen, x, scale=None, n_extra=7):
    """Dense (B, rows, S, hd) -> (pool, block table[, scale pool]): every
    row's pages at shuffled ids of a pool whose other pages hold random
    values."""
    b, rows, s, hd = x.shape
    n = s // PAGE
    n_pool = b * n + n_extra
    pool = torch.randn((n_pool, rows, PAGE, hd), generator=gen,
                       device="cuda").to(x.dtype)
    ids = torch.randperm(n_pool - 1, generator=gen, device="cuda")[:b * n]
    bt = (ids + 1).reshape(b, n).to(torch.int32)
    pool[bt.long()] = x.reshape(b, rows, n, PAGE, hd).movedim(2, 1)
    if scale is None:
        return pool, bt, None
    spool = torch.rand((n_pool, rows, PAGE), generator=gen, device="cuda")
    spool[bt.long()] = scale.reshape(b, rows, n, PAGE).movedim(2, 1)
    return pool, bt, spool


def _cases(torch, ck, fk, cache):
    """{name: (kernel name, call)} on inputs made from seed 0."""
    gen = torch.Generator("cuda").manual_seed(0)
    dev = "cuda"
    out = {}
    for shape, b, h, kv, rpg in (("mha", 4, 32, 25, 1),
                                 ("gqa", 4, 48, 8, 5)):
        s, hd = 1024, 128
        q = torch.randn(b, kv * rpg, hd, generator=gen, device=dev)
        k = torch.randn(b, kv, s, hd, generator=gen, device=dev)
        v = torch.randn(b, h if rpg == 1 else kv, s, hd, generator=gen,
                        device=dev)
        vs = torch.randn(b, kv, s, hd, generator=gen, device=dev)
        pos = torch.randint(300, 1001, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        if rpg == 1:
            h2c = torch.randint(0, kv, (b, h), generator=gen, device=dev,
                                dtype=torch.int32)
        else:
            grp = torch.arange(h, device=dev) // (h // kv)
            h2c = (grp[None] * rpg + torch.randint(
                0, rpg, (b, h), generator=gen, device=dev)).to(torch.int32)
        modes = {"bf16": (k.bfloat16(), None, v.bfloat16(), None, {}),
                 "bf16_emit": (k.bfloat16(), None, v.bfloat16(), None,
                               dict(emit_state=True))}
        if shape == "mha":
            kq, ksc = cache.quant_rows(k)
            vq, vsc = cache.quant_rows(v)
            modes.update({
                "fp32": (k, None, v, None, {}),
                "int8": (kq, ksc, vq, vsc, {}),
                "share_int8": (kq, ksc, cache.plain_int8(vs * 40), None,
                               dict(share_values=True))})
        for mode, (kk, ks, vv, vsc_, kw) in modes.items():
            kp, bt_k, ksp = _pages(torch, gen, kk, ks)
            vp, bt_v, vsp = _pages(torch, gen, vv, vsc_)
            kd = kp[bt_k.long()].movedim(1, 2).reshape(kk.shape)
            vd = vp[bt_v.long()].movedim(1, 2).reshape(vv.shape)
            dense_sc = {}
            if ks is not None:
                dense_sc["k_scale"] = ksp[bt_k.long()].movedim(
                    1, 2).reshape(ks.shape)
            if vsc_ is not None:
                dense_sc["v_scale"] = vsp[bt_v.long()].movedim(
                    1, 2).reshape(vsc_.shape)
            out[f"fused_{shape}_{mode}"] = (
                "chai_fused_decode",
                lambda a=(q, kd, vd, h2c, pos), kw=kw, sc=dense_sc, r=rpg:
                ck.chai_fused_decode(*a, reps_per_group=r, ts=PAGE, **sc,
                                     **kw))
            out[f"paged_{shape}_{mode}"] = (
                "paged_chai_fused_decode",
                lambda a=(q, kp, bt_k, vp, bt_v, h2c, pos), kw=kw, r=rpg,
                sc=dict(k_scale_pool=ksp, v_scale_pool=vsp):
                ck.paged_chai_fused_decode(*a, reps_per_group=r, **sc,
                                           **kw))
    # the relay kernel: groups of 4 and 3 members (slot 4 of group 1
    # padded), 25 reps of 32 heads, Sp 256
    g, nmax, r, h, hd, sp = 2, 4, 25, 32, 128, 256
    k_row = torch.zeros(g, nmax * r, dtype=torch.int32, device=dev)
    a_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
    v_row = torch.zeros(g, nmax * h, dtype=torch.int32, device=dev)
    for i, n_mem in enumerate((4, 3)):
        for j in range(n_mem):
            k_row[i, j * r:(j + 1) * r] = torch.randperm(
                h, generator=gen, device=dev)[:r]
            a_row[i, j * h:(j + 1) * h] = j * r + torch.randint(
                0, r - 1, (h,), generator=gen, device=dev)
            v_row[i, j * h:(j + 1) * h] = torch.arange(h, device=dev)
    plen = torch.tensor([200, 256], dtype=torch.int32, device=dev)
    q = torch.randn(g, nmax * r, hd, generator=gen, device=dev)
    k = torch.randn(g, h, sp, hd, generator=gen, device=dev)
    v = torch.randn(g, h, sp, hd, generator=gen, device=dev)
    kq, ksc = cache.quant_rows(k)
    vq, vsc = cache.quant_rows(v)
    maps = (k_row, a_row, v_row, plen)
    for mode, (kk, vv, sc) in {
            "bf16": (k.bfloat16(), v.bfloat16(), {}),
            "int8": (kq, vq, dict(k_scale=ksc, v_scale=vsc)),
            "int8_raw_v": (kq, cache.plain_int8(v * 40),
                           dict(k_scale=ksc))}.items():
        out[f"relay_{mode}"] = (
            "relay_prefix_decode",
            lambda a=(q, kk, vv, *maps), sc=sc: ck.relay_prefix_decode(
                *a, ts=PAGE, **sc))
    # the prefix pass: 3 rows of 128 queries, 32 heads, plen 0 / 200 / 384
    b, t, n_pages = 3, 128, 64
    n_pool = 2 * b * n_pages + 1
    ids = (torch.randperm(n_pool - 1, generator=gen, device=dev)
           + 1).to(torch.int32)
    bt_k = ids[:b * n_pages].reshape(b, n_pages)
    bt_v = ids[b * n_pages:].reshape(b, n_pages)
    plen = torch.tensor([0, 200, 384], dtype=torch.int32, device=dev)
    x = torch.randn(n_pool, h, PAGE, hd, generator=gen, device=dev)
    qp = torch.randn(b, t, h, hd, generator=gen, device=dev).bfloat16()
    pq, psc = cache.quant_rows(x)
    for mode, (pool, sc) in {
            "bf16": (x.bfloat16(), {}),
            "int8": (pq, dict(k_scale_pool=psc, v_scale_pool=psc))}.items():
        out[f"prefix_{mode}"] = (
            "paged_prefix_attend",
            lambda a=(qp, pool, bt_k, bt_v, plen), sc=sc:
            fk.paged_prefix_attend(*a, **sc))
    return out


def _digest(out):
    parts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in parts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def measure(tree, label, out_dir):
    """One tree, in this process: build (the first run of a tree with
    ptxas -v), then every case's digest and device time."""
    build = _ab.open_tree(tree)
    import torch
    from repro_torch.core import cache
    from repro_torch.kernels import chai_attention as ck
    from repro_torch.kernels import flash_attention as fk
    resources, seconds = ({}, {})
    if label.endswith("_1"):      # the tree's first run builds, verbose
        resources, seconds = _ab.build_verbose(build, SOURCES)
    rec = {"tree": str(tree), "label": label, "resources": resources,
           "build_seconds": seconds, "cases": {}}
    for name, (kernel, call) in _cases(torch, ck, fk, cache).items():
        got = call()
        torch.cuda.synchronize()
        rec["cases"][name] = dict(
            sha256=_digest(got), repeat_equal=_digest(call()) == _digest(
                got),
            device_ms=_ab.device_ms(torch, call, rf"\b{kernel}_kernel\b"))
        del got
        torch.cuda.empty_cache()
    return rec


def summarize(runs, out_dir):
    """Each case: its bits equal over the four runs, launch == launch,
    the median device time of each tree and their ratio."""
    summary = {}
    for name in runs[0]["cases"]:
        cases = [r["cases"][name] for r in runs]
        s = summary[name] = {
            "bitwise_equal_across_trees": len({c["sha256"]
                                               for c in cases}) == 1,
            "repeat_equal": all(c["repeat_equal"] for c in cases),
            **{f"{side}_device_ms": statistics.median(
                c["device_ms"] for r, c in zip(runs, cases)
                if r["label"].startswith(side) and c["device_ms"])
               for side in ("other", "this")}}
        s["this_over_other"] = s["this_device_ms"] / s["other_device_ms"]
    return summary


if __name__ == "__main__":
    _ab.ab_main(__file__, __doc__, measure, summarize)
