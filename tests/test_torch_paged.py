"""The port's paged KV layout and paged decode op against the JAX package.

On a reduced chai-llama-7b (2 layers, d=64, 8 heads, fp32, max_seq 64,
page 16) the same numpy-seeded inputs go through both packages:

* ``PagePool``: one sequence of allocations, frees, increfs and refused
  operations, with the same pages handed out and the same counters;
* the paged and unified state layouts (shapes and dtypes), and the slot
  transitions (``insert_slot_paged`` / ``compact_kv_slot_paged`` /
  ``reset_slot_paged`` and their unified counterparts), exactly: every
  page but the null page 0, where several null-padded rows of one scatter
  land and either package may keep any of them;
* ``paged_chai_fused_decode_ref`` (the port's CPU path) against the
  reference's Pallas ``paged_chai_fused_decode`` (interpret mode) on
  shuffled pages at atol = rtol = 1e-5, and bitwise against the port's
  dense op on the same K/V;
* the KV byte accounting.

The CUDA kernel itself is built and held against this plain version, and
bitwise against the dense kernel, on the card by ``chip_smoke.py``.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.kernels import ops as jops
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.kernels import build
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)
S, PAGE, B = 64, 16, 2
DENSE_PAGES, CHAI_PAGES = 9, 5


def _cfgs():
    return (jreduced(jget_config("chai-llama-7b"), n_layers=2),
            reduced(get_config("chai-llama-7b"), n_layers=2))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- PagePool -------
def _pool_ops():
    """(op, args) sequence: allocation, exhaustion, reuse of freed pages,
    shared pages (incref) freed at zero, and the guarded mistakes."""
    return [("alloc", 3), ("alloc", 2), ("free", "a0"), ("alloc", 2),
            ("incref", "a1"), ("free", "a1"), ("counters", None),
            ("free", "a1"), ("double_free", "a1"), ("incref_free", "a1"),
            ("free_null", None), ("alloc", 20), ("alloc", 7),
            ("free", "a2"), ("free", "a4"), ("counters", None)]


def _run_pool(pool, null):
    log, allocs = [], []
    for op, arg in _pool_ops():
        try:
            if op == "alloc":
                allocs.append(pool.alloc(arg))
                out = list(allocs[-1])
            elif op == "free":
                pool.free(allocs[int(arg[1:])])
                out = None
            elif op == "incref":
                pool.incref(allocs[int(arg[1:])])
                out = [pool.refcount(p) for p in allocs[int(arg[1:])]]
            elif op == "free_null":
                pool.free([null])
                out = None
            elif op == "double_free":
                pool.free(allocs[int(arg[1:])])
                out = None
            elif op == "incref_free":
                pool.incref(allocs[int(arg[1:])])
                out = None
            else:
                out = pool.counters()
        except (MemoryError, AssertionError) as err:
            allocs.append([]) if op == "alloc" else None
            out = type(err).__name__
        log.append((op, out, pool.free_pages, pool.pages_in_use,
                    pool.capacity))
    return log


def test_page_pool_matches_reference():
    tlog = _run_pool(tcache.PagePool(10, PAGE), tcache.NULL_PAGE)
    jlog = _run_pool(jcache.PagePool(10, PAGE), jcache.NULL_PAGE)
    assert tlog == jlog
    outs = [entry[1] for entry in tlog]
    assert "MemoryError" in outs and outs.count("AssertionError") == 3
    assert tlog[-1][3] == 0                  # everything returned
    assert tcache.pages_needed(17, 16) == jcache.pages_needed(17, 16) == 2


# ------------------------------------------------------- state layouts -----
@pytest.mark.parametrize("chai", [True, False])
def test_state_layouts_match_reference(chai):
    jcfg, tcfg = _cfgs()
    jshapes, _ = jcache.paged_state_structs(
        jcfg, B, S, page_size=PAGE, dense_pages=DENSE_PAGES,
        chai_pages=CHAI_PAGES, chai=chai)
    tshapes = tcache.paged_state_shapes(
        tcfg, B, S, page_size=PAGE, dense_pages=DENSE_PAGES,
        chai_pages=CHAI_PAGES, chai=chai)
    ushapes, _ = jcache.unified_state_structs(jcfg, B, S, chai=chai)
    tushapes = tcache.unified_state_shapes(tcfg, B, S, chai=chai)
    for want, got in ((jshapes, tshapes), (ushapes, tushapes)):
        assert set(got) == set(want)
        for k, (shape, dt) in got.items():
            assert shape == tuple(want[k].shape), k
            assert str(dt).replace("torch.", "") == str(want[k].dtype), k
    state = tcache.init_paged_state(
        tcfg, B, S, page_size=PAGE, dense_pages=DENSE_PAGES,
        chai_pages=CHAI_PAGES, chai=chai, device="cpu")
    assert (state["phase"] == tcache.PHASE_FREE).all()
    assert ("cp" in state) == chai and ("bt_kc" in state) == chai


def _random_state(rng, shapes):
    out = {}
    for k, (shape, dt) in shapes.items():
        if dt == torch.int32:
            hi = DENSE_PAGES if k.startswith("bt_") else 5
            out[k] = rng.integers(0, hi, size=shape).astype(np.int32)
        else:
            out[k] = rng.normal(size=shape).astype(np.float32)
    return out


def _assert_states_equal(tstate, jstate, skip_null=()):
    assert set(tstate) == set(jstate)
    for k, v in tstate.items():
        got, want = v.numpy(), np.asarray(jstate[k])
        if k in skip_null:     # pools: page 0 is the null sink
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_paged_slot_transitions_match_reference(rng):
    jcfg, tcfg = _cfgs()
    shapes = tcache.paged_state_shapes(
        tcfg, B, S, page_size=PAGE, dense_pages=DENSE_PAGES,
        chai_pages=CHAI_PAGES)
    base = _random_state(rng, shapes)
    mini = _random_state(rng, {k: v for k, v in
                               tcache.unified_state_shapes(
                                   tcfg, 1, S, chai=False).items()
                               if k in ("pos", "kg", "vg")})
    kg_pages = np.array([7, 2, 0, 0], np.int32)       # 2 pages, null-padded
    vg_pages = np.array([5, 8, 0, 0], np.int32)
    kc_pages = np.array([3, 1, 0, 0], np.int32)
    reps = rng.permutation(tcfg.n_heads)[:tcfg.k_max]
    slot_ctx = {"reps": np.stack([reps, np.roll(reps, 1)]).astype(np.int32)}
    slot = 1

    jst = {k: jnp.asarray(v) for k, v in base.items()}
    tst = {k: _t(v) for k, v in base.items()}
    jst = jcache.insert_slot_paged(jst, {k: jnp.asarray(v)
                                         for k, v in mini.items()}, slot,
                                   jnp.asarray(kg_pages),
                                   jnp.asarray(vg_pages))
    tst = tcache.insert_slot_paged(tst, {k: _t(v) for k, v in mini.items()},
                                   slot, _t(kg_pages), _t(vg_pages))
    _assert_states_equal(tst, jst, skip_null=("kvp",))
    assert tst["phase"][slot] == tcache.PHASE_WARMUP
    assert not tst["chai_scores"][:, slot].any()

    jst = jcache.compact_kv_slot_paged(
        jst, {k: jnp.asarray(v) for k, v in slot_ctx.items()}, jcfg, slot,
        jnp.asarray(kc_pages))
    tst = tcache.compact_kv_slot_paged(
        tst, {k: _t(v) for k, v in slot_ctx.items()}, tcfg, slot,
        _t(kc_pages))
    _assert_states_equal(tst, jst, skip_null=("kvp", "cp"))
    assert not tst["bt_kg"][slot].any()
    assert tst["phase"][slot] == tcache.PHASE_STEADY

    jst = jcache.reset_slot_paged(jst, slot)
    tst = tcache.reset_slot_paged(tst, slot)
    _assert_states_equal(tst, jst, skip_null=("kvp", "cp"))
    assert tst["pos"][slot] == 0 and tst["phase"][slot] == tcache.PHASE_FREE


def test_unified_slot_transitions_match_reference(rng):
    jcfg, tcfg = _cfgs()
    base = _random_state(rng, tcache.unified_state_shapes(tcfg, B, S))
    mini = _random_state(rng, tcache.unified_state_shapes(
        tcfg, 1, S, chai=False))
    mini.pop("phase")
    reps = rng.permutation(tcfg.n_heads)[:tcfg.k_max]
    slot_ctx = {"reps": np.stack([reps, reps[::-1]]).astype(np.int32)}
    jst = {k: jnp.asarray(v) for k, v in base.items()}
    tst = {k: _t(v) for k, v in base.items()}
    jst = jcache.insert_slot(jst, {k: jnp.asarray(v)
                                   for k, v in mini.items()}, 0)
    tst = tcache.insert_slot(tst, {k: _t(v) for k, v in mini.items()}, 0)
    _assert_states_equal(tst, jst)
    jst = jcache.compact_kv_slot(
        jst, {k: jnp.asarray(v) for k, v in slot_ctx.items()}, jcfg, 0)
    tst = tcache.compact_kv_slot(
        tst, {k: _t(v) for k, v in slot_ctx.items()}, tcfg, 0)
    _assert_states_equal(tst, jst)
    _assert_states_equal(tcache.reset_slot(tst, 0),
                         jcache.reset_slot(jst, 0))


# ------------------------------------------------------- paged decode ------
def _paged_case(rng, *, b=3, r=5, h=8, kv_k=None, kv_v=None, rpg=1, hd=16,
                n_pages=4, pos=(5, 40, 63), warmup_row=None):
    """Dense K/V scattered into shuffled pool pages, the rest of each pool
    random. Returns (q, k_dense, v_dense, k_pool, bt_k, v_pool, bt_v,
    h2c, pos) as numpy arrays."""
    kv_k = kv_k or r
    kv_v = kv_v or h
    s = n_pages * PAGE
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv_k, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv_v, s, hd)).astype(np.float32)
    if rpg == 1:   # one rep without members
        h2c = rng.choice([j for j in range(r) if j != 1], size=(b, h))
    else:
        qpk = h // kv_k
        h2c = (np.arange(h) // qpk)[None, :] * rpg + rng.integers(
            0, rpg, size=(b, h))

    def scatter(x, n_pool):
        pool = rng.normal(size=(n_pool,) + x.shape[1:2] + (PAGE, hd))
        pool = pool.astype(np.float32)
        ids = rng.permutation(np.arange(1, n_pool))[:b * n_pages]
        bt = ids.reshape(b, n_pages).astype(np.int32)
        for i in range(b):
            for t in range(n_pages):
                pool[bt[i, t]] = x[i, :, t * PAGE:(t + 1) * PAGE]
        return pool, bt

    k_pool, bt_k = scatter(k, b * n_pages + 3)
    v_pool, bt_v = scatter(v, b * n_pages + 5)
    if warmup_row is not None:
        # A WARMUP slot inside a mixed step: its clustered K table is all
        # null page 0 and its membership all zeros (rep 0 owns every head).
        bt_k[warmup_row] = 0
        h2c[warmup_row] = 0
        k[warmup_row] = np.concatenate([k_pool[0, :]] * n_pages, axis=1)
    return (q, k, v, k_pool, bt_k, v_pool, bt_v, h2c.astype(np.int32),
            np.asarray(pos, np.int32))


CASES = {
    "mha": dict(),
    "mha_warmup_row": dict(warmup_row=1),
    "gqa_rpg2": dict(r=8, h=8, kv_k=4, kv_v=4, rpg=2, pos=(17, 63, 0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_plain_matches_reference_kernel(rng, name):
    kw = CASES[name]
    rpg = kw.get("rpg", 1)
    q, _, _, k_pool, bt_k, v_pool, bt_v, h2c, pos = _paged_case(rng, **kw)
    args = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
    j_out = jops.paged_chai_decode_attention(
        *(jnp.asarray(a) for a in args), reps_per_group=rpg)
    before = dict(tck.LAUNCHES)
    t_out = tops.paged_chai_decode_attention(*(_t(a) for a in args),
                                             reps_per_group=rpg)
    assert tck.LAUNCHES == before         # the CPU path launches nothing
    assert t_out.dtype == torch.float32 and t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_op_bitwise_equals_dense_op(rng, name):
    """Same K/V, dense rectangle vs shuffled pages: identical bits."""
    kw = CASES[name]
    rpg = kw.get("rpg", 1)
    q, k, v, k_pool, bt_k, v_pool, bt_v, h2c, pos = _paged_case(rng, **kw)
    paged = tops.paged_chai_decode_attention(
        *(_t(a) for a in (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)),
        reps_per_group=rpg)
    dense = tops.chai_decode_attention(
        *(_t(a) for a in (q, k, v, h2c, pos)), reps_per_group=rpg, ts=PAGE)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("flag", [
    dict(softcap=30.0), dict(emit_state=True), dict(share_values=True),
    dict(k_scale_pool="scale"), dict(v_scale_pool="scale")])
def test_paged_kernel_path_refuses_unported_flags(flag):
    """A non-CPU tensor goes to the kernel, which raises on what it does
    not carry — never to the plain version."""
    meta = dict(device="meta")
    args = (torch.empty(2, 5, 16, **meta),
            torch.empty(9, 5, PAGE, 16, **meta),
            torch.empty(2, 4, dtype=torch.int32, **meta),
            torch.empty(9, 8, PAGE, 16, **meta),
            torch.empty(2, 4, dtype=torch.int32, **meta),
            torch.empty(2, 8, dtype=torch.int32, **meta),
            torch.empty(2, dtype=torch.int32, **meta))
    flag = {n: (torch.empty(9, 5, PAGE, **meta) if v == "scale" else v)
            for n, v in flag.items()}
    before = dict(tck.LAUNCHES)
    with pytest.raises(NotImplementedError):
        tops.paged_chai_decode_attention(*args, **flag)
    with pytest.raises(ValueError, match="CUDA"):
        tops.paged_chai_decode_attention(*args)
    assert tck.LAUNCHES == before


# ------------------------------------------------------- KV accounting -----
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_kv_bytes_match_reference(size):
    jcfg, tcfg = _cfgs()
    if size == "full":
        jcfg, tcfg = jget_config("chai-llama-7b"), get_config("chai-llama-7b")
    for kind in ("dense", "chai"):
        assert tcache.paged_page_bytes(tcfg, PAGE, kind=kind) == \
            jcache.paged_page_bytes(jcfg, PAGE, kind=kind)
    for dense_in_use, chai_in_use in ((0, 0), (7, 0), (3, 5), (513, 257)):
        assert tcache.paged_kv_bytes(tcfg, PAGE, dense_in_use,
                                     chai_in_use) == \
            jcache.paged_kv_bytes(jcfg, PAGE, dense_in_use, chai_in_use)
    for chai in (True, False):
        assert tcache.unified_kv_bytes(tcfg, 4, 1024, chai=chai) == \
            jcache.unified_kv_bytes(jcfg, 4, 1024, chai=chai)
    if size == "full":   # 32 layers x 32 rows x 16 x 128 x 2 B (bf16)
        assert tcache.paged_page_bytes(tcfg, PAGE, kind="dense") == \
            32 * 131072


def test_build_treats_a_newer_header_as_stale(monkeypatch, tmp_path):
    """Editing the shared tile header rebuilds both kernels."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    src, lib, hdr = (csrc / "k.cu", out / "libk.so",
                     csrc / "chai_decode_tiles.cuh")
    for path, t in ((src, 100), (hdr, 100), (lib, 200)):
        path.write_text("")
        os.utime(path, (t, t))
    assert not build._stale("k")
    os.utime(hdr, (300, 300))
    assert build._stale("k")
    os.utime(lib, (400, 400))
    assert not build._stale("k")
    assert build.KERNELS == ("chai_fused_decode", "paged_chai_fused_decode",
                             "flash_prefill", "paged_prefix_attend")
