"""The port's int8 KV modes against the JAX package's, kernel and cache
level, on the CPU.

Kernel level: the plain versions of the four int8 modes (``kernels.ref``)
against the reference's Pallas kernels in interpret mode, on int8 codes
and fp32 row scales from the reference's ``quant_rows`` (the same numpy
inputs on both sides, fp32, hd 16):

* ``chai_fused_decode`` (MHA: a clustered K row per rep; GQA: reps per
  K group and a V row per group), finalized and in the state mode;
* ``paged_chai_fused_decode`` over shuffled pages with the null page 0 in
  the tables past ``pos``, and bitwise equal to the dense op;
* ``relay_prefix_decode`` with a padded member slot and ragged plen;
* ``paged_prefix_attend`` with a row at plen 0 (the exact merge identity).

Tolerance atol = rtol = 1e-5 (fp32): the plain versions dequantize K and
V before the products, as the reference's oracles do; the Pallas kernels
scale the score after the dot and V before A.V, so the two orders differ
in the last bits.

Cache level: the int8 state shapes and dtypes of every layout against
the reference's structs; ``compact_kv``, ``compact_kv_slot`` and
``compact_kv_slot_paged`` bitwise against the reference (codes and
scales); the insert and page-copy steps carrying scales; the KV-bytes
accounting equal to the reference's (1 + 4 / hd bytes an element; a bf16
model at hd 128 pays 132 / 256 of its page bytes). The wrappers take K
and V each with or without its scales, as the Pallas wrappers do (a scale
of the wrong shape is refused); ``share_values`` with int8 has the
reference's state shapes (``test_share_values_with_int8_still_raises``,
the name it had while the flag was refused).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.kernels import chai_attention as jck
from repro.kernels import flash_attention as jfk
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttfm

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _quant(rng, shape):
    """int8 codes and fp32 row scales of normal rows, by the reference's
    ``quant_rows``."""
    q, s = jcache.quant_rows(jnp.asarray(rng.normal(size=shape), jnp.float32))
    return np.array(q), np.array(s)


def _assert_close(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ the fused pair ----
CASES = {"mha": dict(rpg=1, kv_k=5, kv_v=8, h=8),
         "gqa": dict(rpg=3, kv_k=2, kv_v=2, h=8)}


def _dense_case(rng, *, rpg, kv_k, kv_v, h, b=2, s=64, hd=16):
    r = kv_k * rpg
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k, ks = _quant(rng, (b, kv_k, s, hd))
    v, vs = _quant(rng, (b, kv_v, s, hd))
    # MHA: any rep; GQA: a rep of the head's own K group (= its V row)
    if rpg == 1:
        h2c = rng.integers(0, r, size=(b, h))
    else:
        h2c = ((np.arange(h) // (h // kv_v))[None] * rpg
               + rng.integers(0, rpg, size=(b, h)))
    h2c = h2c.astype(np.int32)
    pos = np.array([s - 1, 23], np.int32)
    return q, k, ks, v, vs, h2c, pos


@pytest.mark.parametrize("emit", [False, True], ids=["final", "state"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_decode_int8_plain_matches_pallas(rng, name, emit):
    c = CASES[name]
    q, k, ks, v, vs, h2c, pos = _dense_case(rng, **c)
    want = jck.chai_fused_decode(
        _j(q), _j(k), _j(v), _j(h2c), _j(pos), k_scale=_j(ks), v_scale=_j(vs),
        reps_per_group=c["rpg"], ts=PAGE, emit_state=emit)
    before = dict(tck.LAUNCHES)
    got = tops.chai_decode_attention(
        _t(q), _t(k), _t(v), _t(h2c), _t(pos), k_scale=_t(ks),
        v_scale=_t(vs), reps_per_group=c["rpg"], ts=PAGE, emit_state=emit)
    assert tck.LAUNCHES == before          # the CPU path launches nothing
    _assert_close(got, want)


def _paged_case(rng, *, rpg, kv_k, kv_v, h, b=2, n_pages=4, hd=16):
    """Dense int8 caches and the same rows in shuffled pool pages (K and V
    pools of their own), the tables' entries past pos naming page 0."""
    s = n_pages * PAGE
    q, k, ks, v, vs, h2c, pos = _dense_case(rng, rpg=rpg, kv_k=kv_k,
                                            kv_v=kv_v, h=h, b=b, s=s, hd=hd)
    n_pool = b * n_pages + 3

    def pool_of(x, sc):
        rows = x.shape[1]
        perm = rng.permutation(np.arange(1, n_pool))[:b * n_pages]
        bt = perm.reshape(b, n_pages).astype(np.int32)
        pool = np.zeros((n_pool, rows, PAGE, hd), np.int8)
        spool = np.zeros((n_pool, rows, PAGE), np.float32)
        pool[0] = 77                        # the null page: never valid
        spool[0] = 1e3
        for i in range(b):
            for p in range(n_pages):
                pool[bt[i, p]] = x[i, :, p * PAGE:(p + 1) * PAGE]
                spool[bt[i, p]] = sc[i, :, p * PAGE:(p + 1) * PAGE]
        for i in range(b):                  # pages past pos -> null page
            bt[i, pos[i] // PAGE + 1:] = 0
        return pool, spool, bt

    kp, ksp, bt_k = pool_of(k, ks)
    vp, vsp, bt_v = pool_of(v, vs)
    return (q, k, ks, v, vs, h2c, pos), (q, kp, bt_k, vp, bt_v, h2c, pos,
                                         ksp, vsp)


@pytest.mark.parametrize("emit", [False, True], ids=["final", "state"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_fused_decode_int8_plain_matches_pallas(rng, name, emit):
    c = CASES[name]
    dense, paged = _paged_case(rng, **c)
    q, kp, bt_k, vp, bt_v, h2c, pos, ksp, vsp = paged
    want = jck.paged_chai_fused_decode(
        *(_j(a) for a in (q, kp, bt_k, vp, bt_v, h2c, pos)),
        k_scale_pool=_j(ksp), v_scale_pool=_j(vsp), reps_per_group=c["rpg"],
        emit_state=emit)
    got = tops.paged_chai_decode_attention(
        *(_t(a) for a in (q, kp, bt_k, vp, bt_v, h2c, pos)),
        k_scale_pool=_t(ksp), v_scale_pool=_t(vsp), reps_per_group=c["rpg"],
        emit_state=emit)
    _assert_close(got, want)
    # dense == paged bitwise inside the port (page == tile)
    q, k, ks, v, vs, h2c, pos = dense
    ref_dense = tops.chai_decode_attention(
        _t(q), _t(k), _t(v), _t(h2c), _t(pos), k_scale=_t(ks),
        v_scale=_t(vs), reps_per_group=c["rpg"], ts=PAGE, emit_state=emit)
    for g, w in zip(got if emit else (got,), ref_dense if emit
                    else (ref_dense,)):
        assert torch.equal(g, w)


# ------------------------------------------------------ relay kernel ------
def test_relay_int8_plain_matches_pallas(rng):
    """Two groups, MHA rows (K row per rep, V row per head), the second
    group with a padded member (index 0 in every map) and a shorter
    plen."""
    g, nmax, r, h, hd, sp = 2, 3, 3, 8, 16, 64
    nr, a = nmax * r, nmax * h
    q = rng.normal(size=(g, nr, hd)).astype(np.float32)
    k, ks = _quant(rng, (g, h, sp, hd))
    v, vs = _quant(rng, (g, h, sp, hd))
    k_row = rng.integers(0, h, size=(g, nr)).astype(np.int32)
    a_row = (np.repeat(np.arange(nmax) * r, h)[None]
             + rng.integers(0, r, size=(g, a))).astype(np.int32)
    v_row = np.tile(np.arange(h), (g, nmax)).astype(np.int32)
    for m in (k_row, a_row, v_row):         # group 1: member 2 is padding
        m[1, -(m.shape[1] // nmax):] = 0
    plen = np.array([48, 20], np.int32)
    args = (q, k, v, k_row, a_row, v_row, plen)
    want = jck.relay_prefix_decode(*(_j(x) for x in args), k_scale=_j(ks),
                                   v_scale=_j(vs), ts=PAGE)
    got = tops.relay_prefix_attention(*(_t(x) for x in args),
                                      k_scale=_t(ks), v_scale=_t(vs),
                                      ts=PAGE)
    _assert_close(got, want)


# ------------------------------------------------- paged prefix attend ----
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_paged_prefix_attend_int8_plain_matches_pallas(rng, kv):
    """Row 0 at plen 0 (the exact merge identity), row 1 over 40 cached
    positions of shuffled pages; the null page poisoned."""
    b, t, h, hd, n_pages = 2, 16, 4, 16, 4
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    n_pool = 2 * b * n_pages + 1
    pool, spool = _quant(rng, (n_pool, kv, PAGE, hd))
    pool[0] = 99
    spool[0] = 1e3
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    bt_k = perm[:b * n_pages].reshape(b, n_pages)
    bt_v = perm[b * n_pages:2 * b * n_pages].reshape(b, n_pages)
    plen = np.array([0, 40], np.int32)
    bt_k[1, 3:] = bt_v[1, 3:] = 0           # past the prefix: null page
    args = (q, pool, bt_k, bt_v, plen)
    want = jfk.paged_prefix_attend(*(_j(x) for x in args),
                                   k_scale_pool=_j(spool),
                                   v_scale_pool=_j(spool))
    got = tops.paged_prefix_attention(*(_t(x) for x in args),
                                      k_scale_pool=_t(spool),
                                      v_scale_pool=_t(spool))
    _assert_close(got, want)
    m, l, acc = got
    assert torch.equal(m[0], torch.full_like(m[0], tref.NEG_INF))
    assert not l[0].any() and not acc[0].any()


# ------------------------------------------------------ wrapper checks ----
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kw", [
    dict(k_dt=torch.int8, v_dt=torch.int8),                  # no scales
    dict(k_dt=torch.int8, v_dt=torch.int8, ks=True),         # one scale
    dict(k_dt=torch.int8, v_dt=torch.bfloat16, ks=True, vs=True),
    dict(k_dt=torch.bfloat16, v_dt=torch.bfloat16, ks=True, vs=True),
    dict(k_dt=torch.int8, v_dt=torch.int8, ks=True, vs=True, bad=True),
], ids=["no_scales", "one_scale", "mixed_dtype", "float_scaled",
        "scale_shape"])
def test_int8_wrappers_refuse_unpaired_scales(kw):
    """K and V are each read on their own, as the Pallas bodies read them:
    int8 without scales, with one side's scale, int8 K beside bf16 V and
    scales beside bf16 rows all pass the wrappers' checks and reach the
    device check (``meta`` tensors: nothing launches); a scale whose shape
    is not its side's without the last axis is still refused before it."""
    k = _meta(2, 5, 64, 16, dtype=kw["k_dt"])
    v = _meta(2, 8, 64, 16, dtype=kw["v_dt"])
    ks = _meta(2, 5, 64) if kw.get("ks") else None
    vs = (_meta(2, 8, 32) if kw.get("bad") else _meta(2, 8, 64)
          ) if kw.get("vs") else None
    args = (_meta(2, 5, 16), k, v, _meta(2, 8, dtype=torch.int32),
            _meta(2, dtype=torch.int32))
    before = dict(tck.LAUNCHES)
    match = "scale" if kw.get("bad") else "CUDA"
    with pytest.raises(ValueError, match=match):
        tck.chai_fused_decode(*args, k_scale=ks, v_scale=vs)
    with pytest.raises(ValueError, match=match):
        tck.relay_prefix_decode(
            _meta(2, 5, 16), k, v, _meta(2, 5, dtype=torch.int32),
            _meta(2, 8, dtype=torch.int32), _meta(2, 8, dtype=torch.int32),
            _meta(2, dtype=torch.int32), k_scale=ks, v_scale=vs)
    assert tck.LAUNCHES == before


def test_int8_modes_reach_the_device_check():
    """With their scales, the int8 modes of all four kernels pass every
    refusal and reach the CUDA check (meta tensors: no launch)."""
    i8 = torch.int8
    before = (dict(tck.LAUNCHES), dict(tfk.LAUNCHES))
    with pytest.raises(ValueError, match="CUDA"):
        tck.chai_fused_decode(
            _meta(2, 5, 16), _meta(2, 5, 64, 16, dtype=i8),
            _meta(2, 8, 64, 16, dtype=i8), _meta(2, 8, dtype=torch.int32),
            _meta(2, dtype=torch.int32), k_scale=_meta(2, 5, 64),
            v_scale=_meta(2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tck.paged_chai_fused_decode(
            _meta(2, 5, 16), _meta(9, 5, PAGE, 16, dtype=i8),
            _meta(2, 4, dtype=torch.int32), _meta(9, 8, PAGE, 16, dtype=i8),
            _meta(2, 4, dtype=torch.int32), _meta(2, 8, dtype=torch.int32),
            _meta(2, dtype=torch.int32), k_scale_pool=_meta(9, 5, PAGE),
            v_scale_pool=_meta(9, 8, PAGE), emit_state=True)
    with pytest.raises(ValueError, match="CUDA"):
        tck.relay_prefix_decode(
            _meta(2, 6, 16), _meta(2, 4, 64, 16, dtype=i8),
            _meta(2, 4, 64, 16, dtype=i8), _meta(2, 6, dtype=torch.int32),
            _meta(2, 8, dtype=torch.int32), _meta(2, 8, dtype=torch.int32),
            _meta(2, dtype=torch.int32), k_scale=_meta(2, 4, 64),
            v_scale=_meta(2, 4, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfk.paged_prefix_attend(
            _meta(1, 8, 4, 16), _meta(5, 2, PAGE, 16, dtype=i8),
            _meta(1, 2, dtype=torch.int32), _meta(1, 2, dtype=torch.int32),
            _meta(1, dtype=torch.int32), k_scale_pool=_meta(5, 2, PAGE),
            v_scale_pool=_meta(5, 2, PAGE))
    # an int8 pool without scales reads its codes as values (the Pallas
    # kernel's cast), and a scale pool of the wrong shape is refused
    with pytest.raises(ValueError, match="CUDA"):
        tfk.paged_prefix_attend(
            _meta(1, 8, 4, 16), _meta(5, 2, PAGE, 16, dtype=i8),
            _meta(1, 2, dtype=torch.int32), _meta(1, 2, dtype=torch.int32),
            _meta(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="scale"):
        tfk.paged_prefix_attend(
            _meta(1, 8, 4, 16), _meta(5, 2, PAGE, 16, dtype=i8),
            _meta(1, 2, dtype=torch.int32), _meta(1, 2, dtype=torch.int32),
            _meta(1, dtype=torch.int32), v_scale_pool=_meta(5, 2, 8))
    assert (dict(tck.LAUNCHES), dict(tfk.LAUNCHES)) == before


# ------------------------------------------------------ cache level -------
ARCHS = ("chai-llama-7b", "nemotron-4-15b")


def _cfgs(arch, **kw):
    jcfg = jreduced(jget_config(arch), n_layers=2, **kw).replace(
        kv_cache_dtype="int8")
    tcfg = reduced(get_config(arch), n_layers=2, **kw).replace(
        kv_cache_dtype="int8")
    return jcfg, tcfg


def _shapes_of_structs(structs):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}


def _shapes_of_table(table):
    return {k: (tuple(shape), str(dt).replace("torch.", ""))
            for k, (shape, dt) in table.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_state_shapes_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    b, s = 3, 64
    want = _shapes_of_structs(jtfm.decode_state_structs(jcfg, b, s)[0])
    assert _shapes_of_table(ttfm.decode_state_shapes(tcfg, b, s)) == want
    assert want["kg"][1] == "int8" and want["kg_scale"][1] == "float32"
    want = _shapes_of_structs(jcache.unified_state_structs(jcfg, b, s)[0])
    assert _shapes_of_table(tcache.unified_state_shapes(tcfg, b, s)) == want
    kw = dict(page_size=PAGE, dense_pages=9, chai_pages=5)
    want = _shapes_of_structs(jcache.paged_state_structs(jcfg, b, s,
                                                         **kw)[0])
    assert _shapes_of_table(tcache.paged_state_shapes(tcfg, b, s,
                                                      **kw)) == want
    assert "kvp_scale" in want
    assert ("cp_scale" in want) == tcfg.is_mha
    want = _shapes_of_structs(jcache.chai_state_structs(jcfg, b, s)[0])
    got = tcache.init_chai_state(tcfg, b, s, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want


def _random_state(rng, shapes):
    out = {}
    for k, (shape, dt) in shapes.items():
        if dt == torch.int8:
            out[k] = rng.integers(-127, 128, size=shape).astype(np.int8)
        elif dt == torch.int32:
            out[k] = np.zeros(shape, np.int32)
        else:
            out[k] = rng.normal(size=shape).astype(np.float32)
    return out


def test_compact_kv_int8_bitwise_matches_reference(rng):
    """Cohort ``compact_kv`` and unified ``compact_kv_slot``: codes and
    scales gathered, nothing requantized, bitwise the reference's."""
    jcfg, tcfg = _cfgs("chai-llama-7b")
    b, s = 3, 32
    k_max = tcfg.k_max
    reps = rng.integers(0, tcfg.n_heads, size=(tcfg.n_attn_layers, b, k_max)
                        ).astype(np.int32)
    dense = _random_state(rng, ttfm.decode_state_shapes(tcfg, b, s))
    jout = jcache.compact_kv({k: _j(v) for k, v in dense.items()},
                             {"reps": _j(reps)}, jcfg)
    tout = tcache.compact_kv({k: _t(v) for k, v in dense.items()},
                             {"reps": _t(reps)}, tcfg)
    assert sorted(tout) == sorted(jout)
    assert "kg_chai_scale" in tout and "kg_scale" not in tout
    for key in jout:
        np.testing.assert_array_equal(tout[key].numpy(), np.asarray(jout[key]))

    shapes = tcache.unified_state_shapes(tcfg, b, s)
    uni = _random_state(rng, shapes)
    jst = {k: _j(v) for k, v in uni.items()}
    tst = {k: _t(v) for k, v in uni.items()}
    for i in range(b):
        jst = jcache.compact_kv_slot(jst, {"reps": _j(reps[:, i])}, jcfg, i)
        tst = tcache.compact_kv_slot(tst, {"reps": _t(reps[:, i])}, tcfg, i)
    for key in ("kg_chai", "kg_chai_scale", "phase"):
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]))


def test_paged_insert_compact_copy_int8_bitwise_match_reference(rng):
    """Paged ``insert_slot_paged`` scatters codes and scales into the
    slot's pages, ``compact_kv_slot_paged`` gathers the rep rows' codes
    and scales into clustered pages, and ``copy_pool_page`` copies a page
    of both pools, all bitwise the reference's."""
    jcfg, tcfg = _cfgs("chai-llama-7b")
    b, s = 2, 64
    kw = dict(page_size=PAGE, dense_pages=11, chai_pages=6)
    base = _random_state(rng, tcache.paged_state_shapes(tcfg, b, s, **kw))
    jst = {k: _j(v) for k, v in base.items()}
    tst = {k: _t(v) for k, v in base.items()}
    mini = _random_state(rng, ttfm.decode_state_shapes(tcfg, 1, s))
    mini["pos"][:] = 37
    kg_pages = np.array([3, 7, 1, 0], np.int32)
    vg_pages = np.array([9, 2, 5, 0], np.int32)
    jst = jcache.insert_slot_paged(jst, {k: _j(v) for k, v in mini.items()},
                                   1, _j(kg_pages), _j(vg_pages))
    tst = tcache.insert_slot_paged(tst, {k: _t(v) for k, v in mini.items()},
                                   1, _t(kg_pages), _t(vg_pages))
    reps = rng.integers(0, tcfg.n_heads, size=(tcfg.n_attn_layers,
                                               tcfg.k_max)).astype(np.int32)
    kc_pages = np.array([4, 2, 5, 0], np.int32)
    jst = jcache.compact_kv_slot_paged(jst, {"reps": _j(reps)}, jcfg, 1,
                                       _j(kc_pages))
    tst = tcache.compact_kv_slot_paged(tst, {"reps": _t(reps)}, tcfg, 1,
                                       _t(kc_pages))
    for kind, src, dst in (("dense", 9, 10), ("chai", 4, 1)):
        jst = jcache.copy_pool_page(jst, jnp.int32(src), jnp.int32(dst),
                                    kind=kind)
        tst = tcache.copy_pool_page(tst, src, dst, kind=kind)
    assert sorted(tst) == sorted(jst)
    for key in jst:            # page 0 takes colliding null writes: skip it
        t, j = tst[key].numpy(), np.asarray(jst[key])
        if key in ("kvp", "kvp_scale", "cp", "cp_scale"):
            t, j = t[:, 1:], j[:, 1:]
        np.testing.assert_array_equal(t, j, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_kv_bytes_match_reference(arch):
    """Every KV-bytes figure equals the reference's; at the full configs'
    hd 128 a bf16 model's int8 page costs (hd + 4) / (2 hd) = 132 / 256
    of its bf16 page, dense and clustered."""
    for red in (True, False):
        jcfg = jget_config(arch)
        tcfg = get_config(arch)
        if red:
            jcfg, tcfg = jreduced(jcfg, n_layers=2), reduced(tcfg, n_layers=2)
        j8, t8 = (c.replace(kv_cache_dtype="int8") for c in (jcfg, tcfg))
        for chai in (False, True):
            assert tcache.kv_cache_bytes(t8, 3, 640, chai=chai) == \
                jcache.kv_cache_bytes(j8, 3, 640, chai=chai)
        if red:      # the unified layout's structs are small only here
            assert tcache.unified_kv_bytes(t8, 2, 64) == \
                jcache.unified_kv_bytes(j8, 2, 64)
        kinds = ("dense", "chai") if tcfg.is_mha else ("dense",)
        for kind in kinds:
            t_pb = tcache.paged_page_bytes(t8, PAGE, kind=kind)
            assert t_pb == jcache.paged_page_bytes(j8, PAGE, kind=kind)
            if not red:
                bf = tcache.paged_page_bytes(tcfg, PAGE, kind=kind)
                assert tcfg.head_dim == 128 and tcfg.dtype == "bfloat16"
                assert t_pb * 256 == bf * 132
        assert tcache.paged_kv_bytes(t8, PAGE, 5, 3 if tcfg.is_mha else 0) \
            == jcache.paged_kv_bytes(j8, PAGE, 5, 3 if tcfg.is_mha else 0)


def test_share_values_with_int8_still_raises():
    """``share_values`` under int8 is ported: its state shapes on every
    layout equal the reference's (the clustered V ``vg_chai`` in int8
    codes with no scale tensor of its own; ``bt_vc`` on the paged
    layout)."""
    jcfg, tcfg = _cfgs("chai-llama-7b")
    jcfg = jcfg.with_chai(share_values=True)
    tcfg = tcfg.with_chai(share_values=True)
    b, s = 2, 64
    want = _shapes_of_structs(jcache.unified_state_structs(jcfg, b, s)[0])
    assert _shapes_of_table(tcache.unified_state_shapes(tcfg, b, s)) == want
    assert want["vg_chai"][1] == "int8" and "vg_chai_scale" not in want
    kw = dict(page_size=PAGE, dense_pages=5, chai_pages=3)
    want = _shapes_of_structs(jcache.paged_state_structs(jcfg, b, s,
                                                         **kw)[0])
    assert _shapes_of_table(tcache.paged_state_shapes(tcfg, b, s,
                                                      **kw)) == want
    assert "bt_vc" in want
    want = _shapes_of_structs(jcache.chai_state_structs(jcfg, b, s)[0])
    got = tcache.init_chai_state(tcfg, b, s, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want


def test_quant_rows_bitwise_matches_reference(rng):
    x = (rng.normal(size=(3, 5, 16)) * rng.uniform(1e-3, 1e2, size=(3, 5, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                              # an all-zero row
    jq, js = jcache.quant_rows(_j(x))
    tq, ts = tcache.quant_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcache.dequant_rows(tq, ts).numpy(),
        np.asarray(jcache.dequant_rows(jq, js)))
