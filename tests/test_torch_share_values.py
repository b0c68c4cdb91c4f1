"""The port's ``share_values`` (CHAI-QKV, the paper's Table 4 ablation)
against the JAX package's, on the CPU.

``share_values`` clusters V like K: one V row per rep (KVv == R), the
fused decode accumulates per rep and broadcasts to the member heads after
the division. Under int8 the clustered V rows are written by a plain
cast and read without scales, as the reference does.

* Kernels: the plain versions of the fused pair's share mode (dense and
  paged; fp32, and int8 K with scales beside raw V codes; finalized and
  in the state mode) and of the relay pass on the share shape (A = Nmax
  R acc rows, acc row j R + i reading query row j R + i and V row
  reps[i]; fp32 and int8 without V scales) against the Pallas kernels in
  interpret mode at atol = rtol = 1e-5; ``merge_decode_states`` /
  ``finalize_decode_state`` with ``share_values`` bitwise against the
  reference's; the wrappers' share checks on ``meta`` tensors.
* Cache: the state shapes, ``compact_kv``, ``compact_kv_slot``,
  ``compact_kv_slot_paged`` and the three byte counts over the {share} x
  {int8} grid of ``tests/test_cache_slots.py``, equal to the reference's;
  the plain int8 cast (``plain_int8``) bitwise against the reference's
  ``astype`` on out-of-range values and NaN.
* The share layer decode (dense and paged, fp32 and int8) against
  ``repro.core.chai_attention`` at 1e-5, the written cache rows too.
* Engines: reduced chai-llama-7b through the cohort engine and the
  continuous engine (paged, dense against the reference's paged run, and
  chunked), with and without int8, in lockstep with the reference's (its
  token each step, its membership each CLUSTER, logits of live rows at
  1e-4, the page accounting step by step: dense V pages freed at
  CLUSTER); the prefix cache with relay decode off and on, fp32 and
  int8, in lockstep as ``tests/test_torch_prefix_cache.py`` holds it
  (pools, tables incl. ``bt_vc``, refcounts, relay dicts); GQA with the
  flag raises.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import chai_attention as jchai
from repro.kernels import chai_attention as jck
from repro.kernels import ops as jops
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import chai_attention as tchai
from repro_torch.core import clustering as tclust
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
FEATURE_TOL = dict(atol=2e-3, rtol=0)
MARGIN = 1e-3
PAGE = 16
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages", "n_warmup",
                "n_steady")


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _quant(rng, shape):
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
def _share_case(rng, int8, *, b=2, r=5, h=8, s=64, hd=16):
    """A dense share-mode problem: K and V (B, R, S, hd), rep 3 without a
    member head in row 1 (its acc row is still emitted); int8: K codes
    with row scales, V raw codes (the reference's plain cast of values a
    few codes wide)."""
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    if int8:
        k, ks = _quant(rng, (b, r, s, hd))
        v = rng.integers(-6, 7, size=(b, r, s, hd)).astype(np.int8)
    else:
        k = rng.normal(size=(b, r, s, hd)).astype(np.float32)
        v = rng.normal(size=(b, r, s, hd)).astype(np.float32)
        ks = None
    h2c = rng.integers(0, r, size=(b, h)).astype(np.int32)
    h2c[1][h2c[1] == 3] = 0
    pos = np.array([s - 1, 23], np.int32)
    return q, k, ks, v, h2c, pos


def _table(rng, b, n_pages, pos):
    """A shuffled block table, its entries past pos naming page 0."""
    n_pool = b * n_pages + 3
    bt = rng.permutation(np.arange(1, n_pool))[:b * n_pages].reshape(
        b, n_pages).astype(np.int32)
    for i in range(b):
        bt[i, pos[i] // PAGE + 1:] = 0
    return bt


def _pages(x, bt, fill):
    """x (B, rows, S[, hd]) on the pool pages ``bt`` names; the null page
    0 filled with ``fill``."""
    b, rows = x.shape[:2]
    pool = np.zeros((b * bt.shape[1] + 3, rows, PAGE) + x.shape[3:], x.dtype)
    pool[0] = fill
    for i in range(b):
        for p, page in enumerate(bt[i]):
            if page:
                pool[page] = x[i, :, p * PAGE:(p + 1) * PAGE]
    return pool


@pytest.mark.parametrize("emit", [False, True], ids=["final", "state"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_fused_share_plain_matches_pallas(rng, int8, emit):
    q, k, ks, v, h2c, pos = _share_case(rng, int8)
    sc = dict(k_scale=ks) if int8 else {}
    want = jck.chai_fused_decode(
        _j(q), _j(k), _j(v), _j(h2c), _j(pos), share_values=True, ts=PAGE,
        emit_state=emit, **{n: _j(x) for n, x in sc.items()})
    before = dict(tck.LAUNCHES)
    got = tops.chai_decode_attention(
        _t(q), _t(k), _t(v), _t(h2c), _t(pos), share_values=True, ts=PAGE,
        emit_state=emit, **{n: _t(x) for n, x in sc.items()})
    assert tck.LAUNCHES == before          # the CPU path launches nothing
    _assert_close(got, want)
    if emit:
        assert tuple(got[2].shape) == tuple(q.shape)   # acc rows: the reps
        # the finalized state is the finalized op (bitwise on the card;
        # the plain versions normalize in two different orders)
        fin = tops.finalize_decode_state(got, _t(h2c), share_values=True)
        np.testing.assert_allclose(fin.numpy(), tops.chai_decode_attention(
            _t(q), _t(k), _t(v), _t(h2c), _t(pos), share_values=True,
            ts=PAGE, **{n: _t(x) for n, x in sc.items()}).numpy(), **TOL)

    # the paged op over shuffled pages: the Pallas paged kernel, and the
    # dense op bitwise (page == tile)
    n_pages = k.shape[2] // PAGE
    bt_k, bt_v = (_table(rng, q.shape[0], n_pages, pos) for _ in range(2))
    kp, vp = _pages(k, bt_k, 77), _pages(v, bt_v, 77)
    psc = dict(k_scale_pool=_pages(ks, bt_k, 1e3)) if int8 else {}
    args = (q, kp, bt_k, vp, bt_v, h2c, pos)
    want = jck.paged_chai_fused_decode(
        *(_j(a) for a in args), share_values=True, emit_state=emit,
        **{n: _j(x) for n, x in psc.items()})
    paged = tops.paged_chai_decode_attention(
        *(_t(a) for a in args), share_values=True, emit_state=emit,
        **{n: _t(x) for n, x in psc.items()})
    _assert_close(paged, want)
    for a, b_ in zip(paged if emit else (paged,), got if emit else (got,)):
        assert torch.equal(a, b_)


def test_share_state_merge_and_finalize_bitwise_match_reference(rng):
    """``merge_decode_states`` / ``finalize_decode_state`` with
    ``share_values``: acc rows are the reps, rescaled by their own
    factors; finalize divides, then gathers. m and the finalize bitwise
    the reference's; l and acc at 1e-6 (XLA contracts a * b + c * d into
    a fused multiply-add on the CPU, ``test_torch_relay.py``'s rule); the
    empty state is the exact identity."""
    b, r, h, hd = 3, 5, 8, 16
    def state():
        m = rng.normal(size=(b, r)).astype(np.float32) * 4
        m[0, 1] = -1e30                      # a rep with nothing live
        return (m, rng.uniform(0.5, 9, size=(b, r)).astype(np.float32),
                rng.normal(size=(b, r, hd)).astype(np.float32))
    s1, s2 = state(), state()
    h2c = rng.integers(0, r, size=(b, h)).astype(np.int32)
    want = jops.merge_decode_states(tuple(_j(x) for x in s1),
                                    tuple(_j(x) for x in s2), _j(h2c),
                                    share_values=True)
    got = tops.merge_decode_states(tuple(_t(x) for x in s1),
                                   tuple(_t(x) for x in s2), _t(h2c),
                                   share_values=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    want_f = jops.finalize_decode_state(tuple(_j(x) for x in s1), _j(h2c),
                                        share_values=True)
    got_f = tops.finalize_decode_state(tuple(_t(x) for x in s1), _t(h2c),
                                       share_values=True)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    empty = (torch.full((b, r), -2e38), torch.zeros(b, r),
             torch.zeros(b, r, hd))
    one = tuple(_t(x) for x in s1)
    one = (torch.clamp(one[0], min=-1e30),) + one[1:]
    merged = tops.merge_decode_states(one, empty, _t(h2c), share_values=True)
    for g, w in zip(merged, one):
        assert torch.equal(g, w)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_share_wrappers_checks_on_meta():
    """The share mode passes the wrappers' checks and reaches the CUDA
    check, int8 V without scales and the softcap included, and so does
    int8 V without scales outside the share mode (the Pallas tile reads
    any V without scales as values); V rows other than R and
    reps_per_group > 1 raise first. Nothing launches."""
    i8, i32 = torch.int8, torch.int32
    q, h2c, pos = _meta(2, 5, 16), _meta(2, 8, dtype=i32), _meta(2,
                                                               dtype=i32)
    k, v = _meta(2, 5, 64, 16, dtype=i8), _meta(2, 5, 64, 16, dtype=i8)
    before = dict(tck.LAUNCHES)
    for emit in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            tck.chai_fused_decode(q, k, v, h2c, pos, k_scale=_meta(2, 5, 64),
                                  share_values=True, emit_state=emit)
        with pytest.raises(ValueError, match="CUDA"):
            tck.paged_chai_fused_decode(
                q, _meta(9, 5, PAGE, 16, dtype=i8), _meta(2, 4, dtype=i32),
                _meta(9, 5, PAGE, 16, dtype=i8), _meta(2, 4, dtype=i32),
                h2c, pos, k_scale_pool=_meta(9, 5, PAGE), share_values=True,
                emit_state=emit)
    with pytest.raises(ValueError, match="CUDA"):
        tck.chai_fused_decode(q, k, v, h2c, pos, k_scale=_meta(2, 5, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tck.chai_fused_decode(q, k, v, h2c, pos, k_scale=_meta(2, 5, 64),
                              share_values=True, softcap=30.0)
    with pytest.raises(ValueError, match="one V row per rep"):
        tck.chai_fused_decode(q, k, _meta(2, 8, 64, 16, dtype=i8), h2c, pos,
                              k_scale=_meta(2, 5, 64), share_values=True)
    with pytest.raises(ValueError, match="MHA-only"):
        tck.paged_chai_fused_decode(
            _meta(2, 4, 16), _meta(9, 2, PAGE, 16), _meta(2, 4, dtype=i32),
            _meta(9, 4, PAGE, 16), _meta(2, 4, dtype=i32), h2c, pos,
            reps_per_group=2, share_values=True)
    assert tck.LAUNCHES == before
    with pytest.raises(AssertionError):       # the reference's own rule
        jck.chai_fused_decode(jnp.zeros((1, 4, 8)), jnp.zeros((1, 2, 16, 8)),
                              jnp.zeros((1, 4, 16, 8)),
                              jnp.zeros((1, 4), jnp.int32),
                              jnp.zeros((1,), jnp.int32), reps_per_group=2,
                              share_values=True)


# ------------------------------------------------------ relay kernel ------
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_relay_share_shape_plain_matches_pallas(rng, int8):
    """Two groups of the share shape over a dense prefix of H rows: acc
    row j R + i reads query row j R + i and V row reps_j[i]; the second
    group has a padded member (index 0 in every map) and a shorter plen.
    int8: K codes with scales, V codes without (the share relay reads
    them scale-less)."""
    g, nmax, r, h, hd, sp = 2, 3, 4, 8, 16, 64
    nr = nmax * r
    q = rng.normal(size=(g, nr, hd)).astype(np.float32)
    if int8:
        k, ks = _quant(rng, (g, h, sp, hd))
        # codes of a few values, as the plain cast of activations gives
        v = rng.integers(-6, 7, size=(g, h, sp, hd)).astype(np.int8)
    else:
        # bf16 values carried in fp32 (the engine's bf16 cache)
        k = np.asarray(jnp.asarray(rng.normal(size=(g, h, sp, hd)),
                                   jnp.bfloat16).astype(jnp.float32))
        v = np.asarray(jnp.asarray(rng.normal(size=(g, h, sp, hd)),
                                   jnp.bfloat16).astype(jnp.float32))
        ks = None
    reps = np.stack([np.stack([rng.permutation(h)[:r] for _ in range(nmax)])
                     for _ in range(g)]).astype(np.int32)  # (G, Nmax, R)
    k_row = reps.reshape(g, nr)
    a_row = np.tile(np.arange(nr, dtype=np.int32), (g, 1))
    v_row = reps.reshape(g, nr).copy()
    for m in (k_row, a_row, v_row):         # group 1: member 2 is padding
        m[1, -r:] = 0
    plen = np.array([48, 20], np.int32)
    args = (q, k, v, k_row, a_row, v_row, plen)
    sc = dict(k_scale=ks) if int8 else {}
    want = jck.relay_prefix_decode(*(_j(x) for x in args), ts=PAGE,
                                   **{n: _j(x) for n, x in sc.items()})
    got = tops.relay_prefix_attention(*(_t(x) for x in args), ts=PAGE,
                                      **{n: _t(x) for n, x in sc.items()})
    _assert_close(got, want)
    assert tuple(got[2].shape) == (g, nr, hd)


# ------------------------------------------------------- cache level ------
def _cfgs(share, int8, **kw):
    def make(get, red):
        cfg = red(get("chai-llama-7b"), n_layers=2, d_model=32, d_ff=64,
                  vocab=64, **kw).replace(dtype="float32")
        if int8:
            cfg = cfg.replace(kv_cache_dtype="int8")
        return cfg.with_chai(enabled=True, share_values=share,
                             cluster_counts=(3,) * cfg.n_attn_layers)
    return make(jget_config, jreduced), make(get_config, reduced)


def _shapes_of_structs(structs):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in structs.items()}


def _shapes_of_table(table):
    return {k: (tuple(shape), str(dt).replace("torch.", ""))
            for k, (shape, dt) in table.items()}


def _fill(rng, shapes, pos=None):
    out = {}
    for k, (shape, dt) in shapes.items():
        if k == "pos":
            out[k] = (np.zeros(shape, np.int32) if pos is None
                      else np.full(shape, pos, np.int32))
        elif dt == "int8":
            out[k] = rng.integers(-127, 128, size=shape).astype(np.int8)
        elif dt == "int32":
            out[k] = np.zeros(shape, np.int32)
        else:
            out[k] = rng.normal(size=shape).astype(np.float32)
    return out


@pytest.mark.parametrize("share", [False, True], ids=["noshare", "share"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_share_cache_layouts_match_reference(rng, share, int8):
    """The {share} x {int8} grid of ``tests/test_cache_slots.py``: state
    shapes of every layout, ``compact_kv``, ``compact_kv_slot`` and
    ``compact_kv_slot_paged`` bitwise, and the three byte counts, each
    equal to the reference's."""
    jcfg, tcfg = _cfgs(share, int8)
    b, s, page = 3, 32, 16
    n_slot = s // page
    kw = dict(page_size=page, dense_pages=2 * b * n_slot + 1,
              chai_pages=(2 if share else 1) * b * n_slot + 1)
    for jfn, tfn, args in (
            (jcache.unified_state_structs, tcache.unified_state_shapes, {}),
            (jcache.paged_state_structs, tcache.paged_state_shapes, kw)):
        want = _shapes_of_structs(jfn(jcfg, b, s, **args)[0])
        assert _shapes_of_table(tfn(tcfg, b, s, **args)) == want
    want = _shapes_of_structs(jcache.chai_state_structs(jcfg, b, s)[0])
    got = tcache.init_chai_state(tcfg, b, s, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want
    assert ("vg_chai" in want) == share and ("vg" in want) != share

    # the cohort and unified compactions
    dense = _fill(rng, _shapes_of_structs(
        jtfm.decode_state_structs(jcfg, b, s)[0]), pos=s - 1)
    k_max = tcfg.k_max
    reps = rng.integers(0, tcfg.n_heads, size=(2, b, k_max)).astype(np.int32)
    want = jcache.compact_kv({k: _j(v) for k, v in dense.items()},
                             {"reps": _j(reps)}, jcfg)
    got = tcache.compact_kv({k: _t(v) for k, v in dense.items()},
                            {"reps": _t(reps)}, tcfg)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    jun = jcache.init_unified_state(jcfg, b, s)
    tun = tcache.init_unified_state(tcfg, b, s, device="cpu")
    for k, v in dense.items():
        jun[k], tun[k] = _j(v), _t(v)
    for i in range(b):
        jun = jcache.compact_kv_slot(jun, {"reps": _j(reps[:, i])}, jcfg,
                                     jnp.int32(i))
        tun = tcache.compact_kv_slot(tun, {"reps": _t(reps[:, i])}, tcfg, i)
    for key in jun:
        np.testing.assert_array_equal(tun[key].numpy(), np.asarray(jun[key]),
                                      key)

    # the paged compaction: each slot's dense rows into pages, compacted
    jst = jcache.init_paged_state(jcfg, b, s, **kw)
    tst = tcache.init_paged_state(tcfg, b, s, **kw, device="cpu")
    dpool = tcache.PagePool(kw["dense_pages"], page)
    cpool = tcache.PagePool(kw["chai_pages"], page)
    for i in range(b):
        mini = {k: v[:, i:i + 1] if v.ndim > 1 else v[i:i + 1]
                for k, v in dense.items()}
        kg, vg = dpool.alloc(n_slot), dpool.alloc(n_slot)
        kc = cpool.alloc(n_slot)
        vc = cpool.alloc(n_slot) if share else kc
        vec = [np.asarray(x, np.int32) for x in (kg, vg, kc, vc)]
        jst = jcache.insert_slot_paged(jst, {k: _j(v) for k, v in
                                             mini.items()}, jnp.int32(i),
                                       _j(vec[0]), _j(vec[1]))
        tst = tcache.insert_slot_paged(tst, {k: _t(v) for k, v in
                                             mini.items()}, i, _t(vec[0]),
                                       _t(vec[1]))
        jst = jcache.compact_kv_slot_paged(
            jst, {"reps": _j(reps[:, i])}, jcfg, jnp.int32(i), _j(vec[2]),
            _j(vec[3]))
        tst = tcache.compact_kv_slot_paged(
            tst, {"reps": _t(reps[:, i])}, tcfg, i, _t(vec[2]), _t(vec[3]))
    for key in jst:
        np.testing.assert_array_equal(tst[key].numpy(), np.asarray(jst[key]),
                                      key)
    if share:                               # dense V tables nulled too
        assert not tst["bt_vg"].any() and tst["bt_vc"].all()

    # the three byte counts
    for chai in (False, True):
        assert tcache.kv_cache_bytes(tcfg, b, s, chai=chai) == \
            jcache.kv_cache_bytes(jcfg, b, s, chai=chai)
        assert tcache.unified_kv_bytes(tcfg, b, s, chai=chai) == \
            jcache.unified_kv_bytes(jcfg, b, s, chai=chai)
    assert tcache.paged_kv_bytes(tcfg, page, 5, 4) == \
        jcache.paged_kv_bytes(jcfg, page, 5, 4)


def test_plain_int8_cast_matches_reference():
    """The reference writes the share_values clustered V into an int8
    cache by ``astype``: XLA truncates toward zero, saturates at [-128,
    127] and maps NaN to 0, where a torch cast wraps. ``plain_int8`` and
    the cache writes that use it give the reference's codes, bit for bit,
    from fp32 and from bf16."""
    x = np.array([0.4, -0.6, 1.7, -1.7, 126.9, 127.5, 128.0, 200.0, 300.0,
                  -128.9, -129.0, -200.0, -300.0, 1e10, -1e10, np.inf,
                  -np.inf, np.nan, 255.0, 256.0, -0.0, 3.0], np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jnp.asarray(x, jdt).astype(jnp.int8))
        got = tcache.plain_int8(torch.from_numpy(x).to(tdt))
        np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(torch.from_numpy(x).to(torch.int8).numpy(),
                              np.asarray(jnp.asarray(x).astype(jnp.int8)))
    # the share-mode write of a row into an int8 pool takes that cast
    pool = torch.zeros(3, 2, PAGE, x.size // 2, dtype=torch.int8)
    ttfm._paged_write_rows(pool, torch.tensor([1]), torch.tensor([4]),
                           torch.from_numpy(x).reshape(1, 2, -1), None)
    np.testing.assert_array_equal(
        pool[1, :, 4].reshape(-1).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int8)))


# ------------------------------------------------------- layer decode -----
@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_share_layer_decode_matches_reference(rng, layout, int8):
    """One share-mode CHAI decode layer (per-request membership) on the
    same state, weights and hidden rows as ``repro.core.chai_attention``:
    the output at 1e-5 and the written cache rows (K codes within one
    code under int8, V by the plain cast) equal. The hidden rows are
    scaled so that V spans several int8 codes."""
    jcfg, tcfg = _cfgs(True, int8)
    b, s = 2, 32
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    p_np = {k: np.asarray(v[0]) for k, v in jparams["attn"].items()}
    jp = {k: _j(v) for k, v in p_np.items()}
    tp = {k: _t(v) for k, v in p_np.items()}
    k_max = tcfg.k_max
    reps = np.stack([np.stack([rng.permutation(tcfg.n_heads)[:k_max]
                               for _ in range(b)]) for _ in range(2)]
                    ).astype(np.int32)                        # (nA, B, k)
    h2c = rng.integers(0, k_max, size=(2, b, tcfg.n_heads)).astype(np.int32)
    ctx = {"reps": reps, "h2c": h2c}
    if layout == "dense":
        shapes = _shapes_of_structs(jcache.unified_state_structs(jcfg, b,
                                                                 s)[0])
    else:
        shapes = _shapes_of_structs(jcache.paged_state_structs(
            jcfg, b, s, page_size=PAGE, dense_pages=9, chai_pages=9)[0])
    st = _fill(rng, shapes)
    st["pos"] = np.array([s - 3, 11], np.int32)
    if layout == "paged":
        st["bt_kc"] = np.array([[1, 2], [3, 0]], np.int32)
        st["bt_vc"] = np.array([[4, 5], [6, 0]], np.int32)
    xn = (rng.normal(size=(b, tcfg.d_model)) * 30).astype(np.float32)
    jout, jst = jchai.chai_decode_attention(
        _j(xn), jp, jcfg, {k: _j(v) for k, v in st.items()},
        {"global": 0, "attn": 0}, {k: _j(v) for k, v in ctx.items()},
        local=False, decode_ts=PAGE)
    tst = {k: _t(v) for k, v in st.items()}
    tout = tchai.chai_decode_attention(_t(xn), tp, tcfg, tst, 0, 0,
                                       {k: _t(v) for k, v in ctx.items()},
                                       decode_ts=PAGE)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for key in (("vg_chai", "kg_chai", "kg_chai_scale") if layout == "dense"
                else ("cp", "cp_scale")):
        if key not in tst:
            continue
        got, want = tst[key].numpy(), np.asarray(jst[key])
        if got.dtype == np.int8:
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=key)
    # the written V rows (int8: plain-cast codes) span several values
    ar, pos = np.arange(b), st["pos"]
    if layout == "dense":
        v_new = tst["vg_chai"][0].numpy()[ar, :, pos]
    else:
        page = st["bt_vc"][ar, pos // PAGE]
        v_new = tst["cp"][0].numpy()[page, :, pos % PAGE]
    assert np.unique(v_new).size > 5


def test_gqa_share_values_raises():
    """share_values is an MHA-only ablation (the reference's kernels
    assert reps_per_group == 1 under it): a GQA config with the flag is
    refused before any state exists."""
    tcfg = reduced(get_config("nemotron-4-15b"), n_layers=2).with_chai(
        share_values=True)
    with pytest.raises(ValueError, match="MHA-only"):
        ttfm.decode_state_shapes(tcfg, 2, 64)
    with pytest.raises(ValueError, match="MHA-only"):
        ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")


# ------------------------------------------------------------- engines ----
ENGINES = {"cohort": dict(scheduler="cohort"),
           "paged": dict(kv_layout="paged"),
           "chunked": dict(kv_layout="paged", prefill_chunk_tokens=16,
                           max_seq=128)}
PROMPT_LENS = (11, 6, 17)
CHUNK_PROMPT_LENS = (40, 9, 33)
BUDGETS = (8, 6, 7)


def _engine_cfgs(int8):
    def make(get, red):
        cfg = red(get("chai-llama-7b"), n_layers=2).with_chai(
            share_values=True)
        return cfg.replace(kv_cache_dtype="int8") if int8 else cfg
    return make(jget_config, jreduced), make(get_config, reduced)


@pytest.fixture(scope="module", params=[False, True], ids=["fp32", "int8"])
def models(request):
    jcfg, tcfg = _engine_cfgs(request.param)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _ecfg(ekw):
    return {"batch_slots": 2, "max_seq": 64, "page_size": PAGE, **ekw}


def _reference_run(jcfg, jparams, prompts, ekw):
    """The reference engine's run: (argmax inputs and outputs per call,
    (scores, membership) per CLUSTER, tokens, page history)."""
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**_ecfg(ekw)))
    calls, idents = [], []
    argmax = jeng._argmax

    def rec_argmax(lg):
        out = argmax(lg)
        calls.append((np.asarray(lg), np.asarray(out)))
        return out
    jeng._argmax = rec_argmax
    if ekw.get("scheduler") == "cohort":
        identify = jeng._identify

        def rec_identify(sc):
            out = identify(sc)
            idents.append((np.asarray(sc),
                           {k: np.asarray(v) for k, v in out.items()}))
            return out
        jeng._identify = rec_identify
    else:
        cluster = jeng._cluster_fn()

        def rec_cluster(state, ctx, slot, *rest):
            i = int(slot)
            sc = np.array(state["chai_scores"][:, i])[:, None]
            state, ctx = cluster(state, ctx, slot, *rest)
            idents.append((sc, {k: np.array(v[:, i])[:, None]
                                for k, v in ctx.items()}))
            return state, ctx
        jeng._cluster_slot = rec_cluster
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        jeng.submit(p, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in jeng.run()}
    hist = [{k: h[k] for k in HISTORY_KEYS}
            for h in getattr(jeng, "kv_bytes_history", [])]
    return calls, idents, done, hist


def _live_rows(eng, n):
    if n == 1 or eng.ecfg.scheduler == "cohort":
        return list(range(n))
    return [i for i, r in enumerate(eng._slot_req)
            if r is not None and eng._phases[i] != tcache.PHASE_PREFILL]


def _lockstep(tcfg, tparams, prompts, ekw, reference):
    """The port's engine driven against a recorded reference run: its
    token each step (logits of live rows at 1e-4, the port's own pick
    where the reference's top-2 margin exceeds 1e-3) and its membership
    each CLUSTER (computed exactly from the reference's buffer first).
    Returns (engine, margin-checked picks)."""
    calls, idents, jdone, _ = reference
    teng = ServingEngine(tcfg, tparams, EngineConfig(**_ecfg(ekw)),
                         device="cpu")
    feed, forced = iter(calls), iter(idents)
    seen = {"tokens": 0}

    def lockstep_argmax(lg):
        want_lg, want_tok = next(feed)
        rows = _live_rows(teng, lg.shape[0])
        np.testing.assert_allclose(lg[rows].numpy(), want_lg[rows],
                                   **LOGIT_TOL)
        for i in rows:
            top2 = np.sort(want_lg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert int(lg[i].argmax()) == int(want_tok[i])
                seen["tokens"] += 1
        return torch.from_numpy(want_tok.astype(np.int64))

    def lockstep_identify(sc):
        want_sc, want_ctx = next(forced)
        # int8: a K row on a quant_rows rounding edge may take the
        # neighbouring code on one side (tests/test_torch_int8.py)
        np.testing.assert_allclose(sc.numpy(), want_sc, **FEATURE_TOL)
        same_buf = tclust.identify_membership(
            torch.from_numpy(want_sc.copy()), tcfg)
        for key in want_ctx:
            np.testing.assert_array_equal(same_buf[key].numpy(),
                                          want_ctx[key])
        return {k: torch.from_numpy(v.copy()) for k, v in want_ctx.items()}

    teng._argmax, teng._identify = lockstep_argmax, lockstep_identify
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        teng.submit(p, max_new_tokens=m, uid=i)
    tdone = {r.uid: r.generated for r in teng.run()}
    assert tdone == jdone                     # teacher-forced: same tokens
    assert next(feed, None) is None and next(forced, None) is None
    return teng, seen["tokens"]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_share_engines_in_lockstep_with_reference(models, engine):
    """The share path through every engine kind, in lockstep with the
    reference's; the paged runs' page accounting equal step by step (a
    CLUSTER frees the slot's dense K and V pages), pools empty at the
    end; the port's dense layout against the reference's paged run."""
    jcfg, tcfg, jparams, tparams = models
    ekw = ENGINES[engine]
    rng = np.random.default_rng(0)
    lens = CHUNK_PROMPT_LENS if engine == "chunked" else PROMPT_LENS
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in lens]
    reference = _reference_run(jcfg, jparams, prompts, ekw)
    jhist = reference[3]
    layouts = ([ekw, dict(ekw, kv_layout="dense")] if engine == "paged"
               else [ekw])
    for kw in layouts:
        teng, checked = _lockstep(tcfg, tparams, prompts, kw, reference)
        assert checked >= 15, checked
        if teng.paged:
            hist = [{k: h[k] for k in HISTORY_KEYS}
                    for h in teng.kv_bytes_history]
            assert hist == jhist
            assert teng.dense_pool.pages_in_use == 0
            assert teng.chai_pool.pages_in_use == 0
            # the clustered pool holds K and V pages of every slot
            assert teng.chai_pool.capacity == 2 * 2 * (kw.get(
                "max_seq", 64) // PAGE)


def test_share_layouts_and_schedulers_agree_inside_the_port(models):
    """Paged, dense and cohort decode the share path alike (page == tile)."""
    jcfg, tcfg, _, tparams = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in PROMPT_LENS]
    runs = {}
    for name, ekw in (("paged", {}), ("dense", dict(kv_layout="dense")),
                      ("cohort", dict(scheduler="cohort"))):
        eng = ServingEngine(tcfg, tparams, EngineConfig(**_ecfg(ekw)),
                            device="cpu")
        for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
            eng.submit(p, max_new_tokens=m, uid=i)
        runs[name] = {r.uid: r.generated for r in eng.run()}
    assert runs["paged"] == runs["dense"] == runs["cohort"]


# ------------------------------------------------- prefix cache + relay ---
S, SLOTS = 64, 2
POOL_TOL = dict(atol=1e-5, rtol=1e-5)


def _slo_cfg(get, red, int8):
    cfg = red(get("chai-llama-7b"), n_layers=2, d_model=32, d_ff=64,
              vocab=64).replace(dtype="float32").with_chai(
                  enabled=True, warmup_tokens=3, share_values=True)
    return cfg.replace(kv_cache_dtype="int8") if int8 else cfg


def _prefix_ecfg(cls, relay):
    return cls(batch_slots=SLOTS, max_seq=S, page_size=PAGE, num_pages=33,
               num_chai_pages=33, prefix_cache=True, relay_decode=relay)


def _traffic():
    """A shared 32-token prefix warmed by a request that retires in
    WARMUP; two suffix requests (partial hits, a relay group of two); a
    miss; then request 1's prompt again (a snapshot hit, clustered V pages
    aliased)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 64, size=2 * PAGE).tolist()
    s = [rng.integers(0, 64, size=n).tolist() for n in (4, 5, 10)]
    warm = (0, prefix + [1], 4)
    rest = [(1, prefix + s[0], 7), (2, prefix + s[1], 7), (3, s[2], 5),
            (4, prefix + s[0], 7)]
    return warm, rest


def _close(got, want, err_msg):
    """int8 codes within one code, float tensors at POOL_TOL."""
    got, want = got.numpy(), np.asarray(want)
    if got.dtype == np.int8:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max(initial=0) <= 1, err_msg
    else:
        np.testing.assert_allclose(got, want, **POOL_TOL, err_msg=err_msg)


@pytest.mark.parametrize("relay", [False, True], ids=["plain", "relay"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_share_prefix_cache_in_lockstep_with_reference(int8, relay):
    """The ``{"share_values": True}`` rows of the reference's prefix-cache
    and relay tests on the port: the engines stepped together, every
    pool, table (``bt_vc`` included), refcount, phase and relay dict held
    after every step; snapshots hold clustered V pages and no dense V."""
    jcfg = _slo_cfg(jget_config, jreduced, int8)
    tcfg = _slo_cfg(get_config, reduced, int8)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jeng = JServingEngine(jcfg, jparams, _prefix_ecfg(JEngineConfig, relay))
    teng = ServingEngine(tcfg, tparams, _prefix_ecfg(EngineConfig, relay),
                         device="cpu")
    calls, clusters, checked = [], [], []
    jargmax, jcluster = jeng._argmax, jeng._cluster_fn()

    def rec_argmax(lg):
        live = ([True] if lg.shape[0] == 1 else
                [r is not None and jeng._phases[i] != jcache.PHASE_PREFILL
                 for i, r in enumerate(jeng._slot_req)])
        tok = jargmax(lg)
        calls.append((np.asarray(lg), np.asarray(tok), live))
        return tok

    def rec_cluster(state, ctx, slot, *rest):
        state, ctx = jcluster(state, ctx, slot, *rest)
        clusters.append({k: np.array(v[:, int(slot)])
                         for k, v in ctx.items()})
        return state, ctx

    def port_argmax(lg):
        jlg, jtok, live = calls.pop(0)
        rows = [i for i, a in enumerate(live) if a]
        np.testing.assert_allclose(lg.numpy()[rows], jlg[rows], **LOGIT_TOL)
        own = torch.argmax(lg, dim=-1).numpy()
        for i in rows:
            top2 = np.sort(jlg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert own[i] == jtok[i]
                checked.append(1)
        return torch.from_numpy(jtok.astype(np.int64))

    jeng._argmax, jeng._cluster_slot = rec_argmax, rec_cluster
    teng._argmax = port_argmax
    teng._identify = lambda sc: {k: torch.from_numpy(v[:, None])
                                 for k, v in clusters.pop(0).items()}
    relays = {"ref": [], "port": []}
    if relay:
        for eng, side in ((jeng, "ref"), (teng, "port")):
            def built(active, _fn=eng._build_relay, _s=side):
                out = _fn(active)
                relays[_s].append(out)
                return out
            eng._build_relay = built
    n_relay = 0
    pools = ("kvp", "cp") + (("kvp_scale", "cp_scale") if int8 else ())

    def run_until_idle():
        nonlocal n_relay
        while jeng.has_work():
            jeng.step()
            teng.step()
            assert not calls and not clusters
            np.testing.assert_array_equal(teng._phases, jeng._phases)
            js, ts = jeng._dev_state, teng._dev_state
            for key in pools:
                _close(ts[key][:, 1:], np.asarray(js[key])[:, 1:], key)
            for key in ("pos", "phase", "bt_kg", "bt_vg", "bt_kc", "bt_vc"):
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]), key)
            for tp, jp in ((teng.dense_pool, jeng.dense_pool),
                           (teng.chai_pool, jeng.chai_pool)):
                assert tp._rc == jp._rc
            assert teng.prefix_stats() == {
                k: v for k, v in jeng.prefix_stats().items()
                if k in teng.prefix_stats()}
            assert teng.relay_steps == jeng.relay_steps
            for trel, jrel in zip(relays["port"], relays["ref"]):
                assert (trel is None) == (jrel is None)
                if trel is None:
                    continue
                assert sorted(trel) == sorted(jrel)
                for key in trel:
                    if trel[key].dtype in (torch.int32, torch.bool):
                        np.testing.assert_array_equal(
                            trel[key].numpy(), np.asarray(jrel[key]), key)
                    else:
                        _close(trel[key], jrel[key], key)
                n_relay += 1
            relays["port"].clear()
            relays["ref"].clear()

    warm, rest = _traffic()
    for eng in (jeng, teng):
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
    run_until_idle()
    for uid, prompt, max_new in rest:
        for eng in (jeng, teng):
            eng.submit(prompt, max_new_tokens=max_new, uid=uid)
    run_until_idle()
    tdone = {r.uid: r for r in teng.done}
    jdone = {r.uid: r for r in jeng.done}
    assert {u: r.generated for u, r in tdone.items()} == \
        {u: r.generated for u, r in jdone.items()}
    assert {u: (r.cache_hit, r.cached_tokens) for u, r in tdone.items()} \
        == {u: (r.cache_hit, r.cached_tokens) for u, r in jdone.items()}
    assert tdone[4].cache_hit == "snapshot" and tdone[1].cache_hit == "prefix"
    snaps = list(teng.prefix_cache._snapshots.values())
    assert snaps and all(s.vc_pages and not s.vg_pages for s in snaps)
    if relay:
        assert n_relay > 0 and teng.relay_steps == n_relay
    else:
        assert teng.relay_steps == 0
    assert len(checked) >= 15
    assert teng.kv_bytes_peak() == jeng.kv_bytes_peak()
    for eng in (teng, jeng):
        eng.prefix_cache.clear()
        assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
