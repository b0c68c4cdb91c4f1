"""Head dim 320 (gemma3-4b's 2560 / 8) on the prefill pair and the relay
kernel, against the JAX package's, on the CPU.

On the CPU the ops take their plain versions (``kernels.ref``); the CUDA
kernels' wide instances (the prefill pair's wide block, the relay's
blocks at that head dim) are held against these plain versions on the
card by ``chip_smoke.py``.

* ``flash_prefill`` finalized and as the state, MHA on fp32 and GQA on
  bf16 inputs, at an offset, against the Pallas kernel in interpret
  mode at atol = rtol = 1e-5 (the port's prefill tests' tolerance: both
  compute in fp32 on the same values; a finalized bf16 output is held
  at one bf16 step, as both round it once).
* ``paged_prefix_attend`` over fp32, bf16 and int8 pools (the int8 one
  with its scale pools) on shuffled pages, rows at plen 0, mid-page and
  the full table, the null page poisoned; a plen == 0 row is the exact
  merge identity.
* ``relay_prefix_decode`` on gemma3's GQA routing (2 reps a KV group),
  float and int8 K and V with scales.
* Reduced gemma3-4b at head dim 320 (a local and a global layer, 2 heads
  over 1 KV group, gemma3's 2:1, d_model 640, fp32), its weights carried
  across by ``params_from_numpy``: the model-level suffix prefill
  (``forward_fullseq(prefix_len, prefix_kv)``) over float and int8 pool
  pages against the reference's, logits at 1e-4 and the global cache
  rows the suffix writes at 1e-5 (int8: codes within one code, scales at
  1e-5).
* The prefill wrappers' head-dim checks on ``meta`` tensors: 320 reaches
  the device check (the wide libraries), 288, 324 and 328 are refused.
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
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttfm
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
NEG_INF = -2.0e38
PAGE = 16
HD = 320


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _quant(x):
    q, s = jcache.quant_rows(jnp.asarray(x))
    return np.array(q), np.array(s)


def _as(x, dtype):
    """numpy fp32 rows as the test's dtype, the same values for both
    packages (bf16 rounded once, by torch)."""
    if dtype == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def _pair(x, dtype):
    """(jax array, torch tensor) of x in ``dtype``."""
    if dtype == "bf16":
        return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    return _j(x), _t(x)


# ------------------------------------------------------- flash_prefill ----
# T = 24 over S = 40 at offset 16: a ragged chunk past the first key tile.
FLASH_CASES = {"mha": dict(h=2, kv=2), "gqa": dict(h=4, kv=2)}


@pytest.mark.parametrize("emit_state", [False, True],
                         ids=["finalized", "emit_state"])
@pytest.mark.parametrize("name,dtype", [("mha", "fp32"), ("gqa", "bf16")])
def test_flash_prefill_plain_at_hd320_matches_pallas(rng, name, dtype,
                                                    emit_state):
    b, t, s, offset = 1, 24, 40, 16
    h, kv = FLASH_CASES[name]["h"], FLASH_CASES[name]["kv"]
    q, k, v = (_as(rng.normal(size=shape).astype(np.float32), dtype)
               for shape in ((b, t, h, HD), (b, s, kv, HD), (b, s, kv, HD)))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    want = jfk.flash_prefill(jq, jk, jv, offset=offset,
                             emit_state=emit_state, interpret=True)
    before = dict(tfk.LAUNCHES)
    got = tops.flash_prefill_attention(tq, tk, tv, offset,
                                       emit_state=emit_state)
    assert tfk.LAUNCHES == before          # the CPU path launches nothing
    if emit_state:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(w, np.float32), **TOL)
    else:
        # both round the fp32 result to the inputs' dtype once
        assert got.dtype == tq.dtype and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **(TOL if dtype == "fp32"
                                      else dict(atol=1e-5, rtol=2 ** -7)))


# ------------------------------------------------- paged_prefix_attend ----
@pytest.mark.parametrize("pool_kind", ["fp32", "bf16", "int8"])
def test_paged_prefix_attend_plain_at_hd320_matches_pallas(rng, pool_kind):
    """Rows at plen 0, 21 (mid-page) and 48 (the full table of 3 pages),
    GQA 4 heads over 2; the null page poisoned."""
    b, t, h, kv, n_pages = 3, 8, 4, 2, 3
    n_pool = 2 * b * n_pages + 1
    q = _as(rng.normal(size=(b, t, h, HD)).astype(np.float32),
            "bf16" if pool_kind == "bf16" else "fp32")
    pool = rng.normal(size=(n_pool, kv, PAGE, HD)).astype(np.float32)
    skw = {}
    if pool_kind == "int8":
        pool, spool = _quant(pool)
        spool[0] = 1e3
        skw = dict(k_scale_pool=spool, v_scale_pool=spool)
    else:
        pool = _as(pool, pool_kind)
    pool[0] = 99
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    bt_k = perm[:b * n_pages].reshape(b, n_pages)
    bt_v = perm[b * n_pages:2 * b * n_pages].reshape(b, n_pages)
    bt_k[0] = bt_v[0] = 0                   # plen 0: every entry null
    bt_k[1, 2:] = bt_v[1, 2:] = 0           # past the prefix: null page
    plen = np.array([0, 21, 48], np.int32)
    dt = "bf16" if pool_kind == "bf16" else "fp32"
    (jq, tq), = (_pair(q, dt),)
    if pool_kind == "int8":
        jpool, tpool = _j(pool), _t(pool)
    else:
        jpool, tpool = _pair(pool, dt)
    tables = (bt_k, bt_v, plen)
    want = jfk.paged_prefix_attend(jq, jpool, *(_j(x) for x in tables),
                                   interpret=True,
                                   **{n: _j(x) for n, x in skw.items()})
    before = dict(tfk.LAUNCHES)
    got = tops.paged_prefix_attention(tq, tpool, *(_t(x) for x in tables),
                                      **{n: _t(x) for n, x in skw.items()})
    assert tfk.LAUNCHES == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)
    m, l, acc = got
    assert torch.equal(m[0], torch.full_like(m[0], NEG_INF))
    assert not l[0].any() and not acc[0].any()


# ---------------------------------------------------- relay_prefix_decode --
@pytest.mark.parametrize("mode", ["float", "int8"])
def test_relay_plain_at_hd320_matches_pallas(rng, mode):
    """Two groups of 2 member slots on gemma3's GQA routing (2 KV groups
    of 2 reps and 2 heads: query row j*R + c*2 + i reads K row c; head h
    of group c reads query row j*R + c*2 + its cluster and V row c), the
    second group's second slot padded (index 0 in every map), plen 40 and
    17 over a 48-position prefix."""
    g, nmax, n_kv, r_g, qpk, sp = 2, 2, 2, 2, 2, 48
    r, h = n_kv * r_g, n_kv * qpk
    q = rng.normal(size=(g, nmax * r, HD)).astype(np.float32)
    k = rng.normal(size=(g, n_kv, sp, HD)).astype(np.float32)
    v = rng.normal(size=(g, n_kv, sp, HD)).astype(np.float32)
    grp = np.arange(h) // qpk
    k_row = np.tile(np.repeat(np.arange(n_kv), r_g), (g, nmax))
    a_row = np.stack([np.concatenate([
        j * r + grp * r_g + rng.integers(0, r_g, size=h)
        for j in range(nmax)]) for _ in range(g)])
    v_row = np.tile(grp, (g, nmax))
    for m in (k_row, a_row, v_row):          # group 1: slot 1 is padding
        m[1, m.shape[1] // nmax:] = 0
    args = [q, k, v, k_row.astype(np.int32), a_row.astype(np.int32),
            v_row.astype(np.int32), np.array([40, 17], np.int32)]
    skw = {}
    if mode == "int8":
        args[1], skw["k_scale"] = _quant(args[1])
        args[2], skw["v_scale"] = _quant(args[2])
    want = jck.relay_prefix_decode(*(_j(x) for x in args), ts=PAGE,
                                   interpret=True,
                                   **{n: _j(x) for n, x in skw.items()})
    before = dict(tck.LAUNCHES)
    got = tops.relay_prefix_attention(*(_t(x) for x in args), ts=PAGE,
                                      **{n: _t(x) for n, x in skw.items()})
    assert tck.LAUNCHES == before
    for gt, w in zip(got, want):
        assert tuple(gt.shape) == tuple(w.shape)
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **TOL)


# ------------------------------------------ gemma3's suffix prefill ----
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_gemma3_suffix_prefill_at_hd320_matches_reference(int8):
    """Reduced gemma3-4b that keeps head dim 320 (a local and a global
    layer, 2 heads over 1 KV group, d_model 640, fp32): a 16-token
    prefix prefilled, its global K/V moved to shuffled pool pages (int8:
    codes and scales), then a 12-token suffix through
    ``forward_fullseq(prefix_len=16, prefix_kv=...)`` on both packages:
    the global layer's two passes run the prefill ops at head dim 320
    (int8: the scaled pool). Logits at 1e-4; the suffix's global cache
    rows (int8: codes within one code, scales at 1e-5)."""
    red = dict(n_layers=2, window=8, n_heads=2, d_model=2 * HD)
    jcfg = jreduced(jget_config("gemma3-4b"), **red)
    tcfg = reduced(get_config("gemma3-4b"), **red)
    if int8:
        jcfg, tcfg = (c.replace(kv_cache_dtype="int8") for c in (jcfg, tcfg))
    assert (tcfg.head_dim, tcfg.n_kv_heads, tcfg.qk_norm) == (HD, 1, True)
    assert tcfg.layer_types == ("attn_local", "attn_global")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(5)
    b, plen, t, s = 2, 16, 12, 32
    toks = rng.integers(0, jcfg.vocab_size, (b, plen + t))
    js = jtfm.init_decode_state(jcfg, b, s)
    _, js, _ = jtfm.forward_fullseq(jparams, jcfg, _j(toks[:, :plen]),
                                    state=js)
    # the prefix's pages: K on pages bt_k, V on bt_v, of one shuffled pool
    ng, _, kv, _, hd = js["kg"].shape
    assert hd == HD
    n_pool = 2 * b + 3
    ids = rng.permutation(np.arange(1, n_pool))[:2 * b].astype(np.int32)
    bt_k, bt_v = ids[:b].reshape(b, 1), ids[b:].reshape(b, 1)
    pool = np.zeros((ng, n_pool, kv, PAGE, hd), np.asarray(js["kg"]).dtype)
    spool = np.zeros((ng, n_pool, kv, PAGE), np.float32)
    for name, bt in (("kg", bt_k), ("vg", bt_v)):
        for i in range(b):
            pool[:, bt[i, 0]] = np.asarray(js[name])[:, i, :, :PAGE]
            if int8:
                spool[:, bt[i, 0]] = np.asarray(
                    js[name + "_scale"])[:, i, :, :PAGE]
    prefix = {"pool": pool, "bt_k": bt_k, "bt_v": bt_v}
    if int8:
        prefix["scale"] = spool
    suffix = toks[:, plen:]
    jst = jtfm.init_decode_state(jcfg, b, s)
    jl, jst, _ = jtfm.forward_fullseq(
        jparams, jcfg, _j(suffix), state=jst, prefix_len=plen,
        prefix_kv={n: _j(x) for n, x in prefix.items()})
    tst = ttfm.init_decode_state(tcfg, b, s, "cpu")
    tl, tst = ttfm.forward_fullseq(
        tparams, tcfg, _t(suffix), state=tst, prefix_len=plen,
        prefix_kv={n: _t(x) for n, x in prefix.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert torch.equal(tst["pos"], _t(np.asarray(jst["pos"])))
    rows = slice(plen, plen + t)
    for name in ("kg", "vg"):
        got = tst[name][:, :, :, rows].numpy().astype(np.float32)
        want = np.asarray(jst[name])[:, :, :, rows].astype(np.float32)
        if int8:
            assert np.abs(got - want).max() <= 1
            np.testing.assert_allclose(
                tst[name + "_scale"][:, :, :, rows].numpy(),
                np.asarray(jst[name + "_scale"])[:, :, :, rows], **TOL)
        else:
            np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------------ the wrappers ----
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("hd,ok", [(320, True), (256, True), (224, True),
                                   (288, False), (324, False), (328, False)])
@pytest.mark.parametrize("kernel", ["flash_prefill", "paged_prefix_attend",
                                    "paged_prefix_attend_int8"])
def test_prefill_wrappers_take_hd320(kernel, hd, ok):
    """The prefill pair's checks (shapes only, ``meta`` tensors): the
    head dims the kernels are built for, 320 on the wide libraries, reach
    the device check; any other is refused by name, launching nothing."""
    q = _meta(1, 16, 8, hd)
    if kernel == "flash_prefill":
        kv = _meta(1, 16, 4, hd)
        call = lambda: tfk.flash_prefill(q, kv, kv, emit_state=True)  # noqa
    else:
        int8 = kernel.endswith("int8")
        pool = _meta(5, 4, PAGE, hd,
                     dtype=torch.int8 if int8 else torch.bfloat16)
        sc = _meta(5, 4, PAGE, dtype=torch.float32) if int8 else None
        bt = _meta(1, 2, dtype=torch.int32)
        call = lambda: tfk.paged_prefix_attend(  # noqa: E731
            q, pool, bt, bt, _meta(1, dtype=torch.int32), k_scale_pool=sc,
            v_scale_pool=sc)
    before = dict(tfk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA" if ok else "head_dim"):
        call()
    assert tfk.LAUNCHES == before
    assert (hd in tfk._HEAD_DIMS) == ok
