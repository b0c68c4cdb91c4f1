"""The port's prefill attention ops against the JAX package, on the CPU.

On the CPU ``kernels.ops.flash_prefill_attention`` and
``paged_prefix_attention`` take their plain versions
(``repro_torch.kernels.ref``); they are held against the reference's
Pallas ``flash_prefill`` and ``paged_prefix_attend`` (interpret mode, as
``tests/test_kernels.py`` runs them) and the reference's oracles, on
numpy-seeded fp32 inputs, at atol = rtol = 1e-5 (the tiled online softmax
and the whole-row softmax round differently in the last bits). A row
with ``plen == 0`` must be the merge identity exactly. The state algebra
(``merge_prefill_states`` / ``finalize_prefill_state``) is held against
``repro.kernels.ops``. The CUDA kernels are built and held against these
plain versions on the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as jfk
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
NEG_INF = -2.0e38


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


def _qkv(rng, *, b, t, s, h, kv, hd):
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k, v


# T = 24 and S = 40 are not multiples of the CUDA kernel's 16-row query
# tile or 64-key tile; offset 16 puts the queries past S's first tile.
FLASH_CASES = {
    "mha_t24": dict(b=2, t=24, s=24, h=4, kv=4, hd=16, offset=0),
    "mha_offset": dict(b=1, t=24, s=40, h=4, kv=4, hd=16, offset=16),
    "gqa_t24": dict(b=2, t=24, s=24, h=6, kv=2, hd=8, offset=0),
    "gqa_offset": dict(b=1, t=8, s=40, h=6, kv=2, hd=8, offset=32),
}


@pytest.mark.parametrize("emit_state", [False, True],
                         ids=["finalized", "emit_state"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_prefill_plain_matches_reference(rng, name, emit_state):
    kw = dict(FLASH_CASES[name])
    offset = kw.pop("offset")
    q, k, v = _qkv(rng, **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    j_kernel = jfk.flash_prefill(jq, jk, jv, offset=offset,
                                 emit_state=emit_state, interpret=True)
    before = dict(tfk.LAUNCHES)
    out = tops.flash_prefill_attention(_t(q), _t(k), _t(v), offset,
                                       emit_state=emit_state)
    assert tfk.LAUNCHES == before          # the CPU path launches nothing
    if emit_state:
        for got, want in zip(out, j_kernel):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        # every row sees key 0, so every m is a computed, clamped max
        assert (out[0] > -1e30).all()
        return
    j_oracle = jref.flash_prefill_ref(jq, jk, jv, offset=offset)
    assert out.dtype == torch.float32 and out.shape == j_kernel.shape
    np.testing.assert_allclose(out.numpy(), _np(j_kernel), **TOL)
    np.testing.assert_allclose(out.numpy(), _np(j_oracle), **TOL)


def test_flash_prefill_offset_as_tensor(rng):
    """The chunked prefill may pass the offset as a tensor."""
    q, k, v = _qkv(rng, b=1, t=8, s=40, h=4, kv=4, hd=8)
    a = tops.flash_prefill_attention(_t(q), _t(k), _t(v), 32)
    b = tops.flash_prefill_attention(_t(q), _t(k), _t(v),
                                     torch.tensor([32], dtype=torch.int32))
    assert torch.equal(a, b)


def _pool_case(rng, *, b, t, h, kv, hd, page, n_pages, plens):
    """A pool whose pages are shuffled over its ids, K and V of one row
    on distinct pages, the other pages random (never read)."""
    n_pool = 2 * b * n_pages + 3
    pool = rng.normal(size=(n_pool, kv, page, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, n_pool))[:2 * b * n_pages]
    bt_k = ids[:b * n_pages].reshape(b, n_pages).astype(np.int32)
    bt_v = ids[b * n_pages:].reshape(b, n_pages).astype(np.int32)
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    return q, pool, bt_k, bt_v, np.asarray(plens, np.int32)


# plen 0 (a first chunk), mid-page (21 of 16-token pages) and the full
# table (64 positions of 4 pages).
PREFIX_CASES = {
    "mha": dict(b=3, t=24, h=4, kv=4, hd=16, page=16, n_pages=4,
                plens=(0, 21, 64)),
    "gqa": dict(b=3, t=16, h=6, kv=2, hd=8, page=16, n_pages=4,
                plens=(64, 0, 37)),
}


@pytest.mark.parametrize("name", sorted(PREFIX_CASES))
def test_paged_prefix_attend_plain_matches_reference(rng, name):
    q, pool, bt_k, bt_v, plen = _pool_case(rng, **PREFIX_CASES[name])
    j_args = [jnp.asarray(a) for a in (q, pool, bt_k, bt_v, plen)]
    j_kernel = jfk.paged_prefix_attend(*j_args, interpret=True)
    j_oracle = jref.paged_prefix_attend_ref(*j_args)
    before = dict(tfk.LAUNCHES)
    got = tops.paged_prefix_attention(*(_t(a) for a in
                                        (q, pool, bt_k, bt_v, plen)))
    assert tfk.LAUNCHES == before
    for g, wk, wo in zip(got, j_kernel, j_oracle):
        assert g.dtype == torch.float32 and g.shape == wk.shape
        np.testing.assert_allclose(g.numpy(), _np(wk), **TOL)
        np.testing.assert_allclose(g.numpy(), _np(wo), **TOL)
    # plen == 0 rows: exactly the identity, as the reference writes it
    empty = plen == 0
    assert empty.any()
    m, l, acc = (x.numpy()[empty] for x in got)
    assert (m == np.float32(NEG_INF)).all() and (m == _np(j_kernel[0])[
        empty]).all()
    assert not l.any() and not acc.any()
    live = ~empty
    assert (got[0].numpy()[live] >= -1e30).all()


def test_merge_and_finalize_match_reference(rng):
    """A prefix state (one row empty) merged with a causal state, then
    finalized, against ``repro.kernels.ops``; the empty row's merge is
    the causal state exactly, and the whole pipeline equals attention
    over prefix + chunk at once."""
    b, t, h, kv, hd, page, n_pages = 2, 16, 4, 4, 8, 16, 3
    q, pool, bt_k, bt_v, plen = _pool_case(
        rng, b=b, t=t, h=h, kv=kv, hd=hd, page=page, n_pages=n_pages,
        plens=(0, 48))
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    st_p = tref.paged_prefix_attend_ref(*(_t(a) for a in
                                          (q, pool, bt_k, bt_v, plen)))
    st_s = tref.flash_prefill_state_ref(_t(q), _t(k), _t(v))
    merged = tops.merge_prefill_states(st_s, st_p)
    out = tops.finalize_prefill_state(merged)
    j_st = [tuple(jnp.asarray(x.numpy()) for x in st)
            for st in (st_s, st_p)]
    j_merged = jops.merge_prefill_states(*j_st)
    j_out = jops.finalize_prefill_state(j_merged)
    for g, w in zip(merged, j_merged):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    assert out.shape == (b, t, h, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(j_out), **TOL)
    for g, w in zip(merged, st_s):           # row 0: exact identity merge
        assert torch.equal(g[0], w[0])
    # row 1: one causal pass over the 48 cached positions + the chunk
    kd = np.concatenate([pool[bt_k[1]].transpose(0, 2, 1, 3).reshape(
        n_pages * page, kv, hd), k[1]])[None]
    vd = np.concatenate([pool[bt_v[1]].transpose(0, 2, 1, 3).reshape(
        n_pages * page, kv, hd), v[1]])[None]
    whole = tref.flash_prefill_ref(_t(q[1:]), _t(kd), _t(vd), offset=48)
    np.testing.assert_allclose(out[1:].numpy(), whole.numpy(), **TOL)
    bf = tops.finalize_prefill_state(merged, dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def _int8_pools_call(q):
    """``paged_prefix_attend`` in its int8 mode on ``meta`` tensors."""
    meta = dict(device="meta")
    pool = torch.empty((3, 2, 16, 8), dtype=torch.int8, **meta)
    scales = torch.empty((3, 2, 16), **meta)
    bt = torch.zeros((1, 2), dtype=torch.int32, **meta)
    return tfk.paged_prefix_attend(q.to("meta"), pool, bt, bt,
                                   torch.zeros(1, dtype=torch.int32, **meta),
                                   k_scale_pool=scales, v_scale_pool=scales)


@pytest.mark.parametrize("call,err,match", [
    (lambda q: tfk.flash_prefill(q, q, q, window=8), ValueError, "CUDA"),
    (lambda q: tfk.flash_prefill(q, q, q, softcap=30.0), ValueError, "CUDA"),
    (_int8_pools_call, ValueError, "CUDA"),
], ids=["window", "softcap", "int8_scale_pools"])
def test_unported_options_raise_naming_roadmap(call, err, match):
    """No option of the Pallas kernels is left unported, so none raises a
    refusal naming a ROADMAP item: the window, the softcap and the int8
    scale pools each reach the device check (CPU tensors), launching
    nothing."""
    q = torch.zeros((1, 4, 2, 8))
    before = dict(tfk.LAUNCHES)
    with pytest.raises(err, match=match):
        call(q)
    assert tfk.LAUNCHES == before


def test_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers launch CUDA kernels only: the CPU path is the
    dispatch's (``kernels.ops``), never a silent fallback inside them."""
    q, k, v = _qkv(rng, b=1, t=8, s=8, h=2, kv=2, hd=8)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.flash_prefill(_t(q), _t(k), _t(v))
    q, pool, bt_k, bt_v, plen = _pool_case(
        rng, b=1, t=8, h=2, kv=2, hd=8, page=16, n_pages=2, plens=(16,))
    with pytest.raises(ValueError, match="CUDA"):
        tfk.paged_prefix_attend(*(_t(a) for a in
                                  (q, pool, bt_k, bt_v, plen)))
