"""The softcap mode of the fused CHAI decode pair, and the softcapped GQA
decode layer, against the JAX package's, on the CPU.

gemma2's tanh attention-logit softcap (``cap * tanh(score / cap)`` after
the QK scale, and after the int8 K scale, before the mask) composes with
every mode of the Pallas ``chai_fused_decode`` / ``paged_chai_fused_decode``,
so the port's op takes it in every mode too. On the CPU the op is the
plain version (``kernels.ref``); on the card the CUDA kernel's softcap
mode (``chip_smoke.py`` phase 3 holds the two at 2e-5).

* The plain versions against the Pallas kernels in interpret mode at
  atol = rtol = 1e-5, mirroring ``tests/test_kernels.py``'s softcap
  tests: caps 5 and 50 x {mha, mha_share, gqa} finalized; int8 (K codes
  with scales; V codes with scales, raw under share) and ``emit_state``
  for each mode at cap 5; the paged op on shuffled pages against the
  Pallas paged kernel and bitwise against the dense op (page == tile);
  capped unequal to uncapped.
* One GQA decode layer of reduced gemma2-9b (cap 5) through
  ``core.chai_attention.chai_decode_attention``, a global layer (the
  fused op, dense and paged, and paged with a relay group: the suffix
  pass and the relay pass over the packed prefix both capped, their
  states merged) and a local one (the ring), against the reference's at
  1e-5, the written cache rows too.
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
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import chai_attention as tchai
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _case(rng, mode, int8):
    """A dense problem: B = 2, S = 64, hd = 16, ragged pos. MHA: 5 reps
    of 8 heads (rep 3 without a member in row 1); GQA: 2 groups of 4
    heads, 3 reps each. Queries scaled by 3, so scores span a few units
    (a cap of 5 bends them hard, 50 a little). int8: K codes with row
    scales; V codes with scales, or raw codes under share_values."""
    b, s, hd = 2, 64, 16
    share = mode == "mha_share"
    if mode == "gqa":
        kv, rpg, qpk = 2, 3, 4
        h = kv * qpk
        cluster_of = rng.integers(0, rpg, size=(b, kv, qpk))
        h2c = (np.arange(kv)[None, :, None] * rpg + cluster_of).reshape(b, h)
        v_rows = kv
    else:
        kv, rpg, h = 5, 1, 8
        h2c = rng.integers(0, kv, size=(b, h))
        h2c[1][h2c[1] == 3] = 0
        v_rows = kv if share else h
    q = (rng.normal(size=(b, kv * rpg, hd)) * 3).astype(np.float32)
    k = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, v_rows, s, hd)).astype(np.float32)
    kw = dict(reps_per_group=rpg, share_values=share)
    if int8:
        kq, ks = jcache.quant_rows(jnp.asarray(k))
        k, kw["k_scale"] = np.array(kq), np.array(ks)
        if share:
            v = rng.integers(-6, 7, size=v.shape).astype(np.int8)
        else:
            vq, vs = jcache.quant_rows(jnp.asarray(v))
            v, kw["v_scale"] = np.array(vq), np.array(vs)
    pos = np.array([s - 1, 37], np.int32)
    return (q, k, v, h2c.astype(np.int32), pos), kw


def _paged(rng, args, kw):
    """The dense problem on shuffled pool pages (the null page 0 filled
    with garbage, named by nothing here)."""
    q, k, v, h2c, pos = args
    b, n = k.shape[0], k.shape[2] // PAGE

    def pages(x, bt):
        pool = np.zeros((b * n + 3, x.shape[1], PAGE) + x.shape[3:], x.dtype)
        pool[0] = 77
        for i in range(b):
            for p in range(n):
                pool[bt[i, p]] = x[i, :, p * PAGE:(p + 1) * PAGE]
        return pool
    bts = [rng.permutation(np.arange(1, b * n + 3))[:b * n].reshape(
        b, n).astype(np.int32) for _ in range(2)]
    pkw = {"reps_per_group": kw["reps_per_group"],
           "share_values": kw["share_values"]}
    for name, bt in (("k_scale", bts[0]), ("v_scale", bts[1])):
        if name in kw:
            pkw[name + "_pool"] = pages(kw[name], bt)
    return (q, pages(k, bts[0]), bts[0], pages(v, bts[1]), bts[1], h2c,
            pos), pkw


def _assert_close(got, want):
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _assert_close(g, w)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _hold(rng, mode, int8, cap, emit):
    args, kw = _case(rng, mode, int8)
    want = jck.chai_fused_decode(*(_j(a) for a in args), ts=PAGE,
                                 softcap=cap, emit_state=emit, interpret=True,
                                 **{n: _j(x) if isinstance(x, np.ndarray)
                                    else x for n, x in kw.items()})
    before = dict(tck.LAUNCHES)
    tkw = {n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in kw.items()}
    got = tops.chai_decode_attention(*(_t(a) for a in args), ts=PAGE,
                                     softcap=cap, emit_state=emit, **tkw)
    assert tck.LAUNCHES == before          # the CPU path launches nothing
    _assert_close(got, want)
    uncapped = tops.chai_decode_attention(*(_t(a) for a in args), ts=PAGE,
                                          emit_state=emit, **tkw)
    assert not np.allclose(*((x[-1] if emit else x).numpy()
                             for x in (got, uncapped)))

    pargs, pkw = _paged(rng, args, kw)
    pwant = jck.paged_chai_fused_decode(
        *(_j(a) for a in pargs), softcap=cap, emit_state=emit,
        interpret=True, **{n: _j(x) if isinstance(x, np.ndarray) else x
                           for n, x in pkw.items()})
    paged = tops.paged_chai_decode_attention(
        *(_t(a) for a in pargs), softcap=cap, emit_state=emit,
        **{n: _t(x) if isinstance(x, np.ndarray) else x
           for n, x in pkw.items()})
    _assert_close(paged, pwant)
    for a, b_ in zip(paged if emit else (paged,), got if emit else (got,)):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("mode", ["mha", "mha_share", "gqa"])
@pytest.mark.parametrize("cap", [5.0, 50.0])
def test_softcap_plain_matches_pallas(rng, mode, cap):
    _hold(rng, mode, False, cap, False)


@pytest.mark.parametrize("mode", ["mha", "mha_share", "gqa"])
def test_softcap_int8_plain_matches_pallas(rng, mode):
    _hold(rng, mode, True, 5.0, False)


@pytest.mark.parametrize("mode", ["mha", "mha_share", "gqa"])
def test_softcap_state_plain_matches_pallas(rng, mode):
    _hold(rng, mode, False, 5.0, True)


# --------------------------------------------------- the decode layer ----
def _relay(rng, ctx, ai, tcfg, b, hd):
    """A relay dict (the engine's layout) with both slots in one group
    over a one-page (16-position) packed prefix: query row j * KV * r +
    g * r + i (member j's rep i of group g) reads K row g; acc row
    j * H + h reads query row j * KV * r + (h // qpk) * r +
    cluster_of[h] and V row h // qpk, in both attention layers."""
    n_kv, qpk, r = tcfg.n_kv_heads, tcfg.q_per_kv, ctx["reps"].shape[-1]
    h = n_kv * qpk
    k_row = np.tile(np.repeat(np.arange(n_kv), r), b)
    heads = np.arange(h)
    a_row = np.stack([np.concatenate([
        j * n_kv * r + (heads // qpk) * r
        + ctx["cluster_of"][layer, j].reshape(h) for j in range(b)])
        for layer in range(2)])
    v_row = np.tile(heads // qpk, b)
    rows = lambda x: np.tile(x.astype(np.int32)[None, None], (2, 1, 1))
    return {"k": rng.normal(size=(1, 1, n_kv, PAGE, hd)).astype(np.float32),
            "v": rng.normal(size=(1, 1, n_kv, PAGE, hd)).astype(np.float32),
            "plen": np.array([PAGE], np.int32),
            "members": np.arange(b, dtype=np.int32)[None],
            "k_row": rows(k_row), "a_row": a_row[:, None].astype(np.int32),
            "v_row": rows(v_row), "gid": np.zeros(b, np.int32),
            "midx": np.arange(b, dtype=np.int32),
            "len": np.full(b, PAGE, np.int32),
            "in_group": np.ones(b, bool)}


@pytest.mark.parametrize("layer", ["global_dense", "global_paged",
                                   "global_paged_relay", "local"])
def test_softcapped_gqa_layer_matches_reference(rng, layer):
    """One GQA CHAI decode layer of reduced gemma2-9b at cap 5, per-request
    membership, on the same state, weights and hidden rows as
    ``repro.core.chai_attention``: the output at 1e-5 and the written
    cache rows equal (the local layer's ring slot ``pos % w`` too). With
    a relay group the slots' first page is the group's packed prefix:
    the relay pass's state, capped, merges with the capped suffix pass's
    (the engine refuses the prefix cache on gemma2, as the reference's
    does; the layer carries the cap all the same)."""
    red = dict(n_layers=2, window=8)
    jcfg = jreduced(jget_config("gemma2-9b"), **red).replace(
        attn_logit_softcap=5.0)
    tcfg = reduced(get_config("gemma2-9b"), **red).replace(
        attn_logit_softcap=5.0)
    b, s = 2, 32
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    ai = 0 if layer == "local" else 1
    p_np = {k: np.asarray(v[ai]) for k, v in jparams["attn"].items()}
    n_kv, qpk = tcfg.n_kv_heads, tcfg.q_per_kv
    r = 2
    reps = np.stack([np.stack([np.stack([rng.permutation(qpk)[:r]
                                         for _ in range(n_kv)])
                               for _ in range(b)]) for _ in range(2)])
    cluster_of = rng.integers(0, r, size=(2, b, n_kv, qpk))
    ctx = {"reps": reps.astype(np.int32),
           "cluster_of": cluster_of.astype(np.int32)}
    paged = layer.startswith("global_paged")
    if paged:
        structs = jcache.paged_state_structs(jcfg, b, s, page_size=PAGE,
                                             dense_pages=9)[0]
    else:
        structs = jcache.unified_state_structs(jcfg, b, s)[0]
    st = {k: rng.normal(size=v.shape).astype(np.float32)
          if v.dtype == jnp.float32 else np.zeros(v.shape, v.dtype)
          for k, v in structs.items()}
    st["pos"] = np.array([s - 3, 11], np.int32)
    if paged:
        st["bt_kg"] = np.array([[1, 2], [3, 0]], np.int32)
        st["bt_vg"] = np.array([[4, 5], [6, 0]], np.int32)
    relay = None
    if layer == "global_paged_relay":
        st["pos"] = np.array([s - 3, 20], np.int32)
        st["bt_kg"][1, 1], st["bt_vg"][1, 1] = 7, 8
        relay = _relay(rng, ctx, ai, tcfg, b, tcfg.head_dim)
    xn = (rng.normal(size=(b, tcfg.d_model)) * 3).astype(np.float32)
    idxs = ({"global": 0, "local": 0, "attn": ai})
    jout, jst = jchai.chai_decode_attention(
        _j(xn), {k: _j(v) for k, v in p_np.items()}, jcfg,
        {k: _j(v) for k, v in st.items()}, idxs,
        {k: _j(v) for k, v in ctx.items()}, local=layer == "local",
        decode_ts=PAGE,
        relay=None if relay is None else {k: _j(v) for k, v in relay.items()})
    tst = {k: _t(v) for k, v in st.items()}
    tout = tchai.chai_decode_attention(
        _t(xn), {k: _t(v) for k, v in p_np.items()}, tcfg, tst,
        None if layer == "local" else 0, ai,
        {k: _t(v) for k, v in ctx.items()},
        li=0 if layer == "local" else None, decode_ts=PAGE,
        relay=None if relay is None else {k: _t(v) for k, v in relay.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for key in ("kl", "vl", "kg", "vg", "kvp"):
        if key in tst:
            np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                       **TOL, err_msg=key)
