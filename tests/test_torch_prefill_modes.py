"""The prefill kernels' and the relay kernel's window and softcap modes,
and gemma2's softcapped suffix prefill, against the JAX package's, on
the CPU.

On the CPU the ops take their plain versions (``kernels.ref``); each is
held against the reference's Pallas kernel in interpret mode at atol =
rtol = 1e-5 (the tiled online softmax and the whole-row softmax round
differently in the last bits). The CUDA kernels' modes are held against
these plain versions on the card by ``chip_smoke.py``.

* ``flash_prefill`` with a sliding window, a softcap and both, finalized
  and as the state, MHA and GQA, with the Pallas kernel cut into 8-key
  tiles so that its window skip runs; offsets that leave the last rows
  no key inside their window. Such a row is the exact merge identity in
  the port (m = -2e38, l = 0, acc = 0; finalized: zeros), where the
  Pallas kernel leaves m = -2e38 or the clamp -1e30 by its tiles: l and
  acc are held everywhere, m on the rows that see a key.
* ``paged_prefix_attend`` with a softcap, float and int8 pools.
* ``relay_prefix_decode`` with a softcap, float and int8 (K and V
  scales), and the share shape (acc rows on the reps' V rows, int8 V
  codes without scales).
* Capped differs from uncapped; ``softcap=0`` and ``window=0`` are the
  plain modes; the CUDA wrappers refuse no mode (a CPU tensor reaches
  the device check) and take gemma2's head dim 224; a launch is counted
  by its modes.
* ``forward_fullseq(prefix_len, prefix_kv)`` on reduced gemma2-9b at cap
  5, float and int8 pools: the logits at 1e-4 and the global caches the
  suffix writes (int8: codes within one code, scales at 1e-5).
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
CAP = 5.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _quant(x):
    q, s = jcache.quant_rows(jnp.asarray(x))
    return np.array(q), np.array(s)


def _hold_state(got, want):
    """l and acc everywhere; m on the rows that see a key. A row that sees
    none is the exact identity in the port; the Pallas kernel leaves its m
    at -2e38 (no tile) or at the clamp -1e30 (masked tiles)."""
    m, l, acc = (x.numpy() for x in got)
    wm, wl, wacc = (np.asarray(x) for x in want)
    np.testing.assert_allclose(l, wl, **TOL)
    np.testing.assert_allclose(acc, wacc, **TOL)
    live = wl > 0
    np.testing.assert_allclose(m[live], wm[live], **TOL)
    assert (m[~live] == np.float32(NEG_INF)).all()
    assert (wm[~live] <= -1e30).all()
    assert not l[~live].any() and not acc[~live].any()
    return ~live


# ------------------------------------------------------- flash_prefill ----
# (b, t, s, h, kv, hd, offset): a chunk over its own keys, a chunk at an
# offset, and rows past S + window - 1 (no key inside their window).
FLASH_CASES = {
    "mha": dict(b=2, t=24, s=24, h=4, kv=4, hd=16, offset=0),
    "mha_offset": dict(b=1, t=16, s=40, h=4, kv=4, hd=16, offset=24),
    "gqa_empty_rows": dict(b=2, t=16, s=24, h=6, kv=2, hd=8, offset=20),
}
MODES = {"window": dict(window=8), "softcap": dict(softcap=CAP),
         "both": dict(window=8, softcap=CAP)}


@pytest.mark.parametrize("emit_state", [False, True],
                         ids=["finalized", "emit_state"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_prefill_modes_match_pallas(rng, name, mode, emit_state):
    kw = dict(FLASH_CASES[name])
    offset = kw.pop("offset")
    b, t, s, h, kv, hd = (kw[k] for k in ("b", "t", "s", "h", "kv", "hd"))
    q = (rng.normal(size=(b, t, h, hd)) * 3).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    mkw = MODES[mode]
    want = jfk.flash_prefill(_j(q), _j(k), _j(v), offset=offset, ts=8,
                             emit_state=emit_state, interpret=True, **mkw)
    before = dict(tfk.LAUNCHES)
    got = tops.flash_prefill_attention(_t(q), _t(k), _t(v), offset,
                                       emit_state=emit_state, **mkw)
    assert tfk.LAUNCHES == before          # the CPU path launches nothing
    window = mkw.get("window", 0)
    pos = offset + np.arange(t)
    # the rows with no key inside their window
    empty = (pos - (s - 1) >= window) if window else np.zeros(t, bool)
    if emit_state:
        dead = _hold_state(got, want)
        assert (dead == empty[None, None, :]).all()
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert not got[:, empty].any()
    assert bool(np.any(empty)) == (name == "gqa_empty_rows" and window > 0)
    plain = tops.flash_prefill_attention(_t(q), _t(k), _t(v), offset,
                                         emit_state=emit_state)
    a, c = ((x[-1] if emit_state else x) for x in (got, plain))
    assert not torch.allclose(a, c, atol=1e-4)


def test_flash_prefill_zero_modes_are_the_plain_mode(rng):
    """``window=0`` and ``softcap=0`` give the plain mode's bits."""
    q = rng.normal(size=(1, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 40, 4, 8)).astype(np.float32)
    v = rng.normal(size=(1, 40, 4, 8)).astype(np.float32)
    for emit in (False, True):
        a = tops.flash_prefill_attention(_t(q), _t(k), _t(v), 24,
                                         emit_state=emit)
        z = tops.flash_prefill_attention(_t(q), _t(k), _t(v), 24, window=0,
                                         softcap=0.0, emit_state=emit)
        for x, y in zip(a if emit else (a,), z if emit else (z,)):
            assert torch.equal(x, y)


# ------------------------------------------------- paged_prefix_attend ----
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_paged_prefix_attend_softcap_matches_pallas(rng, kv, int8):
    """Row 0 at plen 0 (the exact merge identity), row 1 over 40 cached
    positions of shuffled pages, the null page poisoned."""
    b, t, h, hd, n_pages = 2, 16, 4, 16, 4
    q = (rng.normal(size=(b, t, h, hd)) * 3).astype(np.float32)
    n_pool = 2 * b * n_pages + 1
    pool = rng.normal(size=(n_pool, kv, PAGE, hd)).astype(np.float32)
    skw = {}
    if int8:
        pool, spool = _quant(pool)
        spool[0] = 1e3
        skw = dict(k_scale_pool=spool, v_scale_pool=spool)
    pool[0] = 99
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    bt_k = perm[:b * n_pages].reshape(b, n_pages)
    bt_v = perm[b * n_pages:2 * b * n_pages].reshape(b, n_pages)
    bt_k[1, 3:] = bt_v[1, 3:] = 0           # past the prefix: null page
    plen = np.array([0, 40], np.int32)
    args = (q, pool, bt_k, bt_v, plen)
    want = jfk.paged_prefix_attend(*(_j(x) for x in args), softcap=CAP,
                                   interpret=True,
                                   **{n: _j(x) for n, x in skw.items()})
    tkw = {n: _t(x) for n, x in skw.items()}
    got = tops.paged_prefix_attention(*(_t(x) for x in args), softcap=CAP,
                                      **tkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    m, l, acc = got
    assert torch.equal(m[0], torch.full_like(m[0], NEG_INF))
    assert not l[0].any() and not acc[0].any()
    uncapped = tops.paged_prefix_attention(*(_t(x) for x in args), **tkw)
    assert not torch.allclose(acc[1], uncapped[2][1], atol=1e-4)


# ---------------------------------------------------- relay_prefix_decode --
def _relay_case(rng, mode):
    """Two groups of 3 members (the second with a padded member: index 0
    in every map) over a 64-position prefix, plen 48 and 20. "mha": a K
    row per rep and a V row per head; "share": V rows are the reps
    (acc row j * R + i reads query row j * R + i and V row k_row of it),
    int8 V codes read without scales."""
    g, nmax, r, h, hd, sp = 2, 3, 3, 8, 16, 64
    nr = nmax * r
    q = (rng.normal(size=(g, nr, hd)) * 3).astype(np.float32)
    k = rng.normal(size=(g, h, sp, hd)).astype(np.float32)
    k_row = rng.integers(0, h, size=(g, nr)).astype(np.int32)
    if mode == "share":
        a_row = np.tile(np.arange(nr), (g, 1)).astype(np.int32)
        v_row = k_row.copy()
    else:
        a = nmax * h
        a_row = (np.repeat(np.arange(nmax) * r, h)[None]
                 + rng.integers(0, r, size=(g, a))).astype(np.int32)
        v_row = np.tile(np.arange(h), (g, nmax)).astype(np.int32)
    v = rng.normal(size=(g, h, sp, hd)).astype(np.float32)
    for m in (k_row, a_row, v_row):         # group 1: member 2 is padding
        m[1, -(m.shape[1] // nmax):] = 0
    return [q, k, v, k_row, a_row, v_row, np.array([48, 20], np.int32)]


@pytest.mark.parametrize("mode", ["float", "int8", "share_int8"])
def test_relay_softcap_matches_pallas(rng, mode):
    args = _relay_case(rng, "share" if mode == "share_int8" else "mha")
    skw = {}
    if mode != "float":
        args[1], skw["k_scale"] = _quant(args[1])
        if mode == "int8":
            args[2], skw["v_scale"] = _quant(args[2])
        else:
            args[2] = rng.integers(-6, 7, size=args[2].shape).astype(np.int8)
    want = jck.relay_prefix_decode(*(_j(x) for x in args), ts=PAGE,
                                   softcap=CAP, interpret=True,
                                   **{n: _j(x) for n, x in skw.items()})
    tkw = {n: _t(x) for n, x in skw.items()}
    before = dict(tck.LAUNCHES)
    got = tops.relay_prefix_attention(*(_t(x) for x in args), ts=PAGE,
                                      softcap=CAP, **tkw)
    assert tck.LAUNCHES == before
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    uncapped = tops.relay_prefix_attention(*(_t(x) for x in args), ts=PAGE,
                                           **tkw)
    assert not torch.allclose(got[2], uncapped[2], atol=1e-4)
    zero = tops.relay_prefix_attention(*(_t(x) for x in args), ts=PAGE,
                                       softcap=0.0, **tkw)
    assert all(torch.equal(a, b) for a, b in zip(zero, uncapped))


# ------------------------------------------------------ the wrappers ----
def test_wrappers_refuse_no_mode_and_take_head_dim_224():
    """No window or softcap the Pallas kernels accept is refused: with
    every mode on, a CPU tensor reaches the device check (the kernels
    launch on CUDA tensors only). gemma2's head dim 224 is built."""
    q = torch.zeros((1, 16, 2, 224))
    kv = torch.zeros((1, 16, 2, 224))
    pool = torch.zeros((3, 2, PAGE, 224))
    bt = torch.ones((1, 1), dtype=torch.int32)
    calls = [
        lambda: tfk.flash_prefill(q, kv, kv, window=8, softcap=CAP),
        lambda: tfk.flash_prefill(q, kv, kv, window=8, softcap=CAP,
                                  emit_state=True),
        lambda: tfk.paged_prefix_attend(q, pool, bt, bt,
                                        torch.tensor([16]), softcap=CAP),
        lambda: tck.relay_prefix_decode(
            torch.zeros((1, 2, 224)), torch.zeros((1, 2, 16, 224)),
            torch.zeros((1, 2, 16, 224)), torch.zeros((1, 2), dtype=int),
            torch.zeros((1, 2), dtype=int), torch.zeros((1, 2), dtype=int),
            torch.tensor([16]), softcap=CAP)]
    for call in calls:
        with pytest.raises(ValueError, match="launches a CUDA kernel"):
            call()
    assert 224 in tfk._HEAD_DIMS


def test_launches_are_counted_by_mode():
    """A launch counts once in its module's LAUNCHES and once under the
    modes it ran, in a fixed order ("int8", "share", "softcap",
    "window"); a launch in no mode only in LAUNCHES."""
    saved = dict(tck.MODE_LAUNCHES)
    counts = {"flash_prefill": 0}
    try:
        tck.MODE_LAUNCHES.clear()
        tck.count_launch(counts, "flash_prefill", softcap=0.0, window=False)
        tck.count_launch(counts, "flash_prefill", softcap=CAP, window=True)
        tck.count_launch(counts, "flash_prefill", window=True)
        tck.count_launch(counts, "flash_prefill", window=True, int8=True)
        assert counts == {"flash_prefill": 4}
        assert tck.MODE_LAUNCHES == {"flash_prefill[softcap+window]": 1,
                                     "flash_prefill[window]": 1,
                                     "flash_prefill[int8+window]": 1}
    finally:
        tck.MODE_LAUNCHES.clear()
        tck.MODE_LAUNCHES.update(saved)


# ------------------------------------------- gemma2's suffix prefill ----
@pytest.mark.parametrize("int8", [False, True], ids=["bf16_layout", "int8"])
def test_gemma2_suffix_prefill_matches_reference(int8):
    """Reduced gemma2-9b (a local and a global layer, cap 5, fp32): a
    16-token prefix prefilled, its global K/V moved to shuffled pool
    pages (int8: codes and scales), then a 12-token suffix through
    ``forward_fullseq(prefix_len=16, prefix_kv=...)`` on both packages:
    the global layer's two passes run the prefill ops' softcap mode
    (int8: the scaled one). Logits at 1e-4; the suffix's global cache
    rows (int8: codes within one code, scales at 1e-5)."""
    red = dict(n_layers=2, window=8)
    jcfg = jreduced(jget_config("gemma2-9b"), **red).replace(
        attn_logit_softcap=CAP)
    tcfg = reduced(get_config("gemma2-9b"), **red).replace(
        attn_logit_softcap=CAP)
    if int8:
        jcfg, tcfg = (c.replace(kv_cache_dtype="int8") for c in (jcfg, tcfg))
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(5)
    b, plen, t, s = 2, 16, 12, 64
    toks = rng.integers(0, jcfg.vocab_size, (b, plen + t))
    js = jtfm.init_decode_state(jcfg, b, s)
    _, js, _ = jtfm.forward_fullseq(jparams, jcfg, _j(toks[:, :plen]),
                                    state=js)
    # the prefix's pages: K on pages bt_k, V on bt_v, of one shuffled pool
    ng, _, kv, _, hd = js["kg"].shape
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
    if int8:
        assert tst["kl"].dtype == torch.float32     # the rings stay float
