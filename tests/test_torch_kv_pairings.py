"""The fused decode pair on every K/V pairing the Pallas wrappers take,
against the JAX package's, on the CPU.

The Pallas tile (``repro.kernels.chai_attention._fused_tile``) casts K
and V to fp32 each on its own and applies each row scale only when it is
passed, so its wrappers take K and V each fp32, bf16 or int8, each with
or without its fp32 row scales (a missing scale reads the codes as
values; a scale beside float rows multiplies them). The port's wrappers
take the same (``kernels.chai_attention._check_scales``). Here the port's
plain versions (``kernels.ref``, what a CPU tensor runs) are held to the
Pallas kernels in interpret mode on the same numpy inputs for every
pairing but the three the serving paths run (fp32/fp32, bf16/bf16 and
int8/int8 with both scales, held in their own files):

* ``chai_fused_decode`` finalized on MHA (a clustered K row a rep, a V
  row a head) and as its ``emit_state`` triple on GQA (reps per K group,
  a V row a group); the share_values mode on a pairing of each V side;
  the softcap on three pairings;
* ``paged_chai_fused_decode`` over shuffled pages with the null page 0
  in the tables past ``pos``, finalized on GQA, and bitwise equal to the
  dense op on the same rows.

Sides (``KINDS``): "f32", "bf16", "i8" (raw codes, ``x * 40`` truncated),
and each with "s" (row scales: the reference's ``quant_rows`` for int8,
[0.5, 1.5) beside float rows). Raw int8 K sits beside queries over 40, so
that the scores keep a float K's range; raw int8 V (codes to 127) is held
over 127. Tolerance atol = rtol = 2e-5: the plain versions dequantize
before the products, the Pallas tile scales the score after the dot.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import cache as jcache
from repro.kernels import chai_attention as jck
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops

TOL = dict(atol=2e-5, rtol=2e-5)
PAGE = 16
CODE_SCALE = 40.0      # raw int8 codes: trunc(x * 40), saturated
CODE_RANGE = 127.0     # raw int8 V: outputs held over the codes' range
KINDS = ("f32", "bf16", "i8", "f32s", "bf16s", "i8s")
SERVED = (("f32", "f32"), ("bf16", "bf16"), ("i8s", "i8s"))
PAIRS = [(a, b) for a in KINDS for b in KINDS if (a, b) not in SERVED]
IDS = [f"{a}-{b}" for a, b in PAIRS]


def side(rng, shape, kind):
    """One side made from normal rows: (numpy values or codes, numpy row
    scales or None, the torch dtype, the jax dtype)."""
    x = rng.normal(size=shape).astype(np.float32)
    base, scaled = kind.rstrip("s"), kind.endswith("s")
    if base == "i8":
        if scaled:
            codes, sc = jcache.quant_rows(jnp.asarray(x))
            return np.array(codes), np.array(sc), torch.int8, jnp.int8
        codes = np.clip(np.trunc(x * CODE_SCALE), -128, 127).astype(np.int8)
        return codes, None, torch.int8, jnp.int8
    if base == "bf16":      # bf16 values carried in fp32, exact both ways
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dts = torch.bfloat16, jnp.bfloat16
    else:
        dts = torch.float32, jnp.float32
    sc = (rng.uniform(0.5, 1.5, size=shape[:-1]).astype(np.float32)
          if scaled else None)
    return (x, sc) + dts


def to_t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def to_j(x, dtype=None):
    a = jnp.asarray(np.array(x))
    return a if dtype is None else a.astype(dtype)


def held(got, want, v_kind):
    """The outputs (or the state's acc) over V's range where V is raw
    int8 codes, at 2e-5."""
    unit = CODE_RANGE if v_kind == "i8" else 1.0
    if isinstance(got, tuple):
        assert len(got) == len(want) == 3
        got = (got[0], got[1], got[2] / unit)
        want = (np.asarray(want[0]), np.asarray(want[1]),
                np.asarray(want[2]) / unit)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(np.shape(w))
            np.testing.assert_allclose(g.numpy(), w, **TOL)
        return
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy() / unit, np.asarray(want) / unit,
                               **TOL)


SHAPES = {"mha": dict(rpg=1, kv_k=5, kv_v=8, h=8),
          "gqa": dict(rpg=3, kv_k=2, kv_v=2, h=8)}


def fused_case(rng, pair, *, rpg, kv_k, kv_v, h, b=2, s=64, hd=16,
               share=False):
    """Inputs of one fused call: q, (K, k_scale), (V, v_scale), h2c, pos,
    each side as ``side`` makes it. ``share``: V clustered like K."""
    r = kv_k * rpg
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    if pair[0] == "i8":
        q = q / CODE_SCALE
    k = side(rng, (b, kv_k, s, hd), pair[0])
    v = side(rng, (b, r if share else kv_v, s, hd), pair[1])
    if rpg == 1:
        h2c = rng.integers(0, r, size=(b, h))
    else:                    # a rep of the head's own K group
        h2c = ((np.arange(h) // (h // kv_v))[None] * rpg
               + rng.integers(0, rpg, size=(b, h)))
    return q, k, v, h2c.astype(np.int32), np.array([s - 1, 23], np.int32)


def call_both(q, k, v, h2c, pos, **kw):
    """(the port's plain version, the Pallas kernel in interpret mode) of
    ``chai_fused_decode`` on one input."""
    want = jck.chai_fused_decode(
        to_j(q), to_j(k[0], k[3]), to_j(v[0], v[3]), to_j(h2c), to_j(pos),
        k_scale=None if k[1] is None else to_j(k[1]),
        v_scale=None if v[1] is None else to_j(v[1]), ts=PAGE, **kw)
    before = dict(tck.LAUNCHES)
    got = tops.chai_decode_attention(
        to_t(q), to_t(k[0], k[2]), to_t(v[0], v[2]), to_t(h2c), to_t(pos),
        k_scale=None if k[1] is None else to_t(k[1]),
        v_scale=None if v[1] is None else to_t(v[1]), ts=PAGE, **kw)
    assert tck.LAUNCHES == before          # the CPU path launches nothing
    return got, want


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_fused_pairing_mha_finalized_matches_pallas(rng, pair):
    q, k, v, h2c, pos = fused_case(rng, pair, **SHAPES["mha"])
    got, want = call_both(q, k, v, h2c, pos, reps_per_group=1)
    held(got, want, pair[1])


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_fused_pairing_gqa_state_matches_pallas(rng, pair):
    q, k, v, h2c, pos = fused_case(rng, pair, **SHAPES["gqa"])
    got, want = call_both(q, k, v, h2c, pos, reps_per_group=3,
                          emit_state=True)
    held(got, want, pair[1])


# share_values: a pairing of each V side (int8 with scales beside int8
# codes without them is the share path's own, held elsewhere)
SHARE_PAIRS = [("bf16", "f32"), ("i8s", "bf16"), ("i8", "i8"),
               ("f32s", "f32s"), ("bf16", "bf16s"), ("f32", "i8s")]


@pytest.mark.parametrize("emit", [False, True], ids=["final", "state"])
@pytest.mark.parametrize("pair", SHARE_PAIRS,
                         ids=[f"{a}-{b}" for a, b in SHARE_PAIRS])
def test_fused_pairing_share_values_matches_pallas(rng, pair, emit):
    q, k, v, h2c, pos = fused_case(rng, pair, share=True, **SHAPES["mha"])
    got, want = call_both(q, k, v, h2c, pos, reps_per_group=1,
                          share_values=True, emit_state=emit)
    held(got, want, pair[1])


SOFTCAP_PAIRS = [("i8s", "bf16"), ("bf16", "i8"), ("f32", "bf16s")]


@pytest.mark.parametrize("pair", SOFTCAP_PAIRS,
                         ids=[f"{a}-{b}" for a, b in SOFTCAP_PAIRS])
def test_fused_pairing_softcap_matches_pallas(rng, pair):
    q, k, v, h2c, pos = fused_case(rng, pair, **SHAPES["gqa"])
    q = q * 4.0                            # scores the cap of 5 bends
    got, want = call_both(q, k, v, h2c, pos, reps_per_group=3, softcap=5.0)
    held(got, want, pair[1])


def _pool_of(rng, x, sc, pos, n_pool):
    """Dense rows (B, rows, S, hd) (and their scales) on shuffled pool
    pages; the null page 0 poisoned and named past each row's pos."""
    b, rows, s, hd = x.shape
    n_pages = s // PAGE
    perm = rng.permutation(np.arange(1, n_pool))[:b * n_pages]
    bt = perm.reshape(b, n_pages).astype(np.int32)
    pool = np.zeros((n_pool, rows, PAGE, hd), x.dtype)
    pool[0] = 77 if x.dtype == np.int8 else 99.0
    spool = None
    if sc is not None:
        spool = np.ones((n_pool, rows, PAGE), np.float32)
        spool[0] = 1e3
    for i in range(b):
        for p in range(n_pages):
            pool[bt[i, p]] = x[i, :, p * PAGE:(p + 1) * PAGE]
            if sc is not None:
                spool[bt[i, p]] = sc[i, :, p * PAGE:(p + 1) * PAGE]
    for i in range(b):
        bt[i, pos[i] // PAGE + 1:] = 0
    return pool, spool, bt


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_paged_fused_pairing_matches_pallas_and_dense(rng, pair):
    c = SHAPES["gqa"]
    q, k, v, h2c, pos = fused_case(rng, pair, **c)
    n_pool = 2 * 4 + 3
    kp, ksp, bt_k = _pool_of(rng, k[0], k[1], pos, n_pool)
    vp, vsp, bt_v = _pool_of(rng, v[0], v[1], pos, n_pool)
    want = jck.paged_chai_fused_decode(
        to_j(q), to_j(kp, k[3]), to_j(bt_k), to_j(vp, v[3]), to_j(bt_v),
        to_j(h2c), to_j(pos),
        k_scale_pool=None if ksp is None else to_j(ksp),
        v_scale_pool=None if vsp is None else to_j(vsp),
        reps_per_group=c["rpg"])
    got = tops.paged_chai_decode_attention(
        to_t(q), to_t(kp, k[2]), to_t(bt_k), to_t(vp, v[2]), to_t(bt_v),
        to_t(h2c), to_t(pos),
        k_scale_pool=None if ksp is None else to_t(ksp),
        v_scale_pool=None if vsp is None else to_t(vsp),
        reps_per_group=c["rpg"])
    held(got, want, pair[1])
    dense = tops.chai_decode_attention(
        to_t(q), to_t(k[0], k[2]), to_t(v[0], v[2]), to_t(h2c), to_t(pos),
        k_scale=None if k[1] is None else to_t(k[1]),
        v_scale=None if v[1] is None else to_t(v[1]),
        reps_per_group=c["rpg"], ts=PAGE)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("pair", [(a, b) for a in KINDS for b in KINDS],
                         ids=[f"{a}-{b}" for a in KINDS for b in KINDS])
def test_pairing_modes_and_body(pair):
    """The kernel body a pairing takes (``kv_body``, decided once on the
    host) and the launch's count by mode derived from it, on ``meta``
    tensors: the serving paths' pairings, and int8 K with scales beside
    raw int8 V (which the fused pair's and the relay's int8 body read),
    keep their bodies and count as before (``int8`` on the int8 body);
    every other pairing takes the general body and counts as
    "kv=<K>/<V>"; the prefix pass's int8 body reads both scale pools, so
    there raw int8 V is general too; a wrapper lets each through to its
    device check."""
    def meta(kind, shape):
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "i8": torch.int8}[kind.rstrip("s")]
        x = torch.empty(shape, dtype=dtype, device="meta")
        sc = (torch.empty(shape[:-1], device="meta") if kind.endswith("s")
              else None)
        return x, sc
    k, ks = meta(pair[0], (2, 5, 64, 16))
    v, vs = meta(pair[1], (2, 8, 64, 16))
    body = tck.kv_body(k, ks, v, vs)
    general = pair not in SERVED + (("i8s", "i8"),)
    assert (body == tck.KV_GENERAL) == general
    modes = tck.kv_modes(body, k, ks, v, vs)
    assert modes.get("kv") == ("/".join(pair) if general else None)
    assert bool(modes.get("int8")) == (pair in (("i8s", "i8s"),
                                                ("i8s", "i8")))
    assert (tck.kv_body(k, ks, v, vs, int8_raw_v=False)
            == tck.KV_GENERAL) == (pair not in SERVED)
    with pytest.raises(ValueError, match="CUDA"):
        tck.chai_fused_decode(
            torch.empty(2, 5, 16, device="meta"), k, v,
            torch.empty(2, 8, dtype=torch.int32, device="meta"),
            torch.empty(2, dtype=torch.int32, device="meta"),
            k_scale=ks, v_scale=vs)
