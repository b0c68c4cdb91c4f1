"""The last public names of the JAX package the port had not copied,
each against the reference's on the same numpy inputs, on the CPU:
``core.clustering.membership_churn`` (the paper's Fig. 9 metric),
``models.attention.decode_attention`` (one-token decode over a ring-aware
cache, GQA, a window and the softcap) and the oracles
``kernels.ref.chai_scores_i8_ref``, ``chai_decode_ref``,
``paged_chai_scores_ref`` and ``paged_chai_decode_ref`` (GQA, two reps
a KV group; the paged forms on shuffled pages). Exact for the churn,
atol = rtol = 1e-5 elsewhere (whole-row softmax in both packages)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.core import clustering as tclust
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _churn(rng):
    out = []
    for key, shape in (("h2c", (2, 3, 8)), ("cluster_of", (2, 3, 4, 2))):
        a = rng.integers(0, 4, size=shape).astype(np.int32)
        b = np.where(rng.random(shape) < 0.3, (a + 1) % 4, a).astype(
            np.int32)
        want = jclust.membership_churn({key: jnp.asarray(a)},
                                       {key: jnp.asarray(b)})
        got = tclust.membership_churn({key: _t(a)}, {key: _t(b)})
        assert got.dtype == torch.float32 and got.ndim == 0
        out.append((got, want))
    return out


def _decode_attention(rng):
    b, h, kv, s, hd, size = 2, 8, 2, 16, 16, 16
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    out = []
    for pos, window, cap in ((9, 0, 0.0), (21, 8, 0.0), (21, 0, 5.0)):
        kv_pos = np.asarray(jattn.ring_positions(pos, size))
        want = jattn.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                      jnp.asarray(kv_pos), pos,
                                      window=window, attn_softcap=cap)
        got = tattn.decode_attention(_t(q), _t(k), _t(v), _t(kv_pos), pos,
                                     window=window, attn_softcap=cap)
        out.append((got, want))
    return out


def _clustered(rng):
    """GQA: 4 reps over 2 KV rows (2 a row), 8 heads, S 32, page 8."""
    b, r, kv, h, s, hd, page = 2, 4, 2, 8, 32, 16, 8
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    h2c = rng.integers(0, r, size=(b, h)).astype(np.int32)
    pos = np.array([13, 31], np.int32)
    n = s // page
    n_pool = 2 * b * n + 1
    ids = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    bt_k, bt_v = ids[:b * n].reshape(b, n), ids[b * n:2 * b * n].reshape(b,
                                                                        n)
    k_pool = rng.normal(size=(n_pool, kv, page, hd)).astype(np.float32)
    v_pool = rng.normal(size=(n_pool, h, page, hd)).astype(np.float32)
    k_pool[bt_k] = k.reshape(b, kv, n, page, hd).transpose(0, 2, 1, 3, 4)
    v_pool[bt_v] = v.reshape(b, h, n, page, hd).transpose(0, 2, 1, 3, 4)
    return q, k, v, h2c, pos, k_pool, bt_k, v_pool, bt_v


def _oracles(name):
    def run(rng):
        q, k, v, h2c, pos, k_pool, bt_k, v_pool, bt_v = _clustered(rng)
        if name == "chai_scores_i8_ref":
            codes, scale = (np.array(x) for x in
                            jcache.quant_rows(jnp.asarray(k)))
            args = (q, codes, scale, pos)
        else:
            args = {"chai_decode_ref": (q, k, v, h2c, pos),
                    "paged_chai_scores_ref": (q, k_pool, bt_k, pos),
                    "paged_chai_decode_ref": (q, k_pool, bt_k, v_pool, bt_v,
                                              h2c, pos)}[name]
        want = getattr(jref, name)(*(jnp.asarray(a) for a in args),
                                   reps_per_group=2)
        got = getattr(tref, name)(*(_t(a) for a in args), reps_per_group=2)
        return [(got, want)]
    return run


CASES = {"membership_churn": _churn, "decode_attention": _decode_attention,
         **{n: _oracles(n) for n in ("chai_scores_i8_ref", "chai_decode_ref",
                                     "paged_chai_scores_ref",
                                     "paged_chai_decode_ref")}}


@pytest.mark.parametrize("name", list(CASES))
def test_port_matches_reference(rng, name):
    for got, want in CASES[name](rng):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        if name == "membership_churn":
            assert got.item() == want.item()
        else:
            np.testing.assert_allclose(got.numpy(), want, **TOL)
