"""The port's CHAI core (K-Means, membership, compaction, clustered
decode) against the JAX package, and the invariants of
``test_chai_equivalence.py`` inside the port.

Membership is held EXACTLY: the same numpy score buffer must give the
same ``h2c`` and ``reps`` in both packages. The reference runs jitted, as
its engine runs it (op-by-op execution rounds some dot products
differently, which flips exact ties between two-head clusters).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.core import kmeans as jkm
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.core import kmeans as tkm
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm


def _scores(rng, shape):
    """Warmup-like features: sums of 5 softmax rows over the window."""
    logits = rng.normal(0, 2.0, size=(5,) + shape)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).sum(0).astype(np.float32)


@pytest.mark.parametrize("n,f,k", [(8, 64, 5), (32, 256, 25)])
def test_kmeans_and_representatives_exact(rng, n, f, k):
    x = np.array(jclust.standardize(jnp.asarray(_scores(rng, (n, f)))))
    @jax.jit
    def ref(x):
        a, c, e = jkm.kmeans(x, k, 12)
        return (a, c, e) + jkm.representatives(x, a, c, k)

    ja, jc, je, jr, jv = ref(jnp.asarray(x))
    ta, tc, te = tkm.kmeans(torch.from_numpy(x), k, 12)
    tr, tv = tkm.representatives(torch.from_numpy(x), ta, tc, k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)


@pytest.mark.parametrize("arch_kw", [
    dict(n_layers=2), dict(n_layers=2, n_heads=32, d_model=128)])
def test_identify_membership_exact(rng, arch_kw):
    jcfg = jreduced(jget_config("chai-llama-7b"), **arch_kw)
    tcfg = reduced(get_config("chai-llama-7b"), **arch_kw)
    scores = _scores(rng, (jcfg.n_attn_layers, 3, jcfg.n_heads, 64))
    jctx = jax.jit(lambda sc: jclust.identify_membership(sc, jcfg))(
        jnp.asarray(scores))
    tctx = tclust.identify_membership(torch.from_numpy(scores), tcfg)
    for key in ("h2c", "reps"):
        assert tctx[key].dtype == torch.int32
        np.testing.assert_array_equal(tctx[key].numpy(),
                                      np.asarray(jctx[key]))
    assert tctx["reps"].shape[-1] == tcfg.k_max


def test_identify_membership_gqa_not_ported():
    cfg = reduced(get_config("chai-llama-7b"), n_layers=1).replace(
        n_kv_heads=4)
    with pytest.raises(NotImplementedError):
        tclust.identify_membership(torch.zeros(1, 1, 8, 16), cfg)


@pytest.mark.parametrize("batched", [True, False])
def test_compact_kv_gathers_reference_rows(rng, batched):
    jcfg = jreduced(jget_config("chai-llama-7b"), n_layers=2)
    tcfg = reduced(get_config("chai-llama-7b"), n_layers=2)
    k = jcfg.k_max
    kg = rng.normal(size=(2, 3, jcfg.n_heads, 16, jcfg.head_dim)).astype(
        np.float32)
    vg = rng.normal(size=kg.shape).astype(np.float32)
    shape = (2, 3, k) if batched else (2, k)
    reps = rng.integers(0, jcfg.n_heads, size=shape).astype(np.int32)
    jst = jcache.compact_kv({"kg": jnp.asarray(kg), "vg": jnp.asarray(vg)},
                            {"reps": jnp.asarray(reps)}, jcfg)
    tst = tcache.compact_kv({"kg": torch.from_numpy(kg),
                             "vg": torch.from_numpy(vg)},
                            {"reps": torch.from_numpy(reps)}, tcfg)
    assert "kg" not in tst and set(tst) == set(jst)
    np.testing.assert_array_equal(tst["kg_chai"].numpy(),
                                  np.asarray(jst["kg_chai"]))
    for chai in (True, False):
        assert (tcache.kv_cache_bytes(tcfg, 3, 64, chai=chai)
                == jcache.kv_cache_bytes(jcfg, 3, 64, chai=chai))


def test_init_chai_state_matches_reference_layout():
    jcfg = jreduced(jget_config("chai-llama-7b"), n_layers=2)
    tcfg = reduced(get_config("chai-llama-7b"), n_layers=2)
    jshapes, _ = jcache.chai_state_structs(jcfg, 3, 32)
    tst = tcache.init_chai_state(tcfg, 3, 32, "cpu")
    assert set(tst) == set(jshapes) and "kg" not in tst
    for key, struct in jshapes.items():
        assert tuple(tst[key].shape) == struct.shape, key
        assert str(tst[key].dtype).split(".")[-1] == str(struct.dtype), key


# ---- invariants of test_chai_equivalence.py, inside the port ----------------

def _mha_arch(counts):
    cfg = reduced(get_config("chai-llama-7b"), n_heads=8, d_model=64,
                  vocab=128, n_layers=2)
    return cfg.with_chai(enabled=True, cluster_counts=counts)


def _prefill(cfg, params, rng, b=2, s=32):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, 8)))
    _, state = tsteps.make_serve_prefill(cfg, b, s)(params,
                                                    {"tokens": toks})
    return state


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def test_chai_equals_mha_with_identity_clusters(rng):
    cfg = _mha_arch((8, 8))                                   # k == H
    b = 2
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    state = _prefill(cfg, params, rng, b=b)
    ar = torch.arange(8, dtype=torch.int32).expand(cfg.n_attn_layers, b, 8)
    ctx = {"h2c": ar, "reps": ar}
    mha_step = tsteps.make_serve_step(cfg, chai=False)
    chai_step = tsteps.make_serve_step(cfg, chai=True, decode_ts=16)
    st_c = tcache.compact_kv(_clone(state), ctx, cfg)
    st_m = _clone(state)
    for tok in ((5, 7), (1, 2), (3, 4)):
        nxt = torch.tensor(tok)
        lm, st_m = mha_step(params, {"tokens": nxt}, st_m)
        lc, st_c = chai_step(params, {"tokens": nxt}, st_c, ctx)
        np.testing.assert_allclose(lc.numpy(), lm.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_chai_exact_on_duplicated_heads(rng):
    """Heads 1..3 copy head 0's Q/K: clustering {0,1,2,3} to one rep
    reproduces MHA (their scores are identical)."""
    cfg = _mha_arch((5, 5))
    b = 2
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for nm in ("wq", "wk"):
        for hdup in (1, 2, 3):
            params["attn"][nm][:, :, hdup] = params["attn"][nm][:, :, 0]
    state = _prefill(cfg, params, rng, b=b)
    na = cfg.n_attn_layers
    h2c = torch.tensor([0, 0, 0, 0, 1, 2, 3, 4], dtype=torch.int32)
    reps = torch.tensor([0, 4, 5, 6, 7], dtype=torch.int32)
    ctx = {"h2c": h2c.expand(na, b, 8), "reps": reps.expand(na, b, 5)}
    nxt = torch.tensor([5, 7])
    lm, _ = tsteps.make_serve_step(cfg, chai=False)(
        params, {"tokens": nxt}, _clone(state))
    lc, _ = tsteps.make_serve_step(cfg, chai=True)(
        params, {"tokens": nxt}, tcache.compact_kv(_clone(state), ctx, cfg),
        ctx)
    np.testing.assert_allclose(lc.numpy(), lm.numpy(), atol=1e-5, rtol=1e-5)
