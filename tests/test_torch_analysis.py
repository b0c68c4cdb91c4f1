"""The port's paper-side analysis (``core.correlation``, ``core.elbow``,
``core.policy`` and the offline phase, ``launch.offline_clustering``)
against the JAX package's, on the CPU.

Held: correlations, elbow curves and policy outputs at 2e-5; cluster
counts, ``score_flops``, ``h2c``, pruning masks and kept tokens exactly;
``reps`` exactly but for a two-head cluster's representative (a tie that
rounding decides, ROADMAP "Two-head cluster ties"), and then the output
through the reference's membership at 2e-5. The offline phase on the
reference's ``calibration_batches``, through both packages' models on the
same weights, gives the same features (at 1e-6) and the same counts. The
``random`` policy draws from a torch generator, so its structure is held.
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
from repro.core import correlation as jcorr
from repro.core import elbow as jelbow
from repro.core import policy as jpolicy
from repro.data.pipeline import calibration_batches
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import clustering as tclust
from repro_torch.core import correlation as tcorr
from repro_torch.core import elbow as telbow
from repro_torch.core import policy as tpolicy
from repro_torch.launch import offline_clustering as toffline
from repro_torch.weights import params_from_numpy

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _planted(rng, h=16, f=64, n_pat=3, noise=0.05):
    base = rng.normal(size=(n_pat, f))
    return (base[rng.integers(0, n_pat, size=h)]
            + noise * rng.normal(size=(h, f))).astype(np.float32)


# ---------------------------------------------------------- correlation ----
@pytest.mark.parametrize("h,f", [(6, 40), (32, 256)])
def test_correlation_matches_reference(rng, h, f):
    x = rng.normal(size=(h, f)).astype(np.float32)
    jc = jcorr.head_correlation(jnp.asarray(x))
    tc = tcorr.head_correlation(_t(x))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(float(tcorr.mean_abs_offdiag(tc)),
                               float(jcorr.mean_abs_offdiag(jc)), **TOL)
    # standardized rows: |z_i - z_j|^2 == 2 (1 - corr_ij)
    z = tclust.standardize(_t(x))
    d2 = ((z[:, None] - z[None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2.numpy(), (2 * (1 - tc)).numpy(),
                               atol=1e-4)


# ---------------------------------------------------------------- elbow ----
def test_select_k_matches_reference(rng):
    ks = [1, 2, 4, 8, 16]
    cases = [[100.0, 30.0, 10.0, 9.5, 9.4], [5.0, 4.0, 3.0, 2.0, 1.0],
             [1.0, 1.0, 1.0, 1.0, 1.0]] + [
        list(np.sort(rng.random(5))[::-1]) for _ in range(20)]
    for errs in cases:
        for tol in (0.01, 0.05, 0.2):
            assert telbow.select_k(errs, ks, tol) == \
                jelbow.select_k(errs, ks, tol)
    assert telbow.select_k(cases[0], ks) == 4


def test_elbow_and_offline_counts_match_reference():
    rng = np.random.default_rng(1)
    layers = [_planted(rng, h=8, f=32, n_pat=n) for n in (2, 4)]
    ks = list(range(1, 9))
    z = jclust.standardize(jnp.asarray(layers[1]))
    np.testing.assert_allclose(telbow.elbow_curve(_t(z), ks),
                               jelbow.elbow_curve(z, ks), **TOL)
    # batched over layers: each layer's curve is its own
    curves = telbow.elbow_curve(torch.stack([_t(f) for f in layers]), ks)
    for f, c in zip(layers, curves):
        np.testing.assert_array_equal(c, telbow.elbow_curve(_t(f), ks))
    assert telbow.offline_cluster_counts([_t(f) for f in layers], 8) == \
        jelbow.offline_cluster_counts([jnp.asarray(f) for f in layers], 8)


@pytest.fixture(scope="module")
def calibration():
    """The reference's offline phase (``examples/offline_clustering.py``)
    on a reduced chai-llama-7b (2 layers, 8 heads): features per layer,
    standardized elbow curves and counts; the weights and batches."""
    jcfg = jreduced(jget_config("chai-llama-7b"), n_heads=8,
                    n_layers=2).replace(dtype="float32")
    tcfg = reduced(get_config("chai-llama-7b"), n_heads=8, n_layers=2)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    batches = list(calibration_batches(jcfg.vocab_size, 24, n_samples=16))
    prefill = jax.jit(lambda p, t, s: jtfm.forward_fullseq(p, jcfg, t,
                                                           state=s)[1])
    decode = jax.jit(lambda p, t, s: jtfm.decode_step(p, jcfg, t, s))
    feats, n = None, 0
    for toks in batches:
        toks = jnp.asarray(toks)
        state = prefill(jparams, toks,
                        jtfm.init_decode_state(jcfg, toks.shape[0], 64))
        state = jcache.add_score_buffer(state, jcfg, toks.shape[0])
        nxt = toks[:, -1]
        for _ in range(jcfg.chai.warmup_tokens):
            logits, state = decode(jparams, nxt, state)
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        _, scores = jcache.pop_score_buffer(state)
        s = np.asarray(scores).sum(axis=1)
        feats = s if feats is None else feats + s
        n += scores.shape[1]
    feats = (feats / n).astype(np.float32)
    ks = list(range(1, jcfg.n_heads + 1))
    curves = [jelbow.elbow_curve(jclust.standardize(jnp.asarray(f)), ks)
              for f in feats]
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return dict(tcfg=tcfg, tparams=tparams, batches=batches, feats=feats,
                curves=np.array(curves),
                counts=[jelbow.select_k(c, ks) for c in curves])


def test_offline_phase_matches_reference(calibration):
    c = calibration
    out = toffline.offline_phase(c["tparams"], c["tcfg"], c["batches"],
                                 device="cpu")
    np.testing.assert_allclose(out["features"].numpy(), c["feats"],
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(out["curves"], c["curves"], **TOL)
    assert out["counts"] == c["counts"]
    # on the reference's own features: the same counts, and the same as
    # the reference's offline_cluster_counts on the raw features
    same = toffline.elbow_analysis(_t(c["feats"]))
    assert same["counts"] == c["counts"]
    assert telbow.offline_cluster_counts(_t(c["feats"]), 8) == \
        jelbow.offline_cluster_counts(list(jnp.asarray(c["feats"])), 8)
    for f, off in zip(c["feats"], out["offdiag"]):
        want = float(jcorr.mean_abs_offdiag(
            jcorr.head_correlation(jnp.asarray(f))))
        np.testing.assert_allclose(off, want, **TOL)


def test_offline_entry_runs(capsys):
    assert toffline.main(["--reduced", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "cluster_counts = (" in out and "frozen counts" in out


# --------------------------------------------------------------- policy ----
def _qkv(rng, b=2, t=16, h=8, hd=16):
    return [rng.normal(size=(b, t, h, hd)).astype(np.float32)
            for _ in range(3)]


def _both(policy, q, k, v, **kw):
    j = jpolicy.apply_policy(policy, *map(jnp.asarray, (q, k, v)), **kw)
    t = tpolicy.apply_policy(policy, *map(_t, (q, k, v)), **kw)
    return j, t


@pytest.mark.parametrize("shape", [(2, 16, 8, 16), (1, 64, 32, 16)],
                         ids=["b2h8", "b1h32"])
@pytest.mark.parametrize("policy", [p for p in tpolicy.POLICIES
                                    if p != "random"])
def test_policy_matches_reference(policy, shape):
    rng = np.random.default_rng(sum(shape))
    q, k, v = _qkv(rng, *shape)
    h = shape[2]
    kw = dict(n_clusters=4)
    if policy == "chai-static":
        kw.update(h2c_static=np.arange(h) % 4, reps_static=np.arange(4))
    j, t = _both(policy, q, k, v, **kw)
    assert t.out.shape == q.shape and t.out.dtype == torch.float32
    assert float(t.score_flops) == float(j.score_flops)
    assert sorted(t.info) == sorted(j.info)
    for key in ("pruned", "kept_tokens"):
        if key in j.info:
            np.testing.assert_array_equal(t.info[key].numpy(),
                                          np.asarray(j.info[key]))
    if "h2c" not in j.info:
        np.testing.assert_allclose(t.out.numpy(), np.asarray(j.out), **TOL)
        return
    jh2c, jreps = np.asarray(j.info["h2c"]), np.asarray(j.info["reps"])
    np.testing.assert_array_equal(t.info["h2c"].numpy(), jh2c)
    treps = t.info["reps"].numpy()
    for bi, ci in zip(*np.nonzero(treps != jreps)):
        members = set(np.flatnonzero(jh2c[bi] == ci).tolist())
        assert members == {int(treps[bi, ci]), int(jreps[bi, ci])}
    if (treps == jreps).all():
        np.testing.assert_allclose(t.out.numpy(), np.asarray(j.out), **TOL)
    else:
        # through the reference's membership: the same output
        static = tpolicy.apply_policy(
            "chai-static", *map(_t, (q, k, v)), n_clusters=4,
            h2c_static=_t(jh2c), reps_static=_t(jreps))
        if policy == "chai":
            np.testing.assert_allclose(static.out.numpy(),
                                       np.asarray(j.out), **TOL)


def test_chai_policies_recover_planted_structure(rng):
    """k == H: clustering is a permutation, so CHAI is MHA; heads sharing
    Q and K cluster together losslessly and cost fewer score flops."""
    q, k, v = _qkv(rng, h=4)
    mha = tpolicy.apply_policy("mha", *map(_t, (q, k, v)))
    chai = tpolicy.apply_policy("chai", *map(_t, (q, k, v)), n_clusters=4)
    np.testing.assert_allclose(chai.out.numpy(), mha.out.numpy(), atol=1e-5)
    q, k, v = _qkv(rng)
    q[:, :, 1:4], k[:, :, 1:4] = q[:, :, :1], k[:, :, :1]
    q[:, :, 5:], k[:, :, 5:] = q[:, :, 4:5], k[:, :, 4:5]
    mha = tpolicy.apply_policy("mha", *map(_t, (q, k, v)))
    chai = tpolicy.apply_policy("chai", *map(_t, (q, k, v)), n_clusters=2)
    np.testing.assert_allclose(chai.out.numpy(), mha.out.numpy(), atol=1e-5)
    assert float(chai.score_flops) < float(mha.score_flops)
    qkv = tpolicy.apply_policy("chai-qkv", *map(_t, (q, k, v)), n_clusters=3)
    assert not np.allclose(qkv.out.numpy(), tpolicy.apply_policy(
        "chai", *map(_t, (q, k, v)), n_clusters=3).out.numpy())


def test_random_policy_structure(rng):
    """The random policy: the first kk heads pinned to clusters 0..kk-1,
    every head in range, the reps the first kk heads, the draw fixed by
    the generator, and the output that of chai-static on its membership;
    the reference's score flops."""
    q, k, v = _qkv(rng, h=16)
    kk = 5
    outs = [tpolicy.apply_policy(
        "random", *map(_t, (q, k, v)), n_clusters=kk,
        generator=torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    h2c, reps = outs[0].info["h2c"], outs[0].info["reps"]
    assert h2c.shape == (2, 16) and reps.shape == (2, kk)
    assert (h2c[:, :kk] == torch.arange(kk)).all()
    assert ((h2c >= 0) & (h2c < kk)).all() and (h2c[0] == h2c[1]).all()
    assert (reps == torch.arange(kk)).all()
    assert torch.equal(outs[0].out, outs[1].out)
    assert not torch.equal(outs[0].info["h2c"], outs[2].info["h2c"])
    static = tpolicy.apply_policy("chai-static", *map(_t, (q, k, v)),
                                  n_clusters=kk, h2c_static=h2c[0],
                                  reps_static=reps[0])
    torch.testing.assert_close(outs[0].out, static.out, atol=0, rtol=0)
    j = jpolicy.apply_policy("random", *map(jnp.asarray, (q, k, v)),
                             n_clusters=kk)
    assert float(outs[0].score_flops) == float(j.score_flops)
    with pytest.raises(ValueError, match="unknown policy"):
        tpolicy.apply_policy("nope", *map(_t, (q, k, v)))
