"""The port's frontend adapter (``models/frontends.py``) and the frontend
archs against the JAX package's, on the CPU.

* ``adapt``: precomputed (B, T, d) embeddings through the (d, d)
  adapter, at 1e-5.
* Reduced internvl2-76b (vision, GQA) and musicgen-large (audio, MHA),
  fp32, the reference's weights: ``forward_fullseq`` on float embeddings
  (the adapter instead of the embedding table), a prefill into a decode
  state, then ``decode_step`` with ``embeddings`` (B, d) and with tokens,
  logits at 1e-4; the step makers carry ``batch_inputs["embeddings"]``
  (the cohort prefill and the decode step), as the reference's do.
* Reduced musicgen-large: the continuous paged engine in lockstep with
  the reference's on tokens (``test_torch_lockstep``); the engines serve
  tokens only, in both packages.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import frontends as jfront
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import steps as tsteps
from repro_torch.models import frontends as tfront
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy
from test_torch_lockstep import serve_in_lockstep

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("internvl2-76b", "musicgen-large")
_MODELS = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch):
    if arch not in _MODELS:
        jcfg = jreduced(jget_config(arch), n_layers=2)
        tcfg = reduced(get_config(arch), n_layers=2)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[arch]


def test_adapt_matches_reference():
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48, 64)).astype(np.float32)
    want = jfront.adapt(jnp.asarray(emb), {"adapter": jnp.asarray(w)})
    got = tfront.adapt(_t(emb), {"adapter": _t(w)})
    assert got.shape == (2, 5, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_forward_and_decode_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    assert tcfg.frontend == jcfg.frontend != "none"
    assert tparams["frontend"]["adapter"].shape == (tcfg.d_model,) * 2
    rng = np.random.default_rng(1)
    b, t, s = 2, 10, 32
    emb = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    jl, _, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(emb))
    tl, _ = ttfm.forward_fullseq(tparams, tcfg, _t(emb))
    assert tl.shape == (b, t, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # the cohort prefill's maker on embeddings, then decode steps
    jprefill = jsteps.make_serve_prefill(jcfg, b, s)
    tprefill = tsteps.make_serve_prefill(tcfg, b, s)
    jl, js = jprefill(jparams, {"embeddings": jnp.asarray(emb)})
    tl, ts = tprefill(tparams, {"embeddings": _t(emb)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jstep = jsteps.make_serve_step(jcfg)
    tstep = tsteps.make_serve_step(tcfg)
    for i in range(3):
        e1 = rng.normal(size=(b, tcfg.d_model)).astype(np.float32)
        jl, js = jstep(jparams, {"embeddings": jnp.asarray(e1)}, js)
        tl, ts = tstep(tparams, {"embeddings": _t(e1)}, ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"embeddings step {i}")
    # tokens through the embedding table, at the model level
    tok = rng.integers(0, tcfg.vocab_size, (b,))
    jl, js = jtfm.decode_step(jparams, jcfg, jnp.asarray(tok), js)
    tl, ts = ttfm.decode_step(tparams, tcfg, _t(tok), ts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert ts["pos"].tolist() == [t + 4] * b
    for key in ("kg", "vg"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   **TOL)


def test_musicgen_paged_engine_in_lockstep_with_reference():
    jcfg, tcfg, jparams, tparams = _models("musicgen-large")
    jcfg = jcfg.with_chai(enabled=True, warmup_tokens=3)
    tcfg = tcfg.with_chai(enabled=True, warmup_tokens=3)
    assert tcfg.is_mha
    kw = dict(batch_slots=2, max_seq=64, page_size=16)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**kw))
    teng = ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    rng = np.random.default_rng(2)
    wave = [(i, rng.integers(0, tcfg.vocab_size, size=n), m)
            for i, (n, m) in enumerate(((11, 7), (17, 6), (9, 5)))]
    done, checked, n_cluster = serve_in_lockstep(jeng, teng, [wave])
    assert checked >= 12 and n_cluster == 3 and teng.paged
    assert teng.kv_bytes() == jeng.kv_bytes()
    assert teng.dense_pool.pages_in_use == teng.chai_pool.pages_in_use == 0
