"""The port's recurrent archs against the JAX package's, on the CPU: the
model (``forward_fullseq`` and ``decode_step``) and both engines.

Reduced recurrentgemma-9b (layers rglru, rglru, attn_local, rglru; 8
heads over 1 KV head, head_dim 8, rnn 64, window 8 so the ring wraps)
and reduced rwkv6-1.6b (4 RWKV layers, d 64, head dim 16), fp32, the
reference's own ``init_params`` weights through ``params_from_numpy``.

* The model: a prefill then 4 decode steps, exact-length and bucketed
  (``valid_len``, rows of 32 and 10 real tokens in a 32-token bucket),
  logits at 1e-4 and every state leaf at ``STATE_TOL``. The bucketed
  prefill runs its padding through the recurrence as the reference's
  does, so the port reproduces the reference's padded state, and that
  state is the one an exact prefill of the whole bucket leaves (not the
  real tokens' own). CHAI on recurrentgemma's local layers, teacher-
  forced: the WARMUP score buffer, the membership (exact) and STEADY
  steps through the clustered attention.
* The engines in lockstep with the reference's (its token each step, its
  membership each CLUSTER): recurrentgemma on the cohort and the
  continuous engine with CHAI on and with the MHA baseline, rwkv on both
  without CHAI; logits of every live row at 1e-4, greedy tokens on
  margin-checked steps, ``kv_bytes()`` equal (recurrent state is not KV).
  The two schedulers pad a prompt to different buckets (the cohort to its
  longest prompt's, the continuous engine to its own), and on these archs
  the padding reaches the recurrent state, so the two are not held equal
  to each other.
* The engine settings as the reference's: neither arch has a global
  layer, so the paged layout turns itself off; the prefix cache then
  raises the reference's message, chunked prefill is ignored, and CHAI on
  rwkv (no attention layer) raises.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy
from test_torch_lockstep import serve_in_lockstep

RG, RWKV = "recurrentgemma-9b", "rwkv6-1.6b"
PROMPT_LENS = (11, 6, 14)
BUDGETS = (9, 4, 8)
TOL = dict(atol=1e-4, rtol=1e-4)
# The RWKV state is a sum of products whose factored decays reach
# exp(+-48) inside a chunk; its fp32 rounding differs between the
# packages by a few 1e-5 at values of order 10.
STATE_TOL = dict(atol=2e-4, rtol=1e-4)
FEATURE_TOL = dict(atol=1e-5, rtol=1e-4)
RECURRENT_KEYS = ("rg_h", "rg_conv", "rwkv_wkv", "rwkv_shift", "rwkv_cshift")


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreduced(jget_config(arch), window=8)
    tcfg = reduced(get_config(arch), window=8)
    assert tcfg.layer_types == jcfg.layer_types
    if arch == RG:
        assert tcfg.layer_types == ("rglru", "rglru", "attn_local", "rglru")
        assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.rnn_width) == (8, 1, 64)
    else:
        assert (tcfg.n_layers, tcfg.d_model, tcfg.rwkv_head_dim) == (4, 64, 16)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return arch, jcfg, tcfg, jparams, tparams


@functools.lru_cache(maxsize=None)
def _jstep(arch):
    """The reference's decode step for ``arch``, jitted once."""
    jcfg = _models(arch)[1]
    return jax.jit(lambda p, tok, st, ctx: jtfm.decode_step(
        p, jcfg, tok, st, chai_ctx=ctx))


def _hold_state(ts, js, keys=None):
    assert set(ts) == set(js)
    for key in keys or ts:
        assert ts[key].dtype == getattr(torch, str(js[key].dtype)), key
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   **STATE_TOL, err_msg=key)


# ------------------------------------------------------------ the model ----
@pytest.mark.parametrize("mode", ["exact", "bucket"])
@pytest.mark.parametrize("arch", [RG, RWKV])
def test_prefill_and_decode_match_reference(arch, mode):
    """A prefill of 2 rows then 4 teacher-forced decode steps, both
    packages: logits at 1e-4, every state leaf (the recurrent state, the
    rings, ``pos``) after the prefill and after every step. Bucketed:
    rows of 32 and 10 real tokens right-padded to 32."""
    arch, jcfg, tcfg, jparams, tparams = _models(arch)
    b, t, s = 2, 32, 64
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (b, t))
    nxt = rng.integers(0, jcfg.vocab_size, (4, b))
    jvl = tvl = None
    if mode == "bucket":
        lens = np.array([32, 10], np.int32)
        toks[1, 10:] = 0
        jvl, tvl = jnp.asarray(lens), _t(lens)
    js = jtfm.init_decode_state(jcfg, b, s)
    jl, js, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                     state=js, logits_slice="last",
                                     valid_len=jvl)
    ts = ttfm.init_decode_state(tcfg, b, s, "cpu")
    tl, ts = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=ts,
                                  logits_slice="last", valid_len=tvl)
    assert any(k in ts for k in RECURRENT_KEYS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _hold_state(ts, js)
    for i in range(4):
        jl, js = _jstep(arch)(jparams, jnp.asarray(nxt[i]), js, None)
        tl, ts = ttfm.decode_step(tparams, tcfg, _t(nxt[i]), ts)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        _hold_state(ts, js)


def test_chai_decode_matches_reference():
    """recurrentgemma with CHAI on its local MQA layers, teacher-forced in
    both packages: a prefill, the WARMUP steps filling the score buffer
    (held at ``FEATURE_TOL``), the membership identified from the
    reference's buffer (the port's equal to the reference's, exactly),
    then 3 STEADY steps through the clustered attention; logits at 1e-4
    and every state leaf at ``STATE_TOL`` after every step."""
    _, jcfg, tcfg, jparams, tparams = _models(RG)
    b, t, s = 2, 32, 64
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab_size, (b, t))
    warm = jcfg.chai.warmup_tokens
    nxt = rng.integers(0, jcfg.vocab_size, (warm + 3, b))
    js = jtfm.init_decode_state(jcfg, b, s)
    _, js, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                    state=js, logits_slice="last")
    ts = ttfm.init_decode_state(tcfg, b, s, "cpu")
    _, ts = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=ts,
                                 logits_slice="last")
    js = jcache.add_score_buffer(js, jcfg, b)
    ts = tcache.add_score_buffer(ts, tcfg, b)
    jctx = tctx = None
    for i in range(warm + 3):
        if i == warm:
            js, jsc = jcache.pop_score_buffer(js)
            ts, tsc = tcache.pop_score_buffer(ts)
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       **FEATURE_TOL)
            jctx = jclust.identify_membership(jsc, jcfg)
            tctx = tclust.identify_membership(_t(jsc), tcfg)
            for key in jctx:
                np.testing.assert_array_equal(tctx[key].numpy(),
                                              np.asarray(jctx[key]))
        jl, js = _jstep(RG)(jparams, jnp.asarray(nxt[i]), js, jctx)
        tl, ts = ttfm.decode_step(tparams, tcfg, _t(nxt[i]), ts,
                                  chai_ctx=tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"step {i}")
        _hold_state(ts, js)


@pytest.mark.parametrize("arch", [RG, RWKV])
def test_bucketed_state_is_the_padded_sequences(arch):
    """The reference's padded recurrence, mirrored: after a bucketed
    prefill (10 real tokens in a bucket of 32) the recurrent state equals
    an exact prefill of all 32 bucket tokens, padding included, and
    differs from an exact prefill of the 10 real tokens; the last real
    token's logits are the real prefill's either way."""
    _, _, tcfg, _, tparams = _models(arch)
    rng = np.random.default_rng(4)
    real = rng.integers(0, tcfg.vocab_size, (1, 10))
    padded = np.zeros((1, 32), np.int64)
    padded[:, :10] = real
    runs = {}
    for name, toks, vl in (("bucket", padded, torch.tensor([10])),
                           ("whole", padded, None), ("real", real, None)):
        st = ttfm.init_decode_state(tcfg, 1, 64, "cpu")
        lg, st = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=st,
                                      logits_slice="last", valid_len=vl)
        runs[name] = lg, st
    keys = [k for k in RECURRENT_KEYS if k in runs["bucket"][1]]
    for key in keys:
        torch.testing.assert_close(runs["bucket"][1][key],
                                   runs["whole"][1][key], rtol=0, atol=0)
        assert not torch.allclose(runs["bucket"][1][key],
                                  runs["real"][1][key], atol=1e-3), key
    torch.testing.assert_close(runs["bucket"][0], runs["real"][0],
                               atol=1e-4, rtol=1e-4)
    assert int(runs["bucket"][1]["pos"][0]) == 10


# ---------------------------------------------------------- the engines ----
def _engine_cfg(ekw):
    return {"batch_slots": 2, "max_seq": 64, "page_size": 16, **ekw}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n) for n in PROMPT_LENS]


LOCKSTEP = {
    "rg-cohort-chai": (RG, dict(scheduler="cohort")),
    "rg-continuous-chai": (RG, dict()),
    "rg-cohort-mha": (RG, dict(scheduler="cohort", use_chai=False)),
    "rg-continuous-mha": (RG, dict(use_chai=False)),
    "rwkv-cohort": (RWKV, dict(scheduler="cohort", use_chai=False)),
    "rwkv-continuous": (RWKV, dict(use_chai=False)),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_engines_in_lockstep_with_reference(case):
    """Each engine on each arch (the continuous one on its default
    setting, ``kv_layout="paged"``, which without a global layer is the
    unified layout in both packages), the reference's tokens and
    memberships replayed on the port (``test_torch_lockstep``): tokens
    equal, logits of live rows at 1e-4, greedy picks on margins; the
    CLUSTER count, ``kv_bytes()`` (the rings only) and the recurrent
    state's dtype as the reference's. A FREE slot's recurrent state
    advances with every batched step in both packages and is overwritten
    at admission, so only live rows are held."""
    arch, ekw = LOCKSTEP[case]
    _, jcfg, tcfg, jparams, tparams = _models(arch)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**_engine_cfg(ekw)))
    teng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(ekw)),
                         device="cpu")
    wave = [(i, p, m) for i, (p, m) in enumerate(zip(
        _prompts(jcfg.vocab_size), BUDGETS))]
    done, n_tok, n_cluster = serve_in_lockstep(jeng, teng, [wave])
    chai = ekw.get("use_chai", True)
    assert teng.chai_on == jeng.chai_on == chai
    assert [len(done[u]) for u in range(len(BUDGETS))] == list(BUDGETS)
    assert n_cluster == (2 if chai else 0)
    assert n_tok >= 10, n_tok
    assert teng.paged is False and jeng.paged is False
    assert teng.kv_bytes() == jeng.kv_bytes()
    if ekw.get("scheduler") != "cohort":
        state = teng._dev_state
        assert all(state[k].dtype == torch.float32
                   for k in RECURRENT_KEYS if k in state)


# ------------------------------------------------------ engine settings ----
SETTINGS = {"prefix_cache": dict(prefix_cache=True),
            "chunked": dict(prefill_chunk_tokens=16),
            "chai_on_rwkv": dict(use_chai=True)}


@pytest.mark.parametrize("name", list(SETTINGS))
@pytest.mark.parametrize("arch", [RG, RWKV])
def test_engine_settings_as_reference(arch, name):
    """Neither arch has a global layer, so the continuous engine's paged
    layout turns itself off in both packages. Then the prefix cache
    raises the reference's "requires the paged KV layout" message,
    ``prefill_chunk_tokens`` is ignored (the chunked engine serves the
    monolithic one's tokens), and CHAI on rwkv, which has no attention
    layer, raises in both (the reference asserts, the port raises a
    ``ValueError``; recurrentgemma serves CHAI on its local layers)."""
    _, jcfg, tcfg, jparams, tparams = _models(arch)
    kw = dict(SETTINGS[name])
    if arch == RWKV and name != "chai_on_rwkv":
        kw["use_chai"] = False
    errs = []
    for make in (lambda: JServingEngine(jcfg, jparams,
                                        JEngineConfig(**_engine_cfg(kw))),
                 lambda: ServingEngine(tcfg, tparams,
                                       EngineConfig(**_engine_cfg(kw)),
                                       device="cpu")):
        try:
            eng = make()
        except (AssertionError, ValueError) as e:
            errs.append(str(e))
            continue
        errs.append(None)
        assert eng.paged is False
    if name == "prefix_cache":
        assert errs[0] == errs[1]
        assert "requires the paged KV layout" in errs[1]
    elif name == "chai_on_rwkv":
        want = "CHAI needs attention layers" if arch == RWKV else None
        assert errs == [want, want]
        if arch == RG:
            eng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(
                kw)), device="cpu")
            assert eng.chai_on
        return
    else:
        assert errs == [None, None]
        out = []
        for ekw in (kw, {k: v for k, v in kw.items()
                         if k != "prefill_chunk_tokens"}):
            eng = ServingEngine(tcfg, tparams, EngineConfig(**_engine_cfg(
                ekw)), device="cpu")
            assert eng._chunk == 0
            for i, p in enumerate(_prompts(tcfg.vocab_size)[:2]):
                eng.submit(p, max_new_tokens=3, uid=i)
            out.append({r.uid: r.generated for r in eng.run()})
        assert out[0] == out[1]
