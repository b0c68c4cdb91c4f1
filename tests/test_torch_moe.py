"""The port's MoE FFN (``models/moe.py``) and the MoE archs against the JAX
package's, on the CPU.

* ``moe_ffn_ragged`` (dropless) and ``moe_ffn`` (capacity, with its
  load-balance and router-z losses) on reduced deepseek-moe-16b (8
  experts top-2 and 2 shared experts) and qwen3-moe-30b-a3b (8 experts
  top-2, no shared expert), fp32, the same seeded numpy inputs and the
  reference's weights, at 1e-5. One case routes every token's first
  choice to one expert, so (token, choice) rows pass the capacity of 8:
  the test asserts the overflow and that the dropped rows' gates are
  zero. One case is a right-padded two-example cohort: the capacity
  order is the flattened (token, choice) order over both examples, so
  example 0's padding rows take capacity before example 1's real tokens,
  and example 1 alone routes otherwise.
* Exact ties of router probabilities go to the lower expert index, as
  ``lax.top_k`` breaks them.
* Reduced deepseek-moe-16b (a dense layer, then MoE; MHA): ``forward_fullseq``
  in both forms and ``decode_step`` against the reference at 1e-4; then
  the continuous paged engine with the prefix cache, chunked prefill (16
  tokens) and relay decode on, in lockstep with the reference's
  (``test_torch_lockstep``): hits, chunks and relay steps equal.
* Reduced qwen3-moe-30b-a3b (GQA, qk_norm, MoE only): the continuous paged
  engine in lockstep.
* ``moe_impl``: every step maker's default is the reference's, and a
  served run calls the capacity form on prefills and all-STEADY steps and
  the ragged form on mixed steps.
"""
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy
from test_torch_lockstep import serve_in_lockstep

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
DEEPSEEK, QWEN3 = "deepseek-moe-16b", "qwen3-moe-30b-a3b"
_MODELS = {}


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, **red):
    """Reduced configs of both packages, the reference's weights and the
    same weights in the port; built once per module."""
    key = (arch, tuple(sorted(red.items())))
    if key not in _MODELS:
        jcfg = jreduced(jget_config(arch), **red).with_chai(
            enabled=True, warmup_tokens=3)
        tcfg = reduced(get_config(arch), **red).with_chai(
            enabled=True, warmup_tokens=3)
        jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                    device="cpu")
        _MODELS[key] = (jcfg, tcfg, jparams, tparams)
    return _MODELS[key]


def _layer(params, group, i=0):
    return {k: v[i] for k, v in params[group].items()}


def _both_moe(arch, x, *, router_bias=None):
    """Both packages' ragged and capacity forms on x (B, T, d) with MoE
    layer 0's weights (``router_bias``: added to the router's column of
    that expert, to steer the routing). Returns the port's outputs."""
    jcfg, tcfg, jparams, tparams = _models(arch, n_layers=2, vocab=64)
    jp = jax.tree.map(np.asarray, _layer(jparams, "moe"))
    if router_bias is not None:
        jp = dict(jp, router=jp["router"] + router_bias)
    tp = {k: _t(v) for k, v in jp.items()}
    jp = {k: jnp.asarray(v) for k, v in jp.items()}
    want_r = jmoe.moe_ffn_ragged(jnp.asarray(x), jp, jcfg)
    got_r = tmoe.moe_ffn_ragged(_t(x), tp, tcfg)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    want_c, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, return_aux=True)
    got_c, taux = tmoe.moe_ffn(_t(x), tp, tcfg, return_aux=True)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   **TOL)
    assert torch.equal(tmoe.moe_ffn(_t(x), tp, tcfg), got_c)
    return tcfg, tp, got_r, got_c


def _drops(tcfg, tp, x):
    """(token, choice) rows past their expert's capacity, from the port's
    router and ``expert_capacity``: the flattened priority order."""
    n = x.shape[0] * x.shape[1]
    _, _, _, ids = tmoe.route(_t(x).reshape(n, -1), tp["router"],
                              tcfg.top_k)
    cap = tmoe.expert_capacity(n, tcfg)
    seen, dropped = {}, []
    for r, e in enumerate(ids.reshape(-1).tolist()):
        seen[e] = seen.get(e, 0) + 1
        if seen[e] > cap:
            dropped.append(r)
    return dropped


@pytest.mark.parametrize("arch", [DEEPSEEK, QWEN3])
def test_moe_forms_match_reference(arch):
    x = np.random.default_rng(0).normal(size=(2, 6, 64)).astype(np.float32)
    tcfg, tp, ragged, capacity = _both_moe(arch, x)
    assert tcfg.n_experts == 8 and tcfg.top_k == 2
    assert (tcfg.n_shared_experts > 0) == (arch == DEEPSEEK)
    # 12 tokens, capacity 8: this routing drops nothing, so the forms agree
    assert not _drops(tcfg, tp, x)
    np.testing.assert_allclose(capacity.numpy(), ragged.numpy(), **TOL)


@pytest.mark.parametrize("arch", [DEEPSEEK, QWEN3])
def test_capacity_overflow_matches_reference(arch):
    """Every first choice steered to expert 3 (a feature every token
    carries, which expert 3's router column weighs): 20 tokens, capacity
    8, so 12 rows overflow; their gates are zeroed and the two forms
    differ."""
    x = np.random.default_rng(1).normal(size=(2, 10, 64)).astype(np.float32)
    x[..., 0] = 5.0
    bias = np.zeros((64, 8), np.float32)
    bias[0, 3] = 3.0
    tcfg, tp, ragged, capacity = _both_moe(arch, x, router_bias=bias)
    dropped = _drops(tcfg, tp, x)
    assert tmoe.expert_capacity(20, tcfg) == 8
    assert len(dropped) >= 12, dropped
    assert not torch.allclose(capacity, ragged, atol=1e-4)


def test_padded_cohort_takes_capacity_in_token_order():
    """A right-padded cohort of two examples (example 0's rows 6..9 are
    padding, a repeated token's hidden state): the priority runs over
    both examples' rows in order, so example 0's ten rows take expert 5's
    capacity of 8 before example 1's six, which routed alone keeps them
    all."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32)
    x[0, 6:] = x[0, 5]
    x[0, :, 0] = 5.0
    x[1, :6, 0] = 5.0
    bias = np.zeros((64, 8), np.float32)
    bias[0, 5] = 3.0
    tcfg, tp, _, cohort = _both_moe(DEEPSEEK, x, router_bias=bias)
    _, _, _, alone = _both_moe(DEEPSEEK, x[1:], router_bias=bias)
    assert _drops(tcfg, tp, x) and not _drops(tcfg, tp, x[1:])
    assert not torch.allclose(cohort[1], alone[0], atol=1e-4)


def test_router_ties_go_to_the_lower_expert():
    """Equal probabilities: the top k are the lowest expert indices, in
    order, as ``lax.top_k`` returns them."""
    probs_logits = torch.zeros(3, 8)
    probs_logits[1, [6, 2, 4]] = 1.0
    eye = torch.eye(8)
    _, _, gate, ids = tmoe.route(probs_logits, eye, 2)
    j = jax.lax.top_k(jax.nn.softmax(jnp.asarray(probs_logits.numpy())), 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j[1]))
    assert ids.tolist() == [[0, 1], [2, 4], [0, 1]]
    np.testing.assert_allclose(gate.numpy(), 0.5)


# -------------------------------------------------- deepseek, the model ----
def test_deepseek_forward_and_decode_match_reference():
    jcfg, tcfg, jparams, tparams = _models(DEEPSEEK, n_layers=2, vocab=64)
    assert tcfg.ffn_types == ("dense", "moe") == jcfg.ffn_types
    plan = ttfm.layer_plan(tcfg)
    assert plan["dense"] == [0, None] and plan["moe"] == [None, 0]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12))
    for impl in ("capacity", "ragged", "ep"):   # "ep" with no mesh: capacity
        jl, _, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                        moe_impl=impl)
        tl, _ = ttfm.forward_fullseq(tparams, tcfg, _t(toks), moe_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    js = jtfm.init_decode_state(jcfg, 2, 32)
    ts = ttfm.init_decode_state(tcfg, 2, 32, "cpu")
    _, js, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                    state=js, logits_slice="last")
    _, ts = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=ts,
                                 logits_slice="last")
    for step in range(3):
        nt = rng.integers(0, tcfg.vocab_size, (2,))
        impl = ("ragged", "capacity")[step % 2]
        jl, js = jtfm.decode_step(jparams, jcfg, jnp.asarray(nt), js,
                                  moe_impl=impl)
        tl, ts = ttfm.decode_step(tparams, tcfg, _t(nt), ts, moe_impl=impl)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # "ep" without a mesh context: the capacity form, as in the reference
    jl, js = jtfm.decode_step(jparams, jcfg, jnp.asarray(nt), js,
                              moe_impl="ep")
    tl, ts = ttfm.decode_step(tparams, tcfg, _t(nt), ts, moe_impl="ep")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


# ------------------------------------------------------ the engines ----
PAGE = 16


def _prefix_waves(vocab):
    """A 32-token prefix warmed by a request that retires in WARMUP, then
    two partial hits (one with a 20-token suffix, prefilled in two
    chunks), which decode side by side over the shared prefix (a relay
    group), and request 1's prompt again (a snapshot hit)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, size=2 * PAGE).tolist()
    s = [rng.integers(0, vocab, size=n).tolist() for n in (4, 20)]
    return [[(0, prefix + [1], 4)],
            [(1, prefix + s[0], 7), (2, prefix + s[1], 6),
             (3, prefix + s[0], 6)]]


def _hits(eng):
    return {r.uid: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for r in eng.done}


def test_deepseek_prefix_chunks_relay_in_lockstep_with_reference():
    jcfg, tcfg, jparams, tparams = _models(DEEPSEEK, n_layers=2, vocab=64)
    assert tcfg.is_mha
    kw = dict(batch_slots=2, max_seq=64, page_size=PAGE, num_pages=33,
              num_chai_pages=25, prefix_cache=True, prefill_chunk_tokens=16,
              relay_decode=True)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**kw))
    teng = ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    done, checked, n_cluster = serve_in_lockstep(
        jeng, teng, _prefix_waves(tcfg.vocab_size))
    assert [len(done[u]) for u in range(4)] == [4, 7, 6, 6]
    assert checked >= 15 and n_cluster >= 2
    assert _hits(teng) == _hits(jeng)
    assert [_hits(teng)[u][0] for u in range(4)] == ["", "prefix", "prefix",
                                                     "snapshot"]
    assert _hits(teng)[2][2] == 20        # the suffix, in two chunks
    assert teng.relay_steps == jeng.relay_steps > 0
    assert teng.prefix_stats()["tokens_reused"] == \
        jeng.prefix_stats()["tokens_reused"] > 0
    for eng in (teng, jeng):
        eng.prefix_cache.clear()
        assert eng.dense_pool.pages_in_use == 0


def test_qwen3_paged_engine_in_lockstep_with_reference():
    jcfg, tcfg, jparams, tparams = _models(QWEN3, n_layers=2, vocab=64)
    assert not tcfg.is_mha and tcfg.qk_norm and tcfg.n_dense_ffn == 0
    kw = dict(batch_slots=2, max_seq=64, page_size=PAGE)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**kw))
    teng = ServingEngine(tcfg, tparams, EngineConfig(**kw), device="cpu")
    rng = np.random.default_rng(4)
    wave = [(i, rng.integers(0, tcfg.vocab_size, size=n), m)
            for i, (n, m) in enumerate(((11, 7), (17, 6), (9, 5)))]
    done, checked, n_cluster = serve_in_lockstep(jeng, teng, [wave])
    assert checked >= 12 and n_cluster == 3 and teng.paged
    assert teng.dense_pool.pages_in_use == 0


# --------------------------------------------------------- moe_impl ----
def test_step_makers_take_the_reference_moe_impl():
    makers = [n for n in dir(jsteps) if n.startswith("make_")
              and "moe_impl" in inspect.signature(
                  getattr(jsteps, n)).parameters
              and n not in ("make_loss_fn", "make_train_step")]
    assert len(makers) == 8
    for name in makers:
        want = inspect.signature(getattr(jsteps, name)).parameters
        got = inspect.signature(getattr(tsteps, name)).parameters
        assert got["moe_impl"].default == want["moe_impl"].default, name
    assert (inspect.signature(ttfm.decode_step).parameters["moe_impl"]
            .default == "ragged")


def test_served_run_calls_each_form_per_step_kind(monkeypatch):
    """A continuous CHAI run on 2 slots, the second request arriving once
    the first is STEADY: prefills, all-WARMUP and all-STEADY steps take
    the capacity form, the mixed steps (a WARMUP slot beside a STEADY
    one) the ragged one."""
    _, tcfg, _, tparams = _models(DEEPSEEK, n_layers=2, vocab=64)
    seen = []
    for name in ("moe_ffn", "moe_ffn_ragged"):
        inner = getattr(tmoe, name)

        def counted(x, *a, _name=name, _inner=inner, **kw):
            seen.append((_name, x.shape[1]))
            return _inner(x, *a, **kw)
        monkeypatch.setattr(ttfm.moe, name, counted)
    eng = ServingEngine(tcfg, tparams, EngineConfig(
        batch_slots=2, max_seq=64, page_size=PAGE), device="cpu")
    eng.submit(list(range(12)), max_new_tokens=12, uid=0)
    for _ in range(6):
        eng.step()
    assert set(seen) == {("moe_ffn", 16), ("moe_ffn", 1)}
    eng.submit(list(range(3, 12)), max_new_tokens=4, uid=1)
    eng.run()
    assert ("moe_ffn_ragged", 1) in set(seen)
    assert all(n == 1 for name, n in seen if name == "moe_ffn_ragged")
