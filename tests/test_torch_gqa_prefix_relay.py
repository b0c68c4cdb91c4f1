"""The prefix cache and relay decode on a GQA model (reduced
nemotron-4-15b) against the JAX package's, on the CPU.

A GQA model keeps its dense K/V pages through CLUSTER and has no
clustered pool, so, as in the reference, its prefix cache takes no CHAI
snapshot: a prompt seen before is a ``"prefix"`` hit on the radix tree's
dense pages, and only the uncached tail is prefilled. Relay decode routes
each member's reps to its KV group's K row (``k_row = kv_of_rep``), each
head to its group's rep row (``a_row = j * KV * r + group * r +
cluster_of``) and to its group's V row (``v_row = kv_of_head``).

* The relay composition (the reference's ``_gqa_relay_case``): one
  group-batched prefix pass plus each member's suffix-only state pass,
  merged and finalized, equal one full fused pass, for groups of 1, 2
  and 8 (plain versions, atol = rtol = 1e-5).
* The engines in lockstep (2 KV groups of 6 heads, head_dim 8, 2 layers,
  fp32, warmup 3, 2 slots, max_seq 64, page 16; the reference's Pallas
  kernels in interpret mode, the port's plain versions): a miss, partial
  hits, a repeated prompt, once with ``prefix_cache=True`` and once with
  ``relay_decode=True`` too. The port takes the reference's tokens and
  memberships; after every step the phases, every pool page but page 0
  (1e-5), the tables, ``pos``, every refcount, the plan kinds with their
  cached and prefilled token counts, and every relay dict are held; the
  port's own greedy pick on every step whose reference top-2 margin
  exceeds 1e-3; the logits of every live row at 1e-4.
* Inside the port, on 1 and 2 KV groups: relay-on tokens equal relay-off
  tokens, and cached tokens equal a cold engine's (the reference's GQA
  contract, ``tests/test_prefix_cache.py``), with every page returned.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops as tops
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

ARCH = "nemotron-4-15b"
CONFIGS = {"1group": dict(n_heads=8), "2groups": dict(n_heads=12, d_model=96)}
S, PAGE, SLOTS = 64, 16, 2
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(get, red, group):
    return red(get(ARCH), n_layers=2, d_ff=64, vocab=64,
               **CONFIGS[group]).replace(dtype="float32").with_chai(
                   enabled=True, warmup_tokens=3)


def _models(group):
    jcfg = _cfg(jget_config, jreduced, group)
    tcfg = _cfg(get_config, reduced, group)
    assert not tcfg.is_mha and tcfg.n_kv_heads == jcfg.n_kv_heads
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    return _models(request.param)


@pytest.fixture(scope="module")
def models_2groups():
    return _models("2groups")


# ------------------------------------------------ relay composition -------
@pytest.mark.parametrize("n", [1, 2, 8])
def test_relay_merge_matches_full_fused_gqa(n):
    """n members share K/V rows [0, sp) of 2 KV groups (2 reps and 2
    heads per group): the GQA routing maps of the group pass, merged with
    each member's suffix-only pass, give the full fused pass."""
    rng = np.random.default_rng(20 + n)
    kv, rpg, qpk, hd, sp, ssuf = 2, 2, 2, 16, 32, 32
    s, h, rt = sp + ssuf, kv * qpk, kv * rpg
    kc = rng.normal(size=(n, kv, s, hd)).astype(np.float32)
    kc[:, :, :sp] = kc[0, :, :sp]
    vc = rng.normal(size=(n, kv, s, hd)).astype(np.float32)
    vc[:, :, :sp] = vc[0, :, :sp]
    q = rng.normal(size=(n, rt, hd)).astype(np.float32)
    cl = rng.integers(0, rpg, (n, kv, qpk))
    h2c = (np.arange(kv)[None, :, None] * rpg + cl).reshape(n, h).astype(
        np.int32)
    pos = rng.integers(sp + 1, s, (n,)).astype(np.int32)
    full = tops.chai_decode_attention(_t(q), _t(kc), _t(vc), _t(h2c),
                                      _t(pos), reps_per_group=rpg, ts=PAGE)
    k_row = np.tile(np.repeat(np.arange(kv), rpg), n)[None]
    a_row = (np.arange(n)[:, None] * rt + h2c).reshape(1, n * h)
    v_row = np.tile(np.repeat(np.arange(kv), qpk), n)[None]
    m, l, acc = tops.relay_prefix_attention(
        _t(q.reshape(1, n * rt, hd)), _t(kc[0:1, :, :sp]),
        _t(vc[0:1, :, :sp]), *(_t(x.astype(np.int32))
                               for x in (k_row, a_row, v_row)),
        torch.tensor([sp], dtype=torch.int32), ts=PAGE)
    pref = (m.reshape(n, rt), l.reshape(n, rt), acc.reshape(n, h, hd))
    suf = tops.chai_decode_attention(
        _t(q), _t(kc[:, :, sp:]), _t(vc[:, :, sp:]), _t(h2c), _t(pos - sp),
        reps_per_group=rpg, ts=PAGE, emit_state=True)
    out = tops.finalize_decode_state(
        tops.merge_decode_states(suf, pref, _t(h2c)), _t(h2c))
    np.testing.assert_allclose(out.numpy(), full.numpy(), **TOL)


# ----------------------------------------------------- engine lockstep ----
def _traffic(seed=7):
    """(warm request, the rest) as (uid, prompt, max_new): a 32-token
    prefix warmed by a request that retires in WARMUP; three suffix
    requests (partial hits, one with a 20-token suffix); a miss; request
    1's prompt again (a prefix hit: GQA takes no snapshot)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 64, size=2 * PAGE).tolist()
    s = [rng.integers(0, 64, size=n).tolist() for n in (4, 5, 20, 10)]
    warm = (0, prefix + [1], 4)
    rest = [(1, prefix + s[0], 8), (2, prefix + s[1], 8),
            (3, prefix + s[2], 6), (4, s[3], 5), (5, prefix + s[0], 8)]
    return warm, rest


EXPECTED_HITS = {0: ("", 0, 33), 1: ("prefix", 32, 4), 2: ("prefix", 32, 5),
                 3: ("prefix", 32, 20), 4: ("", 0, 10),
                 5: ("prefix", 32, 4)}


def _ecfg(cls, **kw):
    return cls(**dict(dict(batch_slots=SLOTS, max_seq=S, page_size=PAGE,
                           num_pages=33, prefix_cache=True), **kw))


def _hits(eng):
    reqs = list(eng.done) + [r for r in eng._slot_req if r is not None]
    return {r.uid: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for r in reqs}


def _assert_relay_equal(trel, jrel):
    assert (trel is None) == (jrel is None)
    if trel is None:
        return
    for key in ("k_row", "a_row", "v_row", "plen", "members", "gid", "midx",
                "len", "in_group"):
        np.testing.assert_array_equal(trel[key].numpy(),
                                      np.asarray(jrel[key]), err_msg=key)
    for key in ("k", "v"):
        np.testing.assert_allclose(trel[key].numpy(), np.asarray(jrel[key]),
                                   **TOL, err_msg=key)


@pytest.mark.parametrize("relay", [False, True], ids=["prefix", "relay"])
def test_gqa_prefix_engine_in_lockstep_with_reference(models_2groups,
                                                      relay):
    jcfg, tcfg, jparams, tparams = models_2groups
    jeng = JServingEngine(jcfg, jparams,
                          _ecfg(JEngineConfig, relay_decode=relay))
    teng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig,
                                              relay_decode=relay),
                         device="cpu")
    calls, clusters, checked = [], [], []
    jargmax, jcluster = jeng._argmax, jeng._cluster_fn()

    def rec_argmax(lg):
        live = ([True] if lg.shape[0] == 1 else
                [r is not None and jeng._phases[i] != jcache.PHASE_PREFILL
                 for i, r in enumerate(jeng._slot_req)])
        tok = jargmax(lg)
        calls.append((np.asarray(lg), np.asarray(tok), live))
        return tok

    def rec_cluster(state, ctx, slot, *rest):
        state, ctx = jcluster(state, ctx, slot, *rest)
        clusters.append({k: np.array(v[:, int(slot)])
                         for k, v in ctx.items()})
        return state, ctx

    def port_argmax(lg):
        jlg, jtok, live = calls.pop(0)
        rows = [i for i, a in enumerate(live) if a]
        np.testing.assert_allclose(lg.numpy()[rows], jlg[rows], **LOGIT_TOL)
        own = torch.argmax(lg, dim=-1).numpy()
        for i in rows:
            top2 = np.sort(jlg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert own[i] == jtok[i]
                checked.append(1)
        return torch.from_numpy(jtok.astype(np.int64))

    jeng._argmax, jeng._cluster_slot = rec_argmax, rec_cluster
    teng._argmax = port_argmax
    teng._identify = lambda sc: {k: torch.from_numpy(v[:, None])
                                 for k, v in clusters.pop(0).items()}
    relays = {"ref": [], "port": []}
    if relay:
        for eng, side in ((jeng, "ref"), (teng, "port")):
            def built(active, _fn=eng._build_relay, _s=side):
                out = _fn(active)
                relays[_s].append(out)
                return out
            eng._build_relay = built
    n_relay = 0

    def run_until_idle():
        nonlocal n_relay
        while jeng.has_work():
            jeng.step()
            teng.step()
            assert not calls and not clusters
            np.testing.assert_array_equal(teng._phases, jeng._phases)
            js, ts = jeng._dev_state, teng._dev_state
            np.testing.assert_allclose(ts["kvp"][:, 1:].numpy(),
                                       np.asarray(js["kvp"])[:, 1:], **TOL)
            for key in ("pos", "phase", "bt_kg", "bt_vg"):
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]), key)
            assert teng.dense_pool._rc == jeng.dense_pool._rc
            assert teng.chai_pool is None and jeng.chai_pool is None
            assert _hits(teng) == _hits(jeng)
            for trel, jrel in zip(relays["port"], relays["ref"]):
                _assert_relay_equal(trel, jrel)
                n_relay += trel is not None
            relays["port"].clear()
            relays["ref"].clear()

    warm, rest = _traffic()
    for eng in (jeng, teng):
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
    run_until_idle()
    for uid, prompt, max_new in rest:
        for eng in (jeng, teng):
            eng.submit(prompt, max_new_tokens=max_new, uid=uid)
    run_until_idle()
    tdone = {r.uid: r for r in teng.done}
    jdone = {r.uid: r for r in jeng.done}
    assert {u: r.generated for u, r in tdone.items()} == \
        {u: r.generated for u, r in jdone.items()}
    assert _hits(teng) == EXPECTED_HITS
    assert checked and len(checked) >= 30
    assert teng.relay_steps == jeng.relay_steps == n_relay
    assert (n_relay > 0) == relay
    assert teng.relay_grouped_slots == jeng.relay_grouped_slots
    assert teng.prefix_stats()["tokens_reused"] == \
        jeng.prefix_stats()["tokens_reused"] == 4 * 32
    for eng in (teng, jeng):
        eng.prefix_cache.clear()
        assert eng.dense_pool.pages_in_use == 0


# ------------------------------------------------------- inside the port --
def _serve(tcfg, tparams, traffic, **kw):
    eng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig, **kw),
                        device="cpu")
    for batch in traffic:
        for uid, prompt, max_new in batch:
            eng.submit(prompt, max_new_tokens=max_new, uid=uid)
        eng.run()
    done = {r.uid: r for r in eng.done}
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    assert eng.dense_pool.pages_in_use == 0
    return done, eng


def test_gqa_relay_tokens_equal_plain_decode(models):
    """Relay on against relay off on the same traffic, 1 and 2 KV
    groups: identical tokens and plan kinds, and relay steps ran."""
    _, tcfg, _, tparams = models
    warm, rest = _traffic(seed=11)
    plain, _ = _serve(tcfg, tparams, ([warm], rest))
    relay, eng = _serve(tcfg, tparams, ([warm], rest), relay_decode=True)
    assert eng.relay_steps > 0 and eng.relay_grouped_slots > 0
    assert {u: r.generated for u, r in relay.items()} == \
        {u: r.generated for u, r in plain.items()}
    assert {u: r.cache_hit for u, r in relay.items()} == \
        {u: r.cache_hit for u, r in plain.items()}


def test_gqa_cached_tokens_equal_cold(models):
    """The reference's GQA contract (``test_hit_miss_partial_parity_vs_
    cold``): a miss, the same prompt again (a ``"prefix"`` hit: one cached
    block, the tail prefilled) and a partial hit give a cold engine's
    tokens."""
    _, tcfg, _, tparams = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, 64, size=24).tolist()
    part = prompt[:PAGE] + rng.integers(0, 64, size=8).tolist()
    cold = {}
    for uid, p in ((0, prompt), (2, part)):
        done, _ = _serve(tcfg, tparams, ([(uid, p, 12)],),
                         prefix_cache=False)
        cold[uid] = done[uid].generated
    done, eng = _serve(tcfg, tparams, ([(0, prompt, 12)], [(1, prompt, 12)],
                                       [(2, part, 12)]))
    assert eng.chai_pool is None
    assert (done[0].cache_hit, done[1].cache_hit, done[2].cache_hit) == (
        "", "prefix", "prefix")
    assert (done[1].cached_tokens, done[1].prefill_tokens) == (PAGE, 8)
    assert (done[2].cached_tokens, done[2].prefill_tokens) == (PAGE, 8)
    assert done[0].generated == done[1].generated == cold[0]
    assert done[2].generated == cold[2]
