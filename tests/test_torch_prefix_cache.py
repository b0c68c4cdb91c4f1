"""The port's prefix cache (and relay decode) against the JAX package's,
on the CPU.

* ``PrefixCache``: the same sequence of inserts, matches, snapshots,
  locks, evictions and a clear on both packages' caches over their own
  ``PagePool``s: equal matched pages, refcounts, free lists, LRU order,
  residency and counters.
* ``copy_pool_page``, ``restore_slot_snapshot`` and one suffix-prefill
  step (``make_paged_suffix_prefill``: the suffix over aliased pages) on
  the same state: logits at 1e-4, every pool page but the null page 0 at
  1e-5, tables, ``pos`` and phases exact.
* The engines in lockstep with ``prefix_cache=True`` (reduced fp32
  chai-llama-7b, 2 layers, d=32, warmup 3, 2 slots, max_seq 64, page 16;
  the reference runs its Pallas kernels in interpret mode, the port their
  plain versions) through a miss, partial hits, a snapshot hit and a
  replay; once as is, once with ``prefill_chunk_tokens=16`` (a 20-token
  suffix in two chunks) and once with ``relay_decode=True`` (a relay
  group of 2). The port takes the reference's tokens and memberships, so
  both run the same sequences; after every step: phases, every pool page
  but page 0, the tables and ``pos``; pages in use and every refcount
  exactly; every page shared by more than one holder unchanged since the
  previous step (the copy-on-write guard); each request's ``cache_hit``,
  ``cached_tokens`` and ``prefill_tokens``; and the relay dict of every
  relay step (maps, members, plen, in-group flags, packed prefix). The
  port's own greedy pick is held on every step whose reference top-2
  margin exceeds 1e-3. Greedy tokens are held against the reference on
  the same path, not against a cold run (see ROADMAP Queue 3).
* Inside the port: the refused settings, and eviction under pressure
  returning every page.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.serving import prefix_cache as jpc
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.launch import steps as tsteps
from repro_torch.serving import prefix_cache as tpc
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

S, PAGE, SLOTS = 64, 16, 2
DENSE_PAGES, CHAI_PAGES = 33, 25      # room for every snapshot: no eviction
MARGIN = 1e-3
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages")
STAT_KEYS = ("partial_hits", "misses", "snapshot_hits", "tokens_reused",
             "tokens_prefilled", "inserted_blocks", "evicted_blocks",
             "evicted_snapshots", "blocks", "snapshots", "dense_page_refs",
             "chai_page_refs")


def _t(a):
    return torch.from_numpy(np.array(a))


def _slo_cfg(get, red):
    return red(get("chai-llama-7b"), n_layers=2, d_model=32, d_ff=64,
               vocab=64).replace(dtype="float32").with_chai(
                   enabled=True, warmup_tokens=3)


@pytest.fixture(scope="module")
def models():
    jcfg = _slo_cfg(jget_config, jreduced)
    tcfg = _slo_cfg(get_config, reduced)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _traffic():
    """(warm request, the rest) as (uid, prompt, max_new): a shared
    32-token prefix warmed by a request that retires in WARMUP; three
    suffix requests (partial hits, the third with a 20-token suffix); a
    miss; then request 1's prompt again (a snapshot hit) and once more
    with a budget its warmup tokens cover (a replay)."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, 64, size=2 * PAGE).tolist()
    s = [rng.integers(0, 64, size=n).tolist() for n in (4, 5, 20, 10)]
    warm = (0, prefix + [1], 4)
    rest = [(1, prefix + s[0], 8), (2, prefix + s[1], 8),
            (3, prefix + s[2], 6), (4, s[3], 5), (5, prefix + s[0], 8),
            (6, prefix + s[0], 3)]
    return warm, rest


EXPECTED_HITS = {0: ("", 0, 33), 1: ("prefix", 32, 4), 2: ("prefix", 32, 5),
                 3: ("prefix", 32, 20), 4: ("", 0, 10),
                 5: ("snapshot", 36, 0), 6: ("replay", 36, 0)}


# ------------------------------------------------------ PrefixCache unit --
def _drive_cache(pc, pool_mod, snap_cls):
    """One op sequence on a cache over fresh pools; returns a log of what
    each step observed."""
    dense = pool_mod.PagePool(24, PAGE)
    chai = pool_mod.PagePool(10, PAGE)
    cache = pc.PrefixCache(dense, chai, PAGE)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 64, size=3 * PAGE).tolist()
    b = a[:PAGE] + rng.integers(0, 64, size=2 * PAGE + 5).tolist()
    c = rng.integers(0, 64, size=2 * PAGE).tolist()
    log = []

    def observe(tag):
        entries = [(type(e).__name__, getattr(e, "key", None)
                    or getattr(e, "prompt", None))
                   for e in cache._lru.values()]
        log.append((tag, dense.free_pages, dense.counters(),
                    dict(dense._rc), chai.free_pages, dict(chai._rc),
                    cache.num_blocks, cache.num_snapshots,
                    cache.held_pages(), entries,
                    {k: cache.stats[k] for k in STAT_KEYS[:8]}))

    held = {}
    for name, prompt in (("a", a), ("b", b), ("c", c)):
        n = len(prompt) // PAGE
        kg, vg = dense.alloc(n), dense.alloc(n)
        held[name] = kg + vg
        log.append(("insert", name, cache.insert(prompt, kg, vg)))
        observe(f"insert {name}")
    for name, prompt in (("a+", a + [1]), ("b", b), ("a", a),
                         ("miss", [5] * 40)):
        m = cache.match(prompt)
        log.append(("match", name, [(n.kg_page, n.vg_page) for n in m]))
    observe("matched")
    for name in ("a", "b", "c"):          # the slots retire
        dense.free(held[name])
    observe("slots freed")
    # two snapshots, the first partially over pages it copies
    snaps = []
    for i in range(2):
        vg, kc = dense.alloc(2), chai.alloc(3)
        kw = dict(prompt=tuple(a + [i]), pos=3 * PAGE - 3 + i,
                  tokens=[1, 2, 3, 4], ctx={"h2c": np.zeros((2, 8))},
                  vg_pages=vg, kc_pages=kc)
        if snap_cls is jpc.ChaiSnapshot:
            kw["vc_pages"] = []
        snaps.append(snap_cls(**kw))
        cache.add_snapshot(snaps[-1])
    log.append(("snapshot_for", cache.snapshot_for(a + [0]) is snaps[0],
                cache.snapshot_for(a) is None))
    observe("snapshots")
    chain = cache.match(b + [9])
    cache.lock(chain)
    cache.lock([snaps[1]])
    observe("locked")
    log.append(("evict", cache.evict_until(dense_free=22, chai_free=7)))
    observe("evicted")
    cache.unlock(chain)
    cache.unlock([snaps[1]])
    observe("unlocked")
    log.append(("evict", cache.evict_until(dense_free=20, chai_free=9)))
    observe("evicted again")
    cache.clear()
    observe("cleared")
    return log


def test_prefix_cache_matches_reference():
    got = _drive_cache(tpc, tcache, tpc.ChaiSnapshot)
    want = _drive_cache(jpc, jcache, jpc.ChaiSnapshot)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w, (g[0], g, w)
    assert got[-1][1] == 23 and got[-1][4] == 9     # everything returned


# ---------------------------------------------- state steps vs reference --
def _states(jcfg, tcfg, seed=0):
    """The same random paged state in both packages."""
    shapes = tcache.paged_state_shapes(tcfg, SLOTS, S, page_size=PAGE,
                                       dense_pages=9, chai_pages=5)
    rng = np.random.default_rng(seed)
    base = {}
    for k, (shape, dt) in shapes.items():
        if dt == torch.int32:
            base[k] = rng.integers(0, 4, size=shape).astype(np.int32)
        else:
            base[k] = rng.normal(size=shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: _t(v) for k, v in base.items()})


def _assert_states_equal(tst, jst, keys=None):
    for k in keys or jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)


def test_copy_page_and_snapshot_restore_match_reference(models):
    jcfg, tcfg, _, _ = models
    jst, tst = _states(jcfg, tcfg)
    for kind, src, dst in (("dense", 3, 7), ("chai", 2, 4)):
        jst = jsteps.make_page_copy(jcfg, kind)(jst, jnp.int32(src),
                                                jnp.int32(dst))
        tst = tsteps.make_page_copy(tcfg, kind)(tst, src, dst)
        _assert_states_equal(tst, jst)
    rows = [np.asarray(r, np.int32) for r in
            ([0, 0, 0, 0], [5, 6, 1, 0], [3, 4, 2, 0])]
    jst = jsteps.make_snapshot_restore(jcfg)(
        jst, jnp.int32(1), *(jnp.asarray(r) for r in rows),
        jnp.zeros((4,), jnp.int32), jnp.int32(39))
    tst = tsteps.make_snapshot_restore(tcfg)(tst, 1, *(_t(r) for r in rows),
                                             39)
    _assert_states_equal(tst, jst)
    assert int(tst["phase"][1]) == tcache.PHASE_STEADY
    assert int(tst["pos"][1]) == 39


def test_suffix_prefill_step_matches_reference(models):
    """A 45-token prompt whose first 32 tokens were prefilled into pages
    [5, 9] / [7, 2] by another slot: the suffix prefill of slot 1 over
    those aliased pages writes only its own pages [3] / [11]; logits,
    pools, tables, ``pos`` and phase."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 64, size=45)
    jstate = jcache.init_paged_state(jcfg, SLOTS, S, page_size=PAGE,
                                     dense_pages=17, chai_pages=9)
    tstate = tcache.init_paged_state(tcfg, SLOTS, S, page_size=PAGE,
                                     dense_pages=17, chai_pages=9,
                                     device="cpu")
    p_slot = S // PAGE

    def vec(pages):
        v = np.zeros((p_slot,), np.int32)
        v[:len(pages)] = pages
        return v

    # slot 0 prefills the shared 32 tokens
    toks = np.zeros((1, 32), np.int32)
    toks[0] = prompt[:32]
    jfill = jax.jit(jsteps.make_paged_slot_prefill(jcfg, S))
    _, jstate = jfill(jparams, jnp.asarray(toks), jnp.int32(32), jstate,
                      jnp.int32(0), jnp.asarray(vec([5, 9])),
                      jnp.asarray(vec([7, 2])))
    _, tstate = tsteps.make_paged_slot_prefill(tcfg, S)(
        tparams, _t(toks.astype(np.int64)), 32, tstate, 0,
        _t(vec([5, 9])), _t(vec([7, 2])))
    toks = np.zeros((1, 16), np.int32)
    toks[0, :13] = prompt[32:]
    args = (vec([0, 0, 3]), vec([0, 0, 11]), vec([5, 9, 3]),
            vec([7, 2, 11]))
    jlog, jstate = jax.jit(jsteps.make_paged_suffix_prefill(jcfg, S))(
        jparams, jnp.asarray(toks), jnp.int32(13), jnp.int32(32), jstate,
        jnp.int32(1), *(jnp.asarray(a) for a in args))
    shared = tstate["kvp"][:, [5, 9, 7, 2]].clone()
    tlog, tstate = tsteps.make_paged_suffix_prefill(tcfg, S)(
        tparams, _t(toks.astype(np.int64)), 13, 32, tstate, 1,
        *(_t(a) for a in args))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_allclose(tstate["kvp"][:, 1:].numpy(),
                               np.asarray(jstate["kvp"])[:, 1:], **POOL_TOL)
    assert torch.equal(tstate["kvp"][:, [5, 9, 7, 2]], shared)
    _assert_states_equal(tstate, jstate, ("pos", "phase", "bt_kg", "bt_vg"))
    assert int(tstate["pos"][1]) == 45


# ------------------------------------------------------ engine lockstep ---
LOCKSTEP_CASES = {"prefix": {}, "chunked": dict(prefill_chunk_tokens=16),
                  "relay": dict(relay_decode=True)}


def _ecfg(cls, **kw):
    return cls(**dict(dict(batch_slots=SLOTS, max_seq=S, page_size=PAGE,
                           num_pages=DENSE_PAGES,
                           num_chai_pages=CHAI_PAGES, prefix_cache=True),
                      **kw))


def _hits(eng):
    reqs = list(eng.done) + [r for r in eng._slot_req if r is not None]
    return {r.uid: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for r in reqs}


def _shared_pages(eng):
    """{(pool key, page): contents} of every page more than one holder
    references right now."""
    out = {}
    for key, pool in (("kvp", eng.dense_pool), ("cp", eng.chai_pool)):
        for page, rc in pool._rc.items():
            if rc > 1:
                out[key, page] = eng._dev_state[key][:, page].clone()
    return out


def _assert_relay_equal(trel, jrel):
    assert (trel is None) == (jrel is None)
    if trel is None:
        return
    assert sorted(trel) == sorted(jrel)
    for key in ("k_row", "a_row", "v_row", "plen", "members", "gid", "midx",
                "len", "in_group"):
        np.testing.assert_array_equal(trel[key].numpy(),
                                      np.asarray(jrel[key]), err_msg=key)
    for key in ("k", "v"):
        np.testing.assert_allclose(trel[key].numpy(), np.asarray(jrel[key]),
                                   **POOL_TOL, err_msg=key)


@pytest.fixture(scope="module", params=sorted(LOCKSTEP_CASES))
def lockstep(request, models):
    """Both engines stepped in turns, the reference first; the port takes
    the reference's tokens and memberships (see the module docstring)."""
    jcfg, tcfg, jparams, tparams = models
    kw = LOCKSTEP_CASES[request.param]
    jeng = JServingEngine(jcfg, jparams, _ecfg(JEngineConfig, **kw))
    teng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig, **kw),
                         device="cpu")
    calls, clusters = [], []
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

    jeng._argmax, jeng._cluster_slot = rec_argmax, rec_cluster
    checked = []

    def port_argmax(lg):
        jlg, jtok, live = calls.pop(0)
        assert tuple(lg.shape) == jlg.shape
        rows = [i for i, a in enumerate(live) if a]
        np.testing.assert_allclose(lg.numpy()[rows], jlg[rows], **LOGIT_TOL)
        own = torch.argmax(lg, dim=-1).numpy()
        for i in rows:
            top2 = np.sort(jlg[i])[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert own[i] == jtok[i]
                checked.append(1)
        return torch.from_numpy(jtok.astype(np.int64))

    teng._argmax = port_argmax
    teng._identify = lambda sc: {k: torch.from_numpy(v[:, None])
                                 for k, v in clusters.pop(0).items()}
    relays = {"ref": [], "port": []}
    for eng, side in ((jeng, "ref"), (teng, "port")):
        if getattr(eng, "relay_decode", False):
            def built(active, _fn=eng._build_relay, _s=side):
                out = _fn(active)
                relays[_s].append(out)
                return out
            eng._build_relay = built
    warm, rest = _traffic()
    n_relay = 0

    def run_until_idle():
        nonlocal n_relay
        shared = _shared_pages(teng)
        while jeng.has_work():
            jeng.step()
            teng.step()
            assert not calls and not clusters
            assert teng.has_work() == jeng.has_work()
            np.testing.assert_array_equal(teng._phases, jeng._phases)
            js, ts = jeng._dev_state, teng._dev_state
            for key in ("kvp", "cp"):
                np.testing.assert_allclose(ts[key][:, 1:].numpy(),
                                           np.asarray(js[key])[:, 1:],
                                           **POOL_TOL, err_msg=key)
            for key in ("pos", "phase", "bt_kg", "bt_vg", "bt_kc"):
                np.testing.assert_array_equal(ts[key].numpy(),
                                              np.asarray(js[key]), key)
            for tp, jp in ((teng.dense_pool, jeng.dense_pool),
                           (teng.chai_pool, jeng.chai_pool)):
                assert tp._rc == jp._rc
                assert tp.pages_in_use == jp.pages_in_use
            # copy-on-write: a page shared before and after the step kept
            # its contents
            now = _shared_pages(teng)
            for key in now.keys() & shared.keys():
                assert torch.equal(now[key], shared[key]), key
            shared = now
            assert _hits(teng) == _hits(jeng)
            assert teng.relay_steps == getattr(jeng, "relay_steps", 0)
            for trel, jrel in zip(relays["port"], relays["ref"]):
                _assert_relay_equal(trel, jrel)
                n_relay += trel is not None
            relays["port"].clear()
            relays["ref"].clear()

    for eng in (jeng, teng):
        eng.submit(warm[1], max_new_tokens=warm[2], uid=warm[0])
    run_until_idle()
    for uid, prompt, max_new in rest:
        for eng in (jeng, teng):
            eng.submit(prompt, max_new_tokens=max_new, uid=uid)
    run_until_idle()
    return request.param, jeng, teng, len(checked), n_relay


def test_prefix_engine_page_accounting_matches_reference(lockstep):
    _, jeng, teng, _, _ = lockstep
    assert teng.steps_executed == jeng.steps_executed
    assert len(teng.kv_bytes_history) == len(jeng.kv_bytes_history)
    for t, j in zip(teng.kv_bytes_history, jeng.kv_bytes_history):
        assert {k: t[k] for k in HISTORY_KEYS} == \
            {k: j[k] for k in HISTORY_KEYS}
    assert teng.kv_bytes_peak() == jeng.kv_bytes_peak()
    tstats, jstats = teng.prefix_stats(), jeng.prefix_stats()
    assert {k: tstats[k] for k in STAT_KEYS} == \
        {k: jstats[k] for k in STAT_KEYS}
    assert teng.cluster_transitions == jeng.cluster_transitions
    # only the cache holds pages now; a clear returns every one
    for eng in (teng, jeng):
        eng.prefix_cache.clear()
        assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0


def test_prefix_engine_tokens_and_hits_match_reference(lockstep):
    _, jeng, teng, checked, _ = lockstep
    tdone = {r.uid: r for r in teng.done}
    jdone = {r.uid: r for r in jeng.done}
    assert {u: r.generated for u, r in tdone.items()} == \
        {u: r.generated for u, r in jdone.items()}
    assert {u: (r.cache_hit, r.cached_tokens, r.prefill_tokens)
            for u, r in tdone.items()} == EXPECTED_HITS
    assert [len(tdone[u].generated) for u in sorted(tdone)] == \
        [4, 8, 8, 6, 5, 8, 3]
    assert checked >= 25                  # the port's own picks agreed
    # requests 1-4 cluster; the warm request retires in WARMUP, the
    # snapshot hit skips WARMUP and CLUSTER, the replay takes no slot
    assert teng.cluster_transitions == 4


def test_prefix_engine_relay_matches_reference(lockstep):
    case, jeng, teng, _, n_relay = lockstep
    if case == "relay":
        assert teng.relay_steps == jeng.relay_steps == n_relay > 0
        assert teng.relay_grouped_slots == jeng.relay_grouped_slots \
            == 2 * n_relay                # one group of two every time
    else:
        assert teng.relay_steps == 0 and n_relay == 0


# ------------------------------------------------------ inside the port ---
@pytest.mark.parametrize("kw,err", [
    (dict(kv_layout="dense"), ValueError),
    (dict(prefix_cache=False, relay_decode=True), ValueError),
    (dict(use_chai=False, relay_decode=True), ValueError),
    (dict(kv_layout="dense", prefix_cache=False, kv_offload=True),
     ValueError)],
    ids=["dense_layout", "relay_without_cache", "relay_without_chai",
         "kv_offload"])
def test_refused_settings(models, kw, err):
    _, tcfg, _, tparams = models
    with pytest.raises(err):
        ServingEngine(tcfg, tparams, _ecfg(EngineConfig, **kw), device="cpu")


def test_prefix_cache_rejected_for_local_attention(models):
    _, tcfg, _, tparams = models
    cfg = tcfg.replace(layer_types=("attn_local", "attn_global"))
    with pytest.raises(ValueError, match="global-attention"):
        ServingEngine(cfg, tparams, _ecfg(EngineConfig), device="cpu")


def test_eviction_under_pressure_then_no_leaks(models):
    """Small pools and distinct long prompts: admission evicts cached
    entries LRU-first to make room, every request completes, and a clear
    returns every page."""
    _, tcfg, _, tparams = models
    eng = ServingEngine(tcfg, tparams, _ecfg(
        EngineConfig, num_pages=13, num_chai_pages=7), device="cpu")
    rng = np.random.default_rng(9)
    for uid in range(6):
        eng.submit(rng.integers(0, 64, size=40), max_new_tokens=6, uid=uid)
    done = eng.run()
    assert sorted(len(r.generated) for r in done) == [6] * 6
    stats = eng.prefix_stats()
    assert stats["evicted_blocks"] + stats["evicted_snapshots"] > 0
    eng.prefix_cache.clear()
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    assert eng.dense_pool.counters()["refs"] == 0
