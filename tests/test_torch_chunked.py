"""The port's chunked prefill against the JAX package's, on the CPU.

The reduced fp32 chai-llama-7b of ``tests/test_slo_serving.py`` (2 layers,
d=32, 8 heads, vocab 64, warmup 3) with the reference's own
``init_params`` weights, max_seq 128, page 16, chunks of 16 tokens. The
reference runs its Pallas ``paged_prefix_attend`` and ``flash_prefill``
in interpret mode (its CPU default); the port runs their plain versions.

* One chunk prefill step (``forward_fullseq(prefix_len, prefix_kv)``
  into the paged state) per chunk of a 40-token prompt: logits at 1e-4,
  every pool page but the null page 0 at 1e-5, block tables, ``pos`` and
  phase exact.
* The engines in lockstep, the port taking the reference's tokens and
  membership: per-step page accounting, ``kv_bytes_history`` and the
  dispatched step kinds exact; every pool page but page 0, ``pos``, the
  tables and the phases after every step; live logits at 1e-4; the
  port's own greedy pick on every step whose reference top-2 margin
  exceeds 1e-3.
* Inside the port: chunked prefill gives the monolithic prefill's greedy
  tokens exactly; the knob does nothing on ``kv_layout="dense"``; a
  local-attention arch is refused; aborting a mid-prefill slot returns
  every page.
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
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.launch import steps as tsteps
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

S, PAGE, SLOTS, CHUNK = 128, 16, 2, 16
PROMPT_LENS = (40, 9, 33, 20, 50)       # 3, 1, 3, 2, 4 chunks
BUDGETS = (10, 6, 8, 5, 7)
MARGIN = 1e-3
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
HISTORY_KEYS = ("step", "kv_bytes", "dense_pages", "chai_pages")


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
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n) for n in PROMPT_LENS]
    return jcfg, tcfg, jparams, tparams, prompts


def _ecfg(cls, **kw):
    kw = dict(dict(batch_slots=SLOTS, max_seq=S, page_size=PAGE,
                   prefill_chunk_tokens=CHUNK), **kw)
    return cls(**kw)


def _port(tcfg, tparams, **kw):
    return ServingEngine(tcfg, tparams, _ecfg(EngineConfig, **kw),
                         device="cpu")


def _assert_pools_match(jstate, tstate):
    """Every page but the null page 0 (where several null-padded rows of
    one scatter land, in either order), and the slot bookkeeping."""
    for key in ("kvp", "cp"):
        np.testing.assert_allclose(tstate[key][:, 1:].numpy(),
                                   np.asarray(jstate[key])[:, 1:],
                                   **POOL_TOL, err_msg=key)
    for key in ("pos", "phase", "bt_kg", "bt_vg", "bt_kc"):
        np.testing.assert_array_equal(tstate[key].numpy(),
                                      np.asarray(jstate[key]), err_msg=key)
    np.testing.assert_allclose(tstate["chai_scores"].numpy(),
                               np.asarray(jstate["chai_scores"]), **POOL_TOL)


# ------------------------------------------------------ one chunk step ----
def test_chunk_prefill_step_matches_reference(models):
    """A 40-token prompt in three chunks (16 + 16 + 8) into slot 1 of a
    paged state whose pages are not in order: the chunk step's logits,
    the pages it writes and the slot's tables, ``pos`` and phase."""
    jcfg, tcfg, jparams, tparams, prompts = models
    prompt = prompts[0]
    n_dense, n_chai = 17, 9
    jstate = jcache.init_paged_state(jcfg, SLOTS, S, page_size=PAGE,
                                     dense_pages=n_dense, chai_pages=n_chai)
    tstate = tcache.init_paged_state(tcfg, SLOTS, S, page_size=PAGE,
                                     dense_pages=n_dense, chai_pages=n_chai,
                                     device="cpu")
    jfn = jax.jit(jsteps.make_paged_chunk_prefill(jcfg, S))
    tfn = tsteps.make_paged_chunk_prefill(tcfg, S)
    kg, vg = [5, 9, 3], [7, 2, 11]
    p_slot = S // PAGE

    def vec(pages):
        v = np.zeros((p_slot,), np.int32)
        v[:len(pages)] = pages
        return v

    slot = 1
    for cur in (0, 16, 32):
        end = min(cur + CHUNK, len(prompt))
        final = end == len(prompt)
        bucket = 1 << (end - cur - 1).bit_length()
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :end - cur] = prompt[cur:end]
        lo, hi = cur // PAGE, -(-end // PAGE)
        sk = vec([p if lo <= j < hi else 0 for j, p in enumerate(kg)])
        sv = vec([p if lo <= j < hi else 0 for j, p in enumerate(vg)])
        phase = tcache.PHASE_WARMUP if final else tcache.PHASE_FREE
        jlog, jstate = jfn(jparams, jnp.asarray(toks), jnp.int32(end - cur),
                           jnp.int32(cur), jstate, jnp.int32(slot),
                           jnp.asarray(sk), jnp.asarray(sv),
                           jnp.asarray(vec(kg)), jnp.asarray(vec(vg)),
                           jnp.int32(phase))
        tlog, tstate = tfn(tparams, torch.from_numpy(toks.astype(np.int64)),
                           end - cur, cur, tstate, slot, torch.from_numpy(sk),
                           torch.from_numpy(sv), torch.from_numpy(vec(kg)),
                           torch.from_numpy(vec(vg)), phase)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        _assert_pools_match(jstate, tstate)
        assert int(tstate["pos"][slot]) == end
        assert int(tstate["phase"][slot]) == phase
    assert tstate["kvp"][:, kg + vg].abs().sum() > 0


# ------------------------------------------------------ engine lockstep ---
@pytest.fixture(scope="module")
def lockstep(models):
    """Both chunked engines stepped in turns. The reference steps first
    and its argmax inputs/outputs and CLUSTER memberships are recorded;
    the port then takes the reference's tokens and memberships, so both
    decode the same sequences and their states stay comparable."""
    jcfg, tcfg, jparams, tparams, prompts = models
    jeng = JServingEngine(jcfg, jparams, _ecfg(JEngineConfig))
    teng = _port(tcfg, tparams)
    calls, clusters, kinds = [], [], {"ref": [], "port": []}

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
    for eng, side in ((jeng, "ref"), (teng, "port")):
        for attr in ("_mha_step", "_chai_step", "_mixed_step"):
            def counted(*a, _fn=getattr(eng, attr), _k=attr, _s=side):
                kinds[_s].append(_k)
                return _fn(*a)
            setattr(eng, attr, counted)
    for i, (p, m) in enumerate(zip(prompts, BUDGETS)):
        jeng.submit(p, max_new_tokens=m, uid=i)
        teng.submit(p, max_new_tokens=m, uid=i)
    trace, mixed_while_chunking = [], 0
    while jeng.has_work():
        jeng.step()
        teng.step()
        assert not calls and not clusters
        assert teng.has_work() == jeng.has_work()
        np.testing.assert_array_equal(teng._phases, jeng._phases)
        _assert_pools_match(jeng._dev_state, teng._dev_state)
        trace.append((teng.steps_executed, teng.dense_pool.pages_in_use,
                      teng.chai_pool.pages_in_use))
        assert trace[-1] == (jeng.steps_executed,
                             jeng.dense_pool.pages_in_use,
                             jeng.chai_pool.pages_in_use)
        if any(st is not None for st in teng._slot_prefill_state):
            mixed_while_chunking += kinds["port"][-1:] == ["_mixed_step"]
    return jeng, teng, trace, kinds, len(checked), mixed_while_chunking


def test_chunked_engine_page_accounting_matches_reference(lockstep):
    jeng, teng, trace, kinds, _, mixed = lockstep
    assert teng.steps_executed == jeng.steps_executed
    assert len(teng.kv_bytes_history) == len(jeng.kv_bytes_history)
    for t, j in zip(teng.kv_bytes_history, jeng.kv_bytes_history):
        assert {k: t[k] for k in HISTORY_KEYS} == \
            {k: j[k] for k in HISTORY_KEYS}
    assert teng.kv_bytes() == jeng.kv_bytes() == 0
    assert teng.kv_bytes_peak() == jeng.kv_bytes_peak()
    assert kinds["port"] == kinds["ref"]
    # a chunked prefill in flight keeps the host phase PREFILL, so every
    # decode beside it is a mixed step
    assert mixed > 0
    assert teng.cluster_transitions == jeng.cluster_transitions == 5


def test_chunked_engine_tokens_match_reference(lockstep):
    jeng, teng, _, _, checked, _ = lockstep
    jdone = {r.uid: r.generated for r in jeng.done}
    tdone = {r.uid: r.generated for r in teng.done}
    assert tdone == jdone                  # the port took these tokens
    assert [len(tdone[u]) for u in sorted(tdone)] == list(BUDGETS)
    assert checked >= 30                   # the port's own picks agreed


# ------------------------------------------------------ inside the port ---
def _serve(eng, prompts, budgets=BUDGETS):
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        eng.submit(p, max_new_tokens=m, uid=i)
    done = {r.uid: r.generated for r in eng.run()}
    assert not eng.has_work()
    return done


@pytest.fixture(scope="module")
def monolithic(models):
    _, tcfg, _, tparams, prompts = models
    return _serve(_port(tcfg, tparams, prefill_chunk_tokens=0), prompts)


@pytest.mark.parametrize("chunk", [16, 20], ids=["chunk16", "chunk20_to_32"])
def test_chunked_equals_monolithic_greedy_tokens(models, monolithic, chunk):
    """The reference's ``test_chunked_prefill_greedy_parity`` inside the
    port: chunking is a latency knob, not a different model. A chunk of
    20 rounds up to 32 (two pages)."""
    _, tcfg, _, tparams, prompts = models
    eng = _port(tcfg, tparams, prefill_chunk_tokens=chunk)
    assert eng._chunk == -(-chunk // PAGE) * PAGE
    assert _serve(eng, prompts) == monolithic
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0


def test_chunk_knob_ignored_on_dense_layout(models, monolithic):
    _, tcfg, _, tparams, prompts = models
    eng = _port(tcfg, tparams, kv_layout="dense")
    assert eng._chunk == 0 and not eng.paged
    assert _serve(eng, prompts) == monolithic


def test_chunked_prefill_rejected_for_local_attention(models):
    _, tcfg, _, tparams, _ = models
    cfg = tcfg.replace(layer_types=("attn_local", "attn_global"))
    with pytest.raises(ValueError, match="chunk"):
        _port(cfg, tparams)


def test_abort_mid_prefill_returns_every_page(models):
    """A 50-token prompt stops after its first chunk: its pages go back,
    its slot is FREE with null tables, and the engine has no work."""
    _, tcfg, _, tparams, prompts = models
    eng = _port(tcfg, tparams)
    req = eng.submit(prompts[4], max_new_tokens=BUDGETS[4])
    assert eng.step() == []                # first chunk: no token yet
    i = req.slot
    assert eng._phases[i] == tcache.PHASE_PREFILL
    assert eng._slot_prefill_state[i]["cursor"] == CHUNK
    assert int(eng._dev_state["phase"][i]) == tcache.PHASE_FREE
    assert int(eng._dev_state["pos"][i]) == CHUNK
    assert eng.dense_pool.pages_in_use and eng.steps_executed == 0
    assert eng.abort(req.uid) and req.finish_reason == "aborted"
    assert req.generated == []
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    assert eng.dense_pool.counters()["refs"] == 0
    assert eng._slot_prefill_state[i] is None and not eng.has_work()
    for key in ("bt_kg", "bt_vg", "bt_kc"):
        assert not eng._dev_state[key][i].any()
    assert eng.step() == [] and eng.steps_executed == 0
