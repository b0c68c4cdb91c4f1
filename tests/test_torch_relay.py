"""The port's relay shared-prefix decode against the JAX package's, on the
CPU.

Kernel level (plain versions against the reference's Pallas kernels in
interpret mode, atol = rtol = 1e-5):

* ``relay_prefix_decode_ref`` against ``relay_prefix_decode``: random
  routing maps with padded members, ragged plen;
* the ``emit_state`` forms of ``chai_fused_decode_ref`` and
  ``paged_chai_fused_decode_ref`` against the fused kernels' state mode,
  with a rep that has no member head;
* ``merge_decode_states`` / ``finalize_decode_state`` against the
  reference's jnp ops, the empty state as the exact merge identity
  (the reference's ``test_empty_prefix_state_is_bitwise_merge_identity``,
  bitwise), and the relay composition (group-batched prefix pass + each
  member's suffix-only pass, merged) against one full pass.

Engine level, inside the port (reduced fp32 chai-llama-7b, 2 layers,
d=32, warmup 3, max_seq 64, page 16, ``prefix_cache=True``): relay tokens
equal non-relay tokens for groups of 1, 2 and 4 slots (the reference's own
contract); a slot that shares only part of the chain stays out of the
group; a chain evicted mid-stream dissolves its group. The engines with
``relay_decode=True`` in lockstep against the reference, relay dict by
relay dict, are in ``tests/test_torch_prefix_cache.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import chai_attention as jck
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _assert_state(got, want, tol=TOL):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ------------------------------------------------------ relay kernel ------
def _relay_inputs(rng, *, g=2, nmax=3, r=3, h=8, kv=8, hd=16, sp=64,
                  plen=(48, 16), members=(3, 2), dtype=np.float32):
    """Maps built as the engine builds them: member j owns query rows
    [j*r, (j+1)*r) (its reps) and acc rows [j*h, (j+1)*h) (its heads);
    groups with fewer than ``nmax`` members carry padded entries at 0."""
    q = rng.normal(size=(g, nmax * r, hd)).astype(np.float32)
    k = rng.normal(size=(g, kv, sp, hd)).astype(dtype)
    v = rng.normal(size=(g, kv, sp, hd)).astype(dtype)
    k_row = np.zeros((g, nmax * r), np.int32)
    a_row = np.zeros((g, nmax * h), np.int32)
    v_row = np.zeros((g, nmax * h), np.int32)
    for i, n in enumerate(members):
        for j in range(n):
            k_row[i, j * r:(j + 1) * r] = rng.permutation(kv)[:r]
            a_row[i, j * h:(j + 1) * h] = j * r + rng.integers(0, r - 1, h)
            v_row[i, j * h:(j + 1) * h] = np.arange(h)
    return q, k, v, k_row, a_row, v_row, np.asarray(plen, np.int32)


@pytest.mark.parametrize("kw", [
    dict(), dict(plen=(64, 1)), dict(g=1, nmax=2, members=(2,), plen=(32,)),
    dict(random_maps=True)], ids=["engine_maps", "full_and_one",
                                  "one_group", "random_maps"])
def test_relay_plain_matches_reference_kernel(kw):
    rng = np.random.default_rng(11)
    kw = dict(kw)
    random_maps = kw.pop("random_maps", False)
    args = list(_relay_inputs(rng, **kw))
    if random_maps:     # the reference's own oracle test: any routing
        g, nr = args[3].shape
        a = args[4].shape[1]
        args[3] = rng.integers(0, 8, (g, nr)).astype(np.int32)
        args[4] = rng.integers(0, nr, (g, a)).astype(np.int32)
        args[5] = rng.integers(0, 8, (g, a)).astype(np.int32)
    want = jck.relay_prefix_decode(*(_j(a) for a in args), ts=PAGE)
    before = dict(tck.LAUNCHES)
    got = tops.relay_prefix_attention(*(_t(a) for a in args), ts=PAGE)
    assert tck.LAUNCHES == before         # the CPU path launches nothing
    _assert_state(got, want)
    _assert_state(tref.relay_prefix_decode_ref(*(_t(a) for a in args)),
                  jref.relay_prefix_decode_ref(*(_j(a) for a in args)))


def test_relay_kernel_path_needs_a_gpu():
    """A non-CPU tensor goes to the kernel, which checks the device
    (and would launch on a GPU); nothing falls back to the plain
    version."""
    meta = dict(device="meta")
    args = (torch.empty(1, 6, 16, **meta), torch.empty(1, 8, 32, 16, **meta),
            torch.empty(1, 8, 32, 16, **meta),
            torch.empty(1, 6, dtype=torch.int32, **meta),
            torch.empty(1, 16, dtype=torch.int32, **meta),
            torch.empty(1, 16, dtype=torch.int32, **meta),
            torch.empty(1, dtype=torch.int32, **meta))
    before = dict(tck.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tops.relay_prefix_attention(*args)
    assert tck.LAUNCHES == before


# -------------------------------------------------- emit_state forms ------
def _decode_inputs(rng, *, b=3, r=5, h=8, hd=16, n_pages=4,
                   pos=(5, 40, 63)):
    """Dense K/V, the same rows on shuffled pool pages, and a membership
    with one rep that owns no head."""
    s = n_pages * PAGE
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k = rng.normal(size=(b, r, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, h, s, hd)).astype(np.float32)
    h2c = rng.choice([j for j in range(r) if j != 1],
                     size=(b, h)).astype(np.int32)

    def scatter(x, n_pool):
        pool = rng.normal(size=(n_pool, x.shape[1], PAGE, hd))
        pool = pool.astype(np.float32)
        bt = rng.permutation(np.arange(1, n_pool))[:b * n_pages]
        bt = bt.reshape(b, n_pages).astype(np.int32)
        for i in range(b):
            for t in range(n_pages):
                pool[bt[i, t]] = x[i, :, t * PAGE:(t + 1) * PAGE]
        return pool, bt

    k_pool, bt_k = scatter(k, b * n_pages + 3)
    v_pool, bt_v = scatter(v, b * n_pages + 5)
    return (q, k, v, k_pool, bt_k, v_pool, bt_v, h2c,
            np.asarray(pos, np.int32))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_emit_state_plain_matches_reference_kernel(layout):
    rng = np.random.default_rng(12)
    q, k, v, k_pool, bt_k, v_pool, bt_v, h2c, pos = _decode_inputs(rng)
    if layout == "dense":
        args = (q, k, v, h2c, pos)
        want = jck.chai_fused_decode(*(_j(a) for a in args), ts=PAGE,
                                     emit_state=True)
        got = tops.chai_decode_attention(*(_t(a) for a in args), ts=PAGE,
                                         emit_state=True)
    else:
        args = (q, k_pool, bt_k, v_pool, bt_v, h2c, pos)
        want = jck.paged_chai_fused_decode(*(_j(a) for a in args),
                                           emit_state=True)
        got = tops.paged_chai_decode_attention(*(_t(a) for a in args),
                                               emit_state=True)
    _assert_state(got, want)
    # every rep row is computed (m clamped at -1e30), the memberless too
    assert (got[0] >= -1e30).all()


def test_empty_prefix_state_is_bitwise_merge_identity():
    """Merging the empty state changes no bit: emit + merge + finalize
    equals finalize of the emitted state, on either package; the port's
    finalize also holds the finalized plain output."""
    rng = np.random.default_rng(13)
    n, r, h, hd, s = 2, 3, 6, 16, 64
    q = rng.normal(size=(n, r, hd)).astype(np.float32)
    kc = rng.normal(size=(n, r, s, hd)).astype(np.float32)
    vc = rng.normal(size=(n, h, s, hd)).astype(np.float32)
    h2c = rng.integers(0, r, (n, h)).astype(np.int32)
    pos = np.asarray([40, 63], np.int32)
    st = tops.chai_decode_attention(_t(q), _t(kc), _t(vc), _t(h2c), _t(pos),
                                    ts=PAGE, emit_state=True)
    empty = (torch.full((n, r), tref.NEG_INF), torch.zeros((n, r)),
             torch.zeros((n, h, hd)))
    merged = tops.finalize_decode_state(
        tops.merge_decode_states(st, empty, _t(h2c)), _t(h2c))
    direct = tops.finalize_decode_state(st, _t(h2c))
    assert torch.equal(merged, direct)
    fin = tops.chai_decode_attention(_t(q), _t(kc), _t(vc), _t(h2c),
                                     _t(pos), ts=PAGE)
    np.testing.assert_allclose(direct.numpy(), fin.numpy(), **TOL)
    jst = jck.chai_fused_decode(_j(q), _j(kc), _j(vc), _j(h2c), _j(pos),
                                ts=PAGE, emit_state=True)
    jempty = tuple(jnp.asarray(e.numpy()) for e in empty)
    jm = jops.finalize_decode_state(
        jops.merge_decode_states(jst, jempty, _j(h2c)), _j(h2c))
    assert (np.asarray(jm) == np.asarray(
        jops.finalize_decode_state(jst, _j(h2c)))).all()
    np.testing.assert_allclose(merged.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("h2c_rank", [1, 2])
def test_merge_and_finalize_match_reference(h2c_rank):
    rng = np.random.default_rng(14)
    b, r, h, hd = 3, 4, 8, 16
    h2c = rng.integers(0, r, (b, h) if h2c_rank == 2 else (h,))
    h2c = h2c.astype(np.int32)
    states = []
    for _ in range(2):
        m = rng.normal(size=(b, r)).astype(np.float32) * 3
        m[0, 1] = tref.NEG_INF            # an empty row on one side
        l = rng.uniform(0.5, 9.0, size=(b, r)).astype(np.float32)
        acc = rng.normal(size=(b, h, hd)).astype(np.float32)
        states.append((m, l, acc))
    states[1][1][0, 1] = 2.0              # the other side holds the row
    got = tops.merge_decode_states(*(tuple(_t(x) for x in st)
                                     for st in states), _t(h2c))
    want = jops.merge_decode_states(*(tuple(_j(x) for x in st)
                                      for st in states), _j(h2c))
    _assert_state(got, want, tol=dict(atol=1e-6, rtol=1e-6))
    np.testing.assert_allclose(
        tops.finalize_decode_state(got, _t(h2c)).numpy(),
        np.asarray(jops.finalize_decode_state(want, _j(h2c))),
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_relay_composition_matches_full_pass(n):
    """The reference's ``_mha_relay_case`` inside the port: n members
    share clustered prefix rows [0, sp); one group-batched prefix pass
    plus each member's suffix-only state pass, merged and finalized,
    equal one full pass over the whole cache (plain versions)."""
    rng = np.random.default_rng(15 + n)
    r, h, hd, sp, ssuf = 3, 6, 16, 32, 32
    s = sp + ssuf
    kc = rng.normal(size=(n, r, s, hd)).astype(np.float32)
    kc[:, :, :sp] = kc[0, :, :sp]
    vc = rng.normal(size=(n, h, s, hd)).astype(np.float32)
    vc[:, :, :sp] = vc[0, :, :sp]
    q = rng.normal(size=(n, r, hd)).astype(np.float32)
    h2c = rng.integers(0, r, (n, h)).astype(np.int32)
    pos = rng.integers(sp + 1, s, (n,)).astype(np.int32)
    full = tops.chai_decode_attention(_t(q), _t(kc), _t(vc), _t(h2c),
                                      _t(pos), ts=PAGE)
    k_row = np.tile(np.arange(r), n)[None].astype(np.int32)
    a_row = (np.arange(n)[:, None] * r + h2c).reshape(1, n * h)
    v_row = np.tile(np.arange(h), n)[None].astype(np.int32)
    m, l, acc = tops.relay_prefix_attention(
        _t(q.reshape(1, n * r, hd)), _t(kc[0:1, :, :sp]),
        _t(vc[0:1, :, :sp]), _t(k_row), _t(a_row.astype(np.int32)),
        _t(v_row), torch.tensor([sp], dtype=torch.int32), ts=PAGE)
    pref = (m.reshape(n, r), l.reshape(n, r), acc.reshape(n, h, hd))
    suf = tops.chai_decode_attention(
        _t(q), _t(np.ascontiguousarray(kc[:, :, sp:])),
        _t(np.ascontiguousarray(vc[:, :, sp:])), _t(h2c), _t(pos - sp),
        ts=PAGE, emit_state=True)
    out = tops.finalize_decode_state(
        tops.merge_decode_states(suf, pref, _t(h2c)), _t(h2c))
    np.testing.assert_allclose(out.numpy(), full.numpy(), **TOL)


# ------------------------------------------------- engine, inside the port --
def _port_cfg():
    from repro_torch.configs.base import get_config, reduced
    return reduced(get_config("chai-llama-7b"), n_layers=2, d_model=32,
                   d_ff=64, vocab=64).replace(dtype="float32").with_chai(
                       enabled=True, warmup_tokens=3)


@pytest.fixture(scope="module")
def port_model():
    from repro_torch.models.transformer import init_params
    cfg = _port_cfg()
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _shared_prompts(n, seed=7):
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 64, size=2 * PAGE).tolist()
    return prefix, [prefix + r.integers(0, 64, size=4 + j).tolist()
                    for j in range(n)]


def _relay_engine(model, *, relay, slots=2, min_group=2):
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    cfg, params = model
    return ServingEngine(cfg, params, EngineConfig(
        batch_slots=slots, max_seq=64, page_size=PAGE, prefix_cache=True,
        relay_decode=relay, relay_min_group=min_group), device="cpu")


def _serve_shared(model, prompts, prefix, *, max_new=8, **kw):
    eng = _relay_engine(model, **kw)
    eng.submit(prefix + [1], max_new_tokens=4, uid=0)
    eng.run()
    for j, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=max_new, uid=j + 1)
    done = {r.uid: r for r in eng.run()}
    eng.prefix_cache.clear()
    assert eng.dense_pool.pages_in_use == eng.chai_pool.pages_in_use == 0
    return [done[j + 1].generated for j in range(len(prompts))], eng


@pytest.mark.parametrize("n,slots,min_group", [(2, 2, 2), (1, 2, 1),
                                               (4, 4, 2)],
                         ids=["group2", "group1", "group4"])
def test_relay_tokens_equal_plain_decode(port_model, n, slots, min_group):
    """The reference's relay contract inside the port: grouped greedy
    tokens equal the per-request decode path's, for groups of 1, 2 and
    4 slots."""
    prefix, prompts = _shared_prompts(n)
    base, _ = _serve_shared(port_model, prompts, prefix, relay=False,
                            slots=slots, min_group=min_group)
    got, eng = _serve_shared(port_model, prompts, prefix, relay=True,
                             slots=slots, min_group=min_group)
    assert eng.relay_steps > 0
    assert eng.relay_grouped_slots >= n * min(eng.relay_steps, 1)
    assert got == base


def test_relay_divergent_slot_left_out_of_group(port_model):
    """A third request that shares only the first block decodes ungrouped;
    the two full-chain slots group on every relay step; tokens equal the
    per-request path's."""
    prefix, prompts = _shared_prompts(2)
    div = list(prefix)
    div[PAGE + 3] ^= 1                    # diverge inside block 2
    prompts = prompts + [div + [9, 9]]
    base, _ = _serve_shared(port_model, prompts, prefix, relay=False,
                            slots=3)
    got, eng = _serve_shared(port_model, prompts, prefix, relay=True,
                             slots=3)
    assert eng.relay_steps > 0
    assert eng.relay_grouped_slots == 2 * eng.relay_steps
    assert got == base


def test_relay_midstream_eviction_dissolves_group(port_model):
    """Marking the grouped chain evicted mid-stream stops the group from
    forming again; the remaining tokens still equal the per-request
    path's (the slots' own tables never depended on the packed copy)."""
    from repro_torch.serving.prefix_cache import BlockNode
    prefix, prompts = _shared_prompts(2)
    base, _ = _serve_shared(port_model, prompts, prefix, relay=False)
    eng = _relay_engine(port_model, relay=True)
    eng.submit(prefix + [1], max_new_tokens=4, uid=0)
    eng.run()
    for j, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=8, uid=j + 1)
    while eng.relay_steps == 0 and eng.has_work():
        eng.step()
    assert eng.relay_steps > 0
    for locked in eng._slot_locked:
        for node in locked:
            if isinstance(node, BlockNode):
                node.evicted = True
                node.resident = None
    frozen = eng.relay_steps
    eng.run()
    assert eng.relay_steps == frozen
    done = {r.uid: r for r in eng.done}
    assert [done[j + 1].generated for j in range(len(prompts))] == base
