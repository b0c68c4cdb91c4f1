"""The port's hierarchical KV tiers (``serving.kv_tiers``, the int4 rung of
``core.cache``, the page fetch / put of ``launch.steps`` and the engine's
demotion and promotion) against the JAX package's, on the CPU.

In the shape of ``tests/test_kv_tiers.py``: the int4 codes, scales and
packed bytes bit for bit; ``compress_payload``, ``HostPagePool`` and the
``TierManager`` ladder on the same call sequences; then the engines on a
reduced chai-llama-7b (2 layers, d 32, vocab 64, fp32, warmup 3;
``audit_level="deep"``, so every step ends in the deep audit), the
reference's and the port's on the same weights and workload, the port
clustering through the reference's membership (``_hold_membership``):
tokens, ``tier_stats()`` and ``prefix_stats()`` equal, every promoted page
``torch.equal`` to the page demoted, and the tokens equal to an all-device
run's (no pressure, no offload) at the same memberships.

The reference's ``test_preemption_swaps_through_host_pool`` is held in
``tests/test_torch_preemption.py``.
"""
import numpy as np
import pytest

import ml_dtypes
import torch

from repro.core import cache as jcache
from repro.serving import kv_tiers as jtiers
from repro.serving.prefix_cache import BlockNode as JBlockNode
from repro_torch.core import cache as tcache
from repro_torch.launch import steps as steps_mod
from repro_torch.serving import invariants
from repro_torch.serving import kv_tiers
from repro_torch.serving.engine import EngineConfig, EngineCore
from repro_torch.serving.prefix_cache import BlockNode
from repro_torch.serving.sampling import SamplingParams
from test_torch_faults import (ECFG, _clean, _cores, _drain, _model,
                               _submit)

RANGES = {np.float32: 5.0, ml_dtypes.bfloat16: 5.0, np.int8: None}


def _host(x):
    """A numpy array (bf16: ml_dtypes) as the CPU tensor of the same
    bits."""
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bits(t):
    if isinstance(t, np.ndarray):
        return t.view(np.uint8)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.contiguous().numpy().view(np.uint8)


def _rows(rng, dt, shape):
    if dt is np.int8:
        return rng.integers(-127, 128, size=shape).astype(np.int8)
    x = rng.standard_normal(shape) * RANGES[dt]
    # exact ties on the int4 grid: halfway codes round half to even
    x[..., 0] = 7.0
    x[..., 1:4] = [3.5, -2.5, 0.5]
    return x.astype(dt)


# ---------------------------------------------------------------------------
# int4 rung (core/cache.py), bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [5, 8, 33, 128])
@pytest.mark.parametrize("dt", [np.float32, ml_dtypes.bfloat16, np.int8])
def test_int4_codes_scales_and_packing_equal_reference(dt, n):
    rng = np.random.default_rng(n)
    x = _rows(rng, dt, (3, 4, n))
    jq, js = jcache.quant_rows_int4(x)
    tq, ts = tcache.quant_rows_int4(_host(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    jp, tp = jcache.pack_int4(jq), tcache.pack_int4(tq)
    assert tp.dtype == torch.uint8 and tp.shape[-1] == (n + 1) // 2
    assert np.array_equal(tp.numpy(), jp)
    assert np.array_equal(tcache.unpack_int4(tp, n).numpy(),
                          jcache.unpack_int4(jp, n))
    assert np.array_equal(tcache.unpack_int4(tp, n).numpy(), jq)
    assert np.array_equal(_bits(tcache.dequant_rows_int4(tq, ts)),
                          _bits(jcache.dequant_rows_int4(jq, js)))


def test_int4_pack_unpack_roundtrip_every_code():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 1)
    for n in (1, 7, 16):
        q = codes[:, :n]
        assert torch.equal(tcache.unpack_int4(tcache.pack_int4(q), n), q)


@pytest.mark.parametrize("dt", [np.float32, ml_dtypes.bfloat16, np.int8])
def test_compress_payload_equals_reference(dt):
    """Packed bytes, scales, the CRC over them and the decompressed page
    (rounded back to int8 for int8 pages) equal the reference's; the
    scale plane rides along as a copy."""
    rng = np.random.default_rng(2)
    data = _rows(rng, dt, (2, 4, 8, 16))
    scale = rng.standard_normal((2, 4, 8)).astype(np.float32)
    jcp = jtiers.compress_payload({"data": data, "scale": scale})
    tpay = {"data": _host(data), "scale": torch.from_numpy(scale)}
    tcp = kv_tiers.compress_payload(tpay)
    assert np.array_equal(tcp["packed"].numpy(), jcp["packed"])
    assert np.array_equal(_bits(tcp["qscale"]), _bits(jcp["qscale"]))
    assert tcp["hd"] == jcp["hd"] == 16
    assert tcp["scale"].data_ptr() != tpay["scale"].data_ptr()
    assert (kv_tiers.payload_crc({"kg": [tcp]})
            == jtiers.payload_crc({"kg": [jcp]}))
    tout = kv_tiers.decompress_payload(tcp)
    jout = jtiers.decompress_payload(jcp)
    assert tout["data"].dtype == tpay["data"].dtype
    assert np.array_equal(_bits(tout["data"]), _bits(jout["data"]))
    assert torch.equal(tout["scale"], tpay["scale"])


# ---------------------------------------------------------------------------
# HostPagePool / HostSlabs / TierManager
# ---------------------------------------------------------------------------
def test_host_page_pool_semantics_and_slab_reuse():
    slabs = kv_tiers.HostSlabs(pin=False, pages_per_slab=2)
    pool = kv_tiers.HostPagePool(5, 8, slabs)          # 4 usable pages
    bufs = [slabs.take((2, 2), torch.float32) for _ in range(3)]
    for i, b in enumerate(bufs):
        b.fill_(i)
    pages = [pool.store({"data": b}) for b in bufs]
    assert pool.pages_in_use == 3
    # the bytes stored, not the two slabs of two buffers each
    assert pool.bytes_stored() == 3 * 16 and slabs.slab_bytes == 4 * 16
    for pg, b in zip(pages, bufs):
        assert pool.fetch(pg)["data"] is b
    pool.incref([pages[0]])
    pool.free([pages[0]])
    assert pool.fetch(pages[0])["data"] is bufs[0]     # freed at zero only
    pool.free([pages[0]])
    assert pages[0] not in pool._data
    # the buffer went back to its slab and is handed out again
    assert slabs.take((2, 2), torch.float32).data_ptr() == \
        bufs[0].data_ptr()
    out = []
    invariants._audit_pool("host", pool, out)
    assert out == []
    with pytest.raises(MemoryError):
        pool.alloc(4)


def test_pinned_slabs_pin_or_raise():
    """Pinned slabs are page-locked where CUDA exists; without it pinning
    raises (an engine pins only when its device is CUDA)."""
    slabs = kv_tiers.HostSlabs(pin=True)
    if torch.cuda.is_available():
        assert slabs.take((4,), torch.bfloat16).is_pinned()
    else:
        with pytest.raises(RuntimeError):
            slabs.take((4,), torch.bfloat16)
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(
        **ECFG, prefix_cache=True, kv_offload=True), device="cpu")
    assert core.tiers.slabs.pin is False


def _entries(mod_node, compressible=True):
    e = mod_node(key=(1,), kg_page=1, vg_page=2, parent=None)
    e.compressible = compressible
    return e


def _payload_pair(rng, n=1):
    """The same payloads as numpy (reference) and CPU tensors (port)."""
    arrs = {pk: [rng.standard_normal((2, 3, 8, 4)).astype(np.float32)
                 for _ in range(n)] for pk in ("kg", "vg")}
    return ({pk: [{"data": a} for a in v] for pk, v in arrs.items()},
            {pk: [{"data": torch.from_numpy(a.copy())} for a in v]
             for pk, v in arrs.items()})


def test_tier_manager_store_verify_fetch_release():
    rng = np.random.default_rng(3)
    jpl, tpl = _payload_pair(rng)
    jtm = jtiers.TierManager(8, host_pages={"dense": 8, "chai": 0},
                             comp_pages={"dense": 8, "chai": 0})
    ttm = kv_tiers.TierManager(8, host_pages={"dense": 8, "chai": 0},
                               comp_pages={"dense": 8, "chai": 0})
    je, te = _entries(JBlockNode), _entries(BlockNode)
    jtm.store_entry(je, jpl)
    ttm.store_entry(te, tpl)
    assert te.tier == kv_tiers.TIER_HOST and te.tier_crc == je.tier_crc != 0
    assert te.tier_pages == je.tier_pages
    assert ttm.verify_entry(te)
    got = ttm.fetch_entry(te)
    assert torch.equal(got["kg"][0]["data"], tpl["kg"][0]["data"])
    stored = ttm.host["dense"].fetch(te.tier_pages["kg"][0])
    stored["data"] = stored["data"] + 1.0           # caught by the CRC
    assert not ttm.verify_entry(te)
    ttm.release_entry(te)
    assert ttm.host["dense"].pages_in_use == 0 and te.tier_pages == {}


def _ladder(mod, node_cls, pl):
    """The reference's ladder test as one call sequence on ``mod``;
    returns what each step observed."""
    dropped, log = [], []
    tm = mod.TierManager(8, host_pages={"dense": 2, "chai": 0},
                         comp_pages={"dense": 2, "chai": 0})
    tm.drop_hook = lambda e: (dropped.append(e), tm.discard_entry(e))
    tm.droppable_hook = lambda e: True
    comp = _entries(node_cls)
    tm.store_entry(comp, pl[0])
    log.append(tm.make_room({"dense": 2}))
    log.append((comp.tier, comp.tier_crc, tm.verify_entry(comp),
                tm.tier_pages(), tm.tier_bytes(), dict(tm.transitions)))
    snap_like = _entries(node_cls, compressible=False)
    tm.store_entry(snap_like, pl[1])
    log.append(tm.make_room({"dense": 2}))
    log.append((dropped == [snap_like], snap_like.tier_pages))
    another = _entries(node_cls)
    tm.store_entry(another, pl[2])
    log.append(tm.make_room({"dense": 2}))
    log.append((comp in dropped, tm.tier_pages(), tm.stats()))
    log.append(tm.make_room({"dense": 99}))
    return log


def test_tier_manager_ladder_matches_reference():
    """make_room walks host -> compressed -> gone: a compressible victim
    re-codes to int4 (restamped over the packed arrays), an
    uncompressible one drops, a compressed resident sheds when its pool
    overflows, and an impossible request fails fast: every step as the
    reference's, CRCs and transitions included."""
    rng = np.random.default_rng(4)
    pairs = [_payload_pair(rng) for _ in range(3)]
    got = _ladder(kv_tiers, BlockNode, [t for _, t in pairs])
    want = _ladder(jtiers, JBlockNode, [j for j, _ in pairs])
    assert got == want
    assert got[0] and got[1][0] == kv_tiers.TIER_COMP and got[1][2]
    assert got[-1] is False


# ---------------------------------------------------------------------------
# page fetch / put (launch/steps.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["", "int8"], ids=["float", "int8"])
def test_page_fetch_put_roundtrip_is_exact(kv_dtype):
    """A page read out to host buffers and written into another page
    equals the first, every plane (the int8 scales too); the pages
    around it are untouched."""
    _, tcfg, _, _ = _model()
    cfg = tcfg.replace(kv_cache_dtype=kv_dtype)
    st = tcache.init_paged_state(cfg, 2, 64, page_size=8, dense_pages=9,
                                 chai_pages=5, chai=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for key, t in st.items():
        if t.is_floating_point():
            t.copy_(torch.randn(t.shape, generator=gen))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen))
    slabs = kv_tiers.HostSlabs(pin=False)
    for kind, key in (("dense", "kvp"), ("chai", "cp")):
        fetch = steps_mod.make_page_fetch(cfg, kind)
        put = steps_mod.make_page_put(cfg, kind)
        before = {k: t.clone() for k, t in st.items()}
        payload = fetch(st, 3, slabs.take)
        assert set(payload) == ({"data", "scale"} if kv_dtype == "int8"
                                else {"data"})
        assert torch.equal(payload["data"], st[key][:, 3])
        put(st, 1, payload)
        for k in st:
            if k in (key, key + "_scale"):
                assert torch.equal(st[k][:, 1], before[k][:, 3]), k
                keep = [p for p in range(st[k].shape[1]) if p != 1]
                assert torch.equal(st[k][:, keep], before[k][:, keep])
            else:
                assert torch.equal(st[k], before[k]), k


# ---------------------------------------------------------------------------
# engine integration: demote -> promote, bitwise
# ---------------------------------------------------------------------------
def _family_prompts(n, *, prefix_blocks=2, ps=8, seed=0, vocab=64):
    """The reference's tier workload: prompts sharing a whole-block prefix
    with private suffixes."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=prefix_blocks * ps).tolist()
    return [prefix + rng.integers(1, vocab, size=ps).tolist()
            for _ in range(n)]


def _watch_pages(core):
    """Record every demoted entry's device pages as they were before the
    demotion, and check at each promotion that the new pages equal them
    (``torch.equal``); returns the list of pages checked."""
    before, checked = {}, []
    demote, promote = core._demote_entry, core._promote_entry
    planes = {"dense": ("kvp", "kvp_scale"), "chai": ("cp", "cp_scale")}

    def read(pages_by_pk):
        st = core._dev_state
        return {pk: [{k: st[k][:, p].clone()
                      for k in planes[kv_tiers.POOL_OF[pk]] if k in st}
                     for p in pages] for pk, pages in pages_by_pk.items()}

    def watched_demote(entry):
        pages = core._entry_device_pages(entry)
        held = read(pages)
        ok = demote(entry)
        if ok:
            before[id(entry)] = held
        return ok

    def watched_promote(entry, **kw):
        ok = promote(entry, **kw)
        if ok:
            now = read(core._entry_device_pages(entry))
            want = before.pop(id(entry))
            assert now.keys() == want.keys()
            for pk in now:
                for a, b in zip(now[pk], want[pk]):
                    assert all(torch.equal(a[k], b[k]) for k in a)
                    checked.append(pk)
        return ok

    core.prefix_cache.demote_hook = watched_demote
    core._promote_entry = watched_promote
    return checked


def _serial(cores, prompts, max_new=8):
    """Each prompt through both cores, drained before the next (the most
    reuse a prompt can get); tokens held equal, every one a full budget."""
    treqs = []
    for p in prompts:
        jreqs, tr = _submit(cores, [p], max_new_tokens=max_new)
        for core in cores:
            _drain(core)
        assert [list(r.generated) for r in tr] == \
            [list(r.generated) for r in jreqs]
        assert tr[0].finish_reason == "length"
        treqs += tr
    return treqs


def _hold_tiers(cores):
    jcore, tcore = cores
    assert tcore.tier_stats() == jcore.tier_stats()
    assert tcore.prefix_stats() == jcore.prefix_stats()
    assert invariants.audit_leaks(tcore) == []


def test_demoted_radix_blocks_promote_bitwise():
    """Prefix families past the device pool: evictions demote to the host,
    the extensions hit the demoted blocks, promotion restores their pages
    bit for bit; tokens equal the reference's and an all-device run's."""
    rng = np.random.default_rng(55)
    base = _family_prompts(4, seed=5)
    workload = base + [p + rng.integers(1, 64, size=8).tolist()
                       for p in base[:2]]
    cores = _cores(batch_slots=1, prefix_cache=True, kv_offload=True,
                   num_pages=12, host_pages=64, tier_prefetch=False)
    checked = _watch_pages(cores[1])
    treqs = _serial(cores, workload)
    _hold_tiers(cores)
    tcore = cores[1]
    st, ts = tcore.prefix_stats(), tcore.tier_stats()
    assert st["demoted_blocks"] > 0 and st["promoted_blocks"] > 0
    assert ts["transitions"]["hot->host/dense"] > 0
    assert ts["transitions"]["host->hot/dense"] > 0
    assert len(checked) == 2 * st["promoted_blocks"]
    clean = _clean(tcore, *[[p] for p in workload], batch_slots=1,
                   prefix_cache=True)
    assert [r.generated for r in treqs] == [r.generated for r in clean]


def test_demoted_snapshot_promotes_bitwise():
    """A CHAI snapshot demoted under pressure promotes at the next hit of
    its prompt (its clustered K and dense V pages bit for bit) and the
    resumed decode gives the reference's and an all-device run's
    tokens."""
    rng = np.random.default_rng(6)
    prompt = rng.integers(1, 64, size=16).tolist()
    workload = [prompt] + _family_prompts(3, seed=7) + [prompt]
    cores = _cores(batch_slots=1, prefix_cache=True, kv_offload=True,
                   num_pages=12, num_chai_pages=12, tier_prefetch=False)
    checked = _watch_pages(cores[1])
    treqs = _serial(cores, workload)
    _hold_tiers(cores)
    st = cores[1].prefix_stats()
    assert st["demoted_snapshots"] > 0 and st["promoted_snapshots"] > 0
    assert treqs[-1].cache_hit == "snapshot"
    assert {"kc", "vg"} <= set(checked)
    clean = _clean(cores[1], *[[p] for p in workload], batch_slots=1,
                   prefix_cache=True)
    assert [r.generated for r in treqs] == [r.generated for r in clean]


def _compressed_workload():
    """Six families through a 2-page host pool (their suffix blocks spill
    to the int4 rung), then the first prompt extended by a block, whose
    match runs through its compressed suffix block."""
    base = _family_prompts(6, seed=8)
    ext = np.random.default_rng(1).integers(1, 64, size=8).tolist()
    return base + [base[0] + ext]


def test_compressed_hit_replans_cold_with_parity():
    """A host pool too small for the demoted set spills radix blocks to
    the int4 rung; a hit on one (``lossy_promote=False``) drops it and
    re-plans cold: the reference's tokens and an all-device run's."""
    workload = _compressed_workload()
    cores = _cores(batch_slots=1, prefix_cache=True, kv_offload=True,
                   num_pages=12, host_pages=2, compressed_pages=16,
                   tier_prefetch=False)
    treqs = _serial(cores, workload)
    _hold_tiers(cores)
    ts = cores[1].tier_stats()
    assert ts["transitions"].get("host->compressed/dense", 0) > 0
    assert ts["transitions"].get("compressed->gone/dense", 0) > 0
    assert "compressed->hot/dense" not in ts["transitions"]
    clean = _clean(cores[1], *[[p] for p in workload], batch_slots=1,
                   prefix_cache=True)
    assert [r.generated for r in treqs] == [r.generated for r in clean]


def test_lossy_promote_serves_the_int4_page():
    """``lossy_promote=True``: a compressed hit promotes the dequantized
    page (compressed -> hot) and the request completes; the reference's
    transitions and counters."""
    workload = _compressed_workload()
    cores = _cores(batch_slots=1, prefix_cache=True, kv_offload=True,
                   num_pages=12, host_pages=2, compressed_pages=16,
                   tier_prefetch=False, lossy_promote=True)
    for p in workload:
        _submit(cores, [p])
        for core in cores:
            _drain(core)
    jcore, tcore = cores
    assert tcore.tier_stats() == jcore.tier_stats()
    assert tcore.tier_stats()["transitions"].get(
        "compressed->hot/dense", 0) > 0
    assert all(r.finish_reason == "length" for r in tcore.done)
    assert invariants.audit_leaks(tcore) == []


def test_prefetch_promotes_ahead_of_admission():
    """``add_request`` queues the demoted entries a prompt will hit;
    ``step()`` promotes them before planning (``prefetch_hits``), with the
    reference's counters and metrics."""
    rng = np.random.default_rng(9)
    base = _family_prompts(4, seed=9)
    cores = _cores(batch_slots=1, prefix_cache=True, kv_offload=True,
                   num_pages=12, host_pages=64, telemetry="basic")
    _serial(cores, base + [base[0] + rng.integers(1, 64, size=8).tolist()])
    _hold_tiers(cores)
    tcore = cores[1]
    assert tcore.prefix_stats()["demoted_blocks"] > 0
    ts = tcore.tier_stats()
    assert ts["prefetch_hits"] + ts["prefetch_misses"] > 0
    snap = tcore.metrics()
    assert "tier_transitions_total" in snap["counters"]
    assert "kv_tier_pages" in snap["gauges"]
    want = cores[0].metrics()
    for kind in ("counters", "gauges"):
        assert snap[kind].keys() == want[kind].keys()


def test_over_capacity_workload_is_leak_free():
    """Three waves of families, several times the device pool, two slots:
    the ladder runs, every step's deep audit is clean and the idle engine
    leaks nothing in any pool, device or host."""
    cores = _cores(batch_slots=2, prefix_cache=True, kv_offload=True,
                   num_pages=14)
    for i in range(3):
        _submit(cores, _family_prompts(4, seed=20 + i))
        for core in cores:
            _drain(core)
    jcore, tcore = cores
    assert tcore.tier_stats()["transitions"]
    assert tcore.tier_stats() == jcore.tier_stats()
    assert invariants.audit_leaks(tcore) == []
    assert all(r.finish_reason == "length" for r in tcore.done)


def test_orphaned_host_page_fails_the_audit():
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(
        **ECFG, prefix_cache=True, kv_offload=True), device="cpu")
    core.add_request(_family_prompts(1, seed=30)[0],
                     SamplingParams(max_new_tokens=8))
    _drain(core)
    assert invariants.audit_leaks(core) == []
    core.tiers.store_pages(
        "dense", [{"data": torch.zeros((2, 3, 8, 4))}])
    problems = invariants.audit_leaks(core)
    assert any("host_pool[dense]" in v for v in problems)


def test_kv_offload_requires_paged_layout():
    _, tcfg, _, tparams = _model()
    with pytest.raises(ValueError, match="kv_offload"):
        EngineCore(tcfg, tparams, EngineConfig(
            **{**ECFG, "kv_layout": "dense"}, kv_offload=True),
            device="cpu")


def test_cleared_cache_empties_every_pool():
    """After a run, ``clear()`` demotes what is hot; dropping the demoted
    entries then leaves the device and the host pools empty."""
    rng = np.random.default_rng(55)
    base = _family_prompts(4, seed=5)
    _, tcfg, _, tparams = _model()
    core = EngineCore(tcfg, tparams, EngineConfig(
        **{**ECFG, "batch_slots": 1}, prefix_cache=True, kv_offload=True,
        num_pages=12, host_pages=64), device="cpu")
    for p in base + [base[0] + rng.integers(1, 64, size=8).tolist()]:
        core.add_request(p, SamplingParams(max_new_tokens=8))
        _drain(core)
    cache = core.prefix_cache
    cache.clear()
    assert core.dense_pool.pages_in_use == core.chai_pool.pages_in_use == 0
    for lru in core.tiers._lru.values():
        for e in list(lru.values()):
            cache.drop_demoted(e)
    assert all(n == 0 for n in core.tiers.tier_pages().values())
    assert cache.num_blocks == cache.num_snapshots == 0
    assert invariants.audit_leaks(core) == []
