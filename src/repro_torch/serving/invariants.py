"""Runtime invariant auditor for the serving engine.

``audit(core)`` returns a list of violation strings (empty = clean). The
engine runs it at the end of every continuous ``step()``
(``EngineConfig.audit_level``): ``"basic"`` (the default) covers the
cheap host-side checks (allocator conservation, refcount accounting,
phase-machine legality, prefix-cache lock / residency consistency) and
``"deep"`` additionally reads the device block tables and phase vector
(one device-to-host transfer) and checks them against the host
bookkeeping (no freed or null-aliased writable pages, device/host phase
agreement). A non-empty audit raises ``EngineFault`` from ``step()``.

The invariants, spelled out:

* **Pool conservation**: for each ``PagePool``, free list + pages with a
  live refcount == capacity; no duplicate or null entries on the free
  list; every refcount strictly positive.
* **Reference accounting**: total outstanding references per pool ==
  references held by slot page lists + references held by the radix tree
  and snapshots (``PrefixCache.held_pages``). Nothing else may hold a
  page.
* **Phase legality**: empty slots are ``FREE`` with no pages, locks, or
  progress; occupied slots are in {PREFILL, WARMUP, STEADY}, a PREFILL
  slot has a chunked-prefill cursor, and progress counters stay within
  the request's budget.
* **Relay residency**: every cache entry a slot has locked is really
  locked (lock count >= 1) and, for radix nodes, its page pair still
  carries a live refcount. (A locked node merely *marked* evicted is
  survivable by design: relay groups dissolve and the slot decodes from
  its own page references; only freed-while-pinned pages are a breach.)
* **Block-table validity (deep)**: each slot's device block-table row
  mirrors its host page list exactly, the tail is the null sink, and
  every mapped page has a live refcount (no freed page reachable by a
  write).
* **Tier conservation**: each host / compressed ``HostPagePool``
  satisfies the same conservation law as the device pools, every
  referenced host page carries a stored payload (and no payload outlives
  its page), and the outstanding tier references are exactly those of
  the demoted prefix-cache entries.
* **NaN/Inf logits** are guarded separately on the decode path
  (``EngineCore._decode``) where the logits are in hand; the offending
  slot is quarantined rather than failing the audit.

``audit_leaks(core)`` is the idle-engine gate: every page reference must
be explained by the prefix cache and no cache entry may still be locked;
its ``audit`` covers the tier pools, so an orphaned host page fails it.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core import cache as chai_cache
from repro_torch.serving import kv_tiers as kv_tiers_mod
from repro_torch.serving.prefix_cache import BlockNode

_TABLES = (("kg", "bt_kg"), ("vg", "bt_vg"), ("kc", "bt_kc"),
           ("vc", "bt_vc"))


def _audit_pool(name: str, pool, out: List[str]):
    free = pool._free
    rc = pool._rc
    if len(set(free)) != len(free):
        out.append(f"{name}: duplicate pages on the free list")
    if chai_cache.NULL_PAGE in free:
        out.append(f"{name}: null page on the free list")
    bad_rc = [p for p, c in rc.items()
              if c <= 0 or not (0 < p < pool.num_pages)]
    if bad_rc:
        out.append(f"{name}: invalid refcount entries {sorted(bad_rc)}")
    overlap = set(free) & set(rc)
    if overlap:
        out.append(f"{name}: pages both free and referenced "
                   f"{sorted(overlap)}")
    if len(free) + len(rc) != pool.capacity:
        out.append(f"{name}: conservation broken — {len(free)} free + "
                   f"{len(rc)} live != capacity {pool.capacity}")


def _slot_refs(core):
    """(dense, chai) page references held by slot page lists."""
    dense = chai = 0
    for pages in core._slot_pages:
        dense += len(pages.get("kg", ())) + len(pages.get("vg", ()))
        chai += len(pages.get("kc", ())) + len(pages.get("vc", ()))
    return dense, chai


def _audit_refs(core, out: List[str]):
    slot_dense, slot_chai = _slot_refs(core)
    cache_dense = cache_chai = 0
    if core.prefix_cache is not None:
        cache_dense, cache_chai = core.prefix_cache.held_pages()
    for name, pool, held in (
            ("dense_pool", core.dense_pool, slot_dense + cache_dense),
            ("chai_pool", core.chai_pool, slot_chai + cache_chai)):
        if pool is None:
            continue
        refs = int(sum(pool._rc.values()))
        if refs != held:
            out.append(f"{name}: {refs} outstanding references but "
                       f"slots+cache account for {held}")


def _tier_held(core):
    """Host / compressed page references explained by the demoted
    prefix-cache entries and the swapped-out (queued) requests, keyed
    ``(tier, kind)``."""
    held = {}

    def add(tier, pages_by_pk):
        for pk, pages in pages_by_pk.items():
            key = (tier, kv_tiers_mod.POOL_OF[pk])
            held[key] = held.get(key, 0) + len(pages)

    cache = core.prefix_cache
    demoted = (kv_tiers_mod.TIER_HOST, kv_tiers_mod.TIER_COMP)
    if cache is not None:
        stack = [cache.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                stack.append(c)
                if c.tier in demoted:
                    add(c.tier, c.tier_pages)
        for snap in cache._snapshots.values():
            if snap.tier in demoted:
                add(snap.tier, snap.tier_pages)
    for req in core.queue:
        rs = req.resume_state
        if rs and rs.get("tier_pages"):
            add(kv_tiers_mod.TIER_HOST, rs["tier_pages"])
    return held


def _audit_tiers(core, out: List[str]):
    """Host / compressed pool conservation, payload / refcount agreement,
    and the cross-tier reference accounting."""
    tiers = getattr(core, "tiers", None)
    if tiers is None:
        return
    tier_of = {"host": kv_tiers_mod.TIER_HOST,
               "compressed": kv_tiers_mod.TIER_COMP}
    held = _tier_held(core)
    for tname, by_kind in (("host", tiers.host),
                           ("compressed", tiers.comp)):
        for kind, pool in by_kind.items():
            if pool is None:
                continue
            name = f"{tname}_pool[{kind}]"
            _audit_pool(name, pool, out)
            live, stored = set(pool._rc), set(pool._data)
            orphans = sorted(stored - live)
            if orphans:
                out.append(f"{name}: orphaned payloads for pages "
                           f"{orphans}")
            missing = sorted(live - stored)
            if missing:
                out.append(f"{name}: referenced pages with no payload "
                           f"{missing}")
            refs = int(sum(pool._rc.values()))
            want = held.get((tier_of[tname], kind), 0)
            if refs != want:
                out.append(f"{name}: {refs} outstanding references but "
                           f"demoted entries + swapped-out requests "
                           f"account for {want}")


def _audit_phases(core, out: List[str]):
    legal_occupied = (chai_cache.PHASE_PREFILL, chai_cache.PHASE_WARMUP,
                      chai_cache.PHASE_STEADY)
    for i, req in enumerate(core._slot_req):
        phase = int(core._phases[i])
        if req is None:
            if phase != chai_cache.PHASE_FREE:
                out.append(f"slot {i}: empty but phase {phase}")
            if core._slot_count[i]:
                out.append(f"slot {i}: empty but count "
                           f"{core._slot_count[i]}")
            if core.paged and core._slot_pages[i]:
                out.append(f"slot {i}: empty but holds pages "
                           f"{sorted(core._slot_pages[i])}")
            if core._slot_locked[i]:
                out.append(f"slot {i}: empty but holds cache locks")
            continue
        if phase not in legal_occupied:
            out.append(f"slot {i}: uid={req.uid} illegal phase {phase}")
        if phase == chai_cache.PHASE_PREFILL \
                and core._slot_prefill_state[i] is None:
            out.append(f"slot {i}: uid={req.uid} PREFILL without a "
                       "chunked-prefill cursor")
        budget = req.max_new_tokens
        if not 0 <= core._slot_count[i] <= budget:
            out.append(f"slot {i}: uid={req.uid} count "
                       f"{core._slot_count[i]} outside [0, {budget}]")


def _audit_locks(core, out: List[str]):
    for i, locked in enumerate(core._slot_locked):
        for e in locked:
            if e.locks < 1:
                out.append(f"slot {i}: pinned cache entry with lock "
                           f"count {e.locks}")
            # A locked node marked ``evicted`` is survivable BY DESIGN
            # (relay groups dissolve; the slot holds its own page refs);
            # the breach is a pinned block whose PAGES were freed.
            if isinstance(e, BlockNode) and core.dense_pool is not None:
                for kind, page in (("kg", e.kg_page), ("vg", e.vg_page)):
                    if core.dense_pool.refcount(int(page)) < 1:
                        out.append(
                            f"slot {i}: pinned radix block's {kind} "
                            f"page {page} was freed while locked "
                            "(relay residency breach)")


def _device_tables(st):
    """The block tables and the phase vector of the device state, read in
    ONE device-to-host transfer: ({kind: (B, P) array}, (B,) phases)."""
    names = [(kind, key) for kind, key in _TABLES if key in st]
    parts = [st[key].to(torch.int32) for _, key in names]
    parts.append(st["phase"].to(torch.int32)[:, None])
    host = torch.cat(parts, dim=1).cpu().numpy()
    tables, col = {}, 0
    for kind, key in names:
        width = st[key].shape[1]
        tables[kind] = host[:, col:col + width]
        col += width
    return tables, host[:, col]


def _audit_device(core, out: List[str]):
    """Deep mode: device block tables + phase vector vs host truth."""
    st = core._dev_state
    if st is None:
        return
    pool_of = {"kg": core.dense_pool, "vg": core.dense_pool,
               "kc": core.chai_pool, "vc": core.chai_pool}
    tables, dev_phase = _device_tables(st)
    for i in range(core.ecfg.batch_slots):
        for kind, bt in tables.items():
            if kind in ("kc", "vc") \
                    and int(core._phases[i]) != chai_cache.PHASE_STEADY:
                # Clustered pages are RESERVED at admission (host page
                # list) but their block-table rows are written only at
                # the CLUSTER transition / snapshot restore: before
                # STEADY the device row is legitimately empty.
                continue
            row = bt[i]
            want = list(core._slot_pages[i].get(kind, ()))
            got = [int(p) for p in row[:len(want)]]
            if got != [int(p) for p in want]:
                out.append(f"slot {i}: bt_{kind} row {got} != host "
                           f"pages {want}")
                continue
            tail = row[len(want):]
            if want and (tail != chai_cache.NULL_PAGE).any():
                out.append(f"slot {i}: bt_{kind} tail not nulled past "
                           f"{len(want)} pages")
            dead = [int(p) for p in want
                    if pool_of[kind].refcount(int(p)) < 1]
            if dead:
                out.append(f"slot {i}: bt_{kind} maps freed pages "
                           f"{dead}")
    for i in range(core.ecfg.batch_slots):
        host = int(core._phases[i])
        dev = int(dev_phase[i])
        # Chunked mid-PREFILL slots park the device phase at FREE so the
        # interleaved decode skips them; otherwise host == device.
        want = (chai_cache.PHASE_FREE
                if host in (chai_cache.PHASE_FREE,
                            chai_cache.PHASE_PREFILL) else host)
        if dev != want:
            out.append(f"slot {i}: device phase {dev} != expected "
                       f"{want} (host {host})")


def audit(core, *, deep: bool = False) -> List[str]:
    """Audit one ``EngineCore``; returns violation strings (empty =
    clean). Safe to call between steps at any time."""
    out: List[str] = []
    if core.paged:
        _audit_pool("dense_pool", core.dense_pool, out)
        if core.chai_pool is not None:
            _audit_pool("chai_pool", core.chai_pool, out)
        _audit_refs(core, out)
        _audit_tiers(core, out)
    _audit_phases(core, out)
    _audit_locks(core, out)
    if deep and core.paged:
        _audit_device(core, out)
    return out


def audit_leaks(core) -> List[str]:
    """Leak gate for an IDLE engine (no active slots, empty queue): every
    outstanding page reference must be a prefix-cache reference and no
    cache entry may still be locked. The tier pools are covered by the
    ``audit`` below: every host page must belong to a demoted entry."""
    out = audit(core)
    if core.has_active or core.queue:
        return out          # not idle: conservation checks only
    for name, pool, cache_held in _idle_expectations(core):
        refs = int(sum(pool._rc.values()))
        if refs != cache_held:
            out.append(f"{name}: {refs - cache_held} leaked page "
                       f"reference(s) on an idle engine "
                       f"({refs} held, cache explains {cache_held})")
    if core.prefix_cache is not None:
        locked = _locked_entries(core.prefix_cache)
        if locked:
            out.append(f"prefix cache: {locked} dangling lock(s) on an "
                       "idle engine")
    return out


def _idle_expectations(core):
    cache_dense = cache_chai = 0
    if core.prefix_cache is not None:
        cache_dense, cache_chai = core.prefix_cache.held_pages()
    pairs = []
    if core.dense_pool is not None:
        pairs.append(("dense_pool", core.dense_pool, cache_dense))
    if core.chai_pool is not None:
        pairs.append(("chai_pool", core.chai_pool, cache_chai))
    return pairs


def _locked_entries(cache) -> int:
    n = 0
    stack = [cache.root]
    while stack:
        node = stack.pop()
        for c in node.children.values():
            n += c.locks > 0
            stack.append(c)
    for snap in cache._snapshots.values():
        n += snap.locks > 0
    return n
