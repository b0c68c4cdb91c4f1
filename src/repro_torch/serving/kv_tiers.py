"""Hierarchical KV tiers: a host-memory page pool and an int4 compressed tier.

Without tiers every byte the paged engine keeps (active slots, radix
prefix pages, CHAI snapshots) lives in device memory, so the prefix
cache's capacity is bounded by it. This module adds a capacity ladder
below the device pools:

    hot (device)  ->  host (exact copy)  ->  compressed (int4)  ->  gone

* ``HostPagePool`` mirrors the device ``PagePool`` allocator (the same
  free list, refcounts and freed-at-zero, so the invariant auditor's pool
  checks apply unchanged), and each allocated page carries a host payload:
  ONE physical device page read across every global layer
  (``{"data"[, "scale"]}``, see ``launch.steps.make_page_fetch``), as CPU
  tensors.

* ``HostSlabs`` is where those payloads live: page-shaped buffers carved
  from slabs allocated on first use and reused after a page is freed, in
  pinned (page-locked) memory when the engine runs on CUDA, so a page
  crosses the host link in one asynchronous copy. ``HostPagePool`` counts
  the bytes it stores, not the slabs.

* ``TierManager`` owns per-kind (dense / clustered) host pools plus an
  optional int4 compressed pool. Demotion stores a device page's payload
  in a host page; promotion is the inverse write (``make_page_put``).
  Under host pressure the manager walks its own LRU: compressible entries
  (radix blocks) are re-coded to packed int4 (symmetric per row,
  ``core.cache.quant_rows_int4``); entries that cannot compress (CHAI
  snapshots: their replay is bitwise) or already did are dropped through
  ``drop_hook`` (the prefix cache's ``drop_demoted``).

* Integrity: demotion stamps a CRC32 over the stored payload
  (``faults.checksum_arrays``); promotion verifies it before any byte
  reaches the device, and compression restamps over the packed arrays.
  A mismatch (the ``offload.out`` corrupt arm) drops the entry and the
  request re-plans cold: corruption never crosses tiers.

The manager is host bookkeeping only; the engine owns the device side
(the page reads and writes, which entries demote, when to prefetch) and
wires ``on_transition`` into telemetry.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.cache import (PagePool, dequant_rows_int4, pack_int4,
                                    quant_rows_int4, unpack_int4)
from repro_torch.serving.faults import checksum_arrays

# Tier names (also the ``tier`` label values in telemetry).
TIER_HOT = "hot"
TIER_HOST = "host"
TIER_COMP = "compressed"
TIER_GONE = "gone"

#: payload kind -> pool kind (which pool a cached page list lives in)
POOL_OF = {"kg": "dense", "vg": "dense", "kc": "chai", "vc": "chai"}

#: page buffers carved from one host slab
SLAB_PAGES = 16


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _nbytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return int(v.nbytes)


def payload_crc(payloads: Dict[str, List[dict]]) -> int:
    """Order-stable CRC32 over the array leaves of per-kind payload lists
    (metadata such as the dtype and width markers is excluded)."""
    tree = {
        pk: {str(i): {k: v for k, v in p.items() if _is_array(v)}
             for i, p in enumerate(plist)}
        for pk, plist in payloads.items()
    }
    return checksum_arrays(tree)


def compress_payload(payload: dict) -> dict:
    """Re-code one host page payload to packed int4: symmetric per-row
    quantization over the head dim, two codes per byte. The int8 configs'
    scale plane (small) rides along uncompressed, as a copy: the host
    page it came from goes back to its slab."""
    data = payload["data"]
    q, qscale = quant_rows_int4(data)
    out = {"packed": pack_int4(q), "qscale": qscale,
           "hd": int(data.shape[-1]), "dtype": data.dtype}
    if "scale" in payload:
        out["scale"] = payload["scale"].clone()
    return out


def decompress_payload(cp: dict) -> dict:
    """Inverse of ``compress_payload`` (lossy: int4 resolution)."""
    x = dequant_rows_int4(unpack_int4(cp["packed"], cp["hd"]), cp["qscale"])
    dt = cp["dtype"]
    if not dt.is_floating_point:
        x = torch.round(x)
    out = {"data": x.to(dt)}
    if "scale" in cp:
        out["scale"] = cp["scale"]
    return out


class HostSlabs:
    """Page-shaped host buffers, carved ``SLAB_PAGES`` at a time from one
    allocation per (shape, dtype) and reused once given back. ``pin``:
    page-locked memory (CUDA engines; pinning raises on a machine without
    CUDA, and a failed pin raises here)."""

    def __init__(self, pin: bool, pages_per_slab: int = SLAB_PAGES):
        self.pin = bool(pin)
        self.pages_per_slab = int(pages_per_slab)
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._mine: set = set()        # data_ptr of every buffer carved
        self.slab_bytes = 0

    def take(self, shape, dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        free = self._free.setdefault(key, [])
        if not free:
            slab = torch.empty((self.pages_per_slab,) + key[0], dtype=dtype,
                               pin_memory=self.pin)
            if self.pin and not slab.is_pinned():
                raise RuntimeError("host KV slab could not be pinned")
            self.slab_bytes += _nbytes(slab)
            bufs = list(slab.unbind(0))
            self._mine.update(b.data_ptr() for b in bufs)
            free.extend(reversed(bufs))
        return free.pop()

    def give(self, buf):
        """Return a buffer ``take`` handed out (anything else is ignored:
        a compressed payload's tensors are plain CPU tensors)."""
        if isinstance(buf, torch.Tensor) and buf.data_ptr() in self._mine:
            self._free[(tuple(buf.shape), buf.dtype)].append(buf)


class HostPagePool(PagePool):
    """A ``PagePool`` whose pages carry host payloads.

    The device pool's allocator semantics (null page, free list,
    refcounts, freed-at-zero), so ``invariants._audit_pool`` audits it
    unchanged; each page in use maps to its payload dict in ``_data``,
    dropped (and its buffers given back to ``slabs``) when the last
    reference dies."""

    def __init__(self, num_pages: int, page_size: int,
                 slabs: Optional[HostSlabs] = None):
        super().__init__(num_pages, page_size)
        self._data: Dict[int, dict] = {}
        self.slabs = slabs

    def store(self, payload: dict) -> int:
        (page,) = self.alloc(1)
        self._data[page] = payload
        return page

    def fetch(self, page: int) -> dict:
        return self._data[int(page)]

    def free(self, pages):
        for p in pages:
            p = int(p)
            last = self._rc.get(p, 0) == 1
            super().free([p])
            if last:
                payload = self._data.pop(p, None)
                if payload is not None and self.slabs is not None:
                    for v in payload.values():
                        self.slabs.give(v)

    def bytes_stored(self) -> int:
        return int(sum(_nbytes(v) for payload in self._data.values()
                       for v in payload.values() if _is_array(v)))


class TierManager:
    """Owns the host and compressed pools and the demoted entries' LRUs.

    ``host_pages`` / ``comp_pages`` map pool kind ("dense" / "chai") to
    usable page counts (0: no such pool). Demoted cache entries
    (``BlockNode`` / ``ChaiSnapshot`` with ``tier`` != "hot") are filed in
    per-tier LRUs; under pressure ``make_room`` walks host -> compressed
    -> gone as the device cache walks its own LRU. ``pin``: the host
    pool's payload buffers in page-locked memory. The engine supplies:

    ``drop_hook(entry)``       structural drop (``drop_demoted``); must
                               release the entry's tier pages.
    ``droppable_hook(entry)``  False when a drop would strand a lock (a
                               radix subtree with a locked descendant);
                               compression is always safe, only drops
                               consult it.
    ``on_transition(frm, to, kind, n)``  the telemetry callback.
    """

    def __init__(self, page_size: int,
                 host_pages: Optional[Dict[str, int]] = None,
                 comp_pages: Optional[Dict[str, int]] = None,
                 on_transition: Optional[Callable] = None,
                 pin: bool = False):
        self.page_size = int(page_size)
        self.slabs = HostSlabs(pin)

        def build(spec, slabs):
            pools = {}
            for kind in ("dense", "chai"):
                n = int((spec or {}).get(kind, 0))
                pools[kind] = (HostPagePool(n + 1, page_size, slabs)
                               if n > 0 else None)
            return pools

        self.host = build(host_pages, self.slabs)
        self.comp = build(comp_pages, None)
        self._lru = {TIER_HOST: OrderedDict(), TIER_COMP: OrderedDict()}
        self.on_transition = on_transition
        self.drop_hook: Optional[Callable] = None
        self.droppable_hook: Optional[Callable] = None
        self.transitions: Dict[tuple, int] = {}

    # -- pools -------------------------------------------------------------
    def pools_of(self, tier: str) -> dict:
        return self.comp if tier == TIER_COMP else self.host

    # -- transition ledger -------------------------------------------------
    def record(self, frm: str, to: str, kind: str, n: int):
        if n <= 0:
            return
        key = (frm, to, kind)
        self.transitions[key] = self.transitions.get(key, 0) + int(n)
        if self.on_transition is not None:
            self.on_transition(frm, to, kind, int(n))

    # -- demoted-entry LRU bookkeeping -------------------------------------
    def file(self, entry):
        """(Re-)file a demoted entry at the MRU end of its tier's LRU.
        Locked or dropped entries stay out (the device cache's
        ``_lru_file`` rule)."""
        if getattr(entry, "locks", 0) or getattr(entry, "evicted", False):
            return
        lru = self._lru.get(entry.tier)
        if lru is None:
            return
        lru[id(entry)] = entry
        lru.move_to_end(id(entry))

    def unfile(self, entry):
        for lru in self._lru.values():
            lru.pop(id(entry), None)

    def touch(self, entry):
        lru = self._lru.get(getattr(entry, "tier", None))
        if lru is not None and id(entry) in lru:
            lru.move_to_end(id(entry))

    def pin(self, entry):
        self.unfile(entry)

    def unpin(self, entry):
        self.file(entry)

    # -- page-level ops (preemption payloads, no cache entry) --------------
    def store_pages(self, kind: str, payloads: List[dict]) -> List[int]:
        pool = self.host[kind]
        assert pool is not None, f"no host pool for kind {kind!r}"
        return [pool.store(p) for p in payloads]

    def fetch_pages(self, kind: str, pages) -> List[dict]:
        pool = self.host[kind]
        return [pool.fetch(p) for p in pages]

    def free_pages(self, kind: str, pages):
        """Release host pages; a page's buffers go back to the slabs with
        its last reference. On CUDA a copy still queued from them stays
        ordered before any later write into them: every write comes from
        a copy on the same stream, or from the host after an event that
        follows it."""
        if pages:
            self.host[kind].free(pages)

    # -- entry-level ops ---------------------------------------------------
    def store_entry(self, entry, payloads: Dict[str, List[dict]]):
        """Demote: store per-payload-kind page payloads in host pages,
        stamp the CRC and file the entry in the host LRU. The caller (the
        engine) frees the device pages and records hot -> host. The
        payloads must have landed on the host (the CRC reads them)."""
        entry.tier_crc = payload_crc(payloads)
        entry.tier_pages = {
            pk: self.store_pages(POOL_OF[pk], plist)
            for pk, plist in payloads.items() if plist
        }
        entry.tier = TIER_HOST
        self.file(entry)

    def fetch_entry(self, entry) -> Dict[str, List[dict]]:
        """Payloads ready for the device write (decompressed when the entry
        rode the int4 tier)."""
        comp = entry.tier == TIER_COMP
        pools = self.pools_of(entry.tier)
        out = {}
        for pk, pages in entry.tier_pages.items():
            raw = [pools[POOL_OF[pk]].fetch(p) for p in pages]
            out[pk] = [decompress_payload(p) for p in raw] if comp else raw
        return out

    def verify_entry(self, entry) -> bool:
        """CRC the stored payloads against the demotion / compression
        stamp: corruption is caught before any dequantization or device
        write."""
        pools = self.pools_of(entry.tier)
        raw = {pk: [pools[POOL_OF[pk]].fetch(p) for p in pages]
               for pk, pages in entry.tier_pages.items()}
        return payload_crc(raw) == entry.tier_crc

    def _free_tier_pages(self, entry):
        pools = self.pools_of(entry.tier)
        for pk, pages in (entry.tier_pages or {}).items():
            if pages:
                pools[POOL_OF[pk]].free(pages)
        entry.tier_pages = {}
        self.unfile(entry)

    def release_entry(self, entry):
        """Free tier storage on PROMOTION (the caller re-homes the entry
        in device pages and records -> hot)."""
        self._free_tier_pages(entry)

    def discard_entry(self, entry):
        """Free tier storage on a structural DROP: records -> gone."""
        counts = self._entry_page_counts(entry)
        tier = entry.tier
        self._free_tier_pages(entry)
        for kind, n in counts.items():
            self.record(tier, TIER_GONE, kind, n)

    # -- pressure: the host -> compressed -> gone ladder -------------------
    def _entry_page_counts(self, entry) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for pk, pages in (entry.tier_pages or {}).items():
            kind = POOL_OF[pk]
            counts[kind] = counts.get(kind, 0) + len(pages)
        return counts

    def _short(self, need: Dict[str, int]) -> bool:
        for kind, n in need.items():
            if n <= 0:
                continue
            pool = self.host.get(kind)
            if pool is None or pool.free_pages < n:
                return True
        return False

    def _droppable(self, entry) -> bool:
        if self.drop_hook is None:
            return False
        if self.droppable_hook is not None and not self.droppable_hook(entry):
            return False
        return True

    def _comp_room(self, need: Dict[str, int]) -> bool:
        """Make room in the compressed pool by dropping ITS LRU tail."""
        def short():
            for kind, n in need.items():
                if n <= 0:
                    continue
                pool = self.comp.get(kind)
                if pool is None:
                    return None          # can never fit
                if pool.free_pages < n:
                    return True
            return False

        s = short()
        while s:
            victim = next((e for e in self._lru[TIER_COMP].values()
                           if self._droppable(e)), None)
            if victim is None:
                return False
            self.drop_hook(victim)
            s = short()
        return s is not None and not s

    def compress_entry(self, entry) -> bool:
        """Re-code a host-tier entry into the int4 pool. False when the
        compressed pool cannot cover it (after shedding its own LRU tail):
        the caller falls through to a structural drop."""
        if entry.tier != TIER_HOST or not getattr(entry, "compressible",
                                                  False):
            return False
        counts = self._entry_page_counts(entry)
        if not self._comp_room(counts):
            return False
        packed = {pk: [compress_payload(self.host[POOL_OF[pk]].fetch(p))
                       for p in pages]
                  for pk, pages in entry.tier_pages.items()}
        crc = payload_crc(packed)
        old = dict(entry.tier_pages)
        new_pages = {pk: [self.comp[POOL_OF[pk]].store(p) for p in plist]
                     for pk, plist in packed.items()}
        for pk, pages in old.items():
            self.host[POOL_OF[pk]].free(pages)
        self.unfile(entry)
        entry.tier_pages = new_pages
        entry.tier_crc = crc
        entry.tier = TIER_COMP
        self.file(entry)
        for kind, n in counts.items():
            self.record(TIER_HOST, TIER_COMP, kind, n)
        return True

    def make_room(self, need: Dict[str, int]) -> bool:
        """Free host pages until ``need`` fits: walk the host LRU from the
        front, compress compressible victims into the int4 pool, drop the
        rest (and compressed residents when their pool overflows). False
        when the ladder runs dry: the caller drops outright."""
        for kind, n in need.items():
            pool = self.host.get(kind)
            if n > 0 and (pool is None or n > pool.capacity):
                return False
        while self._short(need):
            progress = False
            for entry in list(self._lru[TIER_HOST].values()):
                counts = self._entry_page_counts(entry)
                helps = any(need.get(k, 0) > 0
                            and self.host[k].free_pages < need[k]
                            and counts.get(k, 0) > 0
                            for k in ("dense", "chai"))
                if not helps:
                    continue
                if self.compress_entry(entry):
                    progress = True
                elif self._droppable(entry):
                    self.drop_hook(entry)
                    progress = True
                if progress:
                    break
            if not progress:
                return False
        return True

    # -- introspection -----------------------------------------------------
    def tier_pages(self) -> Dict[tuple, int]:
        """{(tier, kind): pages in use} of the host-side tiers."""
        out = {}
        for tier, pools in ((TIER_HOST, self.host), (TIER_COMP, self.comp)):
            for kind, pool in pools.items():
                if pool is not None:
                    out[(tier, kind)] = pool.pages_in_use
        return out

    def tier_bytes(self) -> Dict[str, int]:
        return {tier: sum(p.bytes_stored() for p in pools.values()
                          if p is not None)
                for tier, pools in ((TIER_HOST, self.host),
                                    (TIER_COMP, self.comp))}

    def stats(self) -> dict:
        out = {"tier_pages": {f"{t}/{k}": v
                              for (t, k), v in self.tier_pages().items()},
               "tier_bytes": self.tier_bytes(),
               "transitions": {f"{f}->{t}/{k}": n
                               for (f, t, k), n in self.transitions.items()},
               "demoted_entries": {t: len(lru)
                                   for t, lru in self._lru.items()}}
        for tier, pools in (("host", self.host), ("compressed", self.comp)):
            for kind, pool in pools.items():
                if pool is not None:
                    out[f"{tier}_{kind}"] = pool.counters()
        return out
