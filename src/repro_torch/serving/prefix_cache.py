"""Shared-prefix KV reuse: a radix tree over token blocks + CHAI snapshots.

Requests that share a long prefix (a system prompt, a few-shot template)
can alias the pages an earlier request already filled and prefill only
their uncached suffix. This module indexes the engine's ``PagePool``
pages by prompt content:

* **Radix tree of blocks.** A block is ``page_size`` tokens, exactly one
  physical page per pool, so one radix node maps one token block to the
  (dense K, dense V) page pair holding it. Children are keyed by the next
  block's token tuple. Matching is capped at ``(len(prompt) - 1) //
  page_size`` blocks so at least one suffix token is always forwarded
  (its logits give the first token).

* **Reference counting + copy-on-write.** Cached pages are aliased into
  slot block tables with ``PagePool.incref``; ``free`` drops references
  and returns a page to the free list only at zero. Shared pages are
  read-only: a suffix prefill scatters through nulled scatter vectors,
  decode never writes below a slot's admission position, and the only
  writable shared page (a snapshot's partial tail) is copied at capture
  and at resume (``core.cache.copy_pool_page``).

* **CHAI snapshots.** Clustering features, membership, the compacted
  clustered pages and the greedy warmup tokens are pure functions of the
  prompt, so when a request finishes its CLUSTER transition the engine
  captures {membership, clustered K pages, dense V pages, warmup tokens,
  STEADY-entry ``pos``} keyed by the FULL prompt. A request with the same
  prompt replays the warmup tokens and enters STEADY directly.

* **Ordered-LRU eviction, pinned while in use.** Entries referenced by an
  active slot carry a lock count and are never evicted. Evictable entries
  (unlocked leaves and unlocked snapshots) live in one ``OrderedDict`` in
  last-use order; eviction pops the first entry holding pages of a pool
  that is short. Dropping an entry drops the cache's page references: a
  page shared with a still-active slot stays allocated until that slot
  retires. Evicting a node's last child files the parent (at the MRU
  end: an ``OrderedDict`` cannot insert mid-order).

* **KV tiers** (``serving.kv_tiers``, ``EngineConfig(kv_offload=True)``).
  Eviction becomes demotion: the engine's ``demote_hook`` copies an
  unlocked entry's pages to the host pool and releases its device pages,
  and the entry keeps its place (a radix slot or a snapshot key) with
  ``tier`` naming where its payload lives. Demoted entries sit in the
  tier manager's LRUs, not in this one; a hit on one promotes it back
  into fresh device pages. ``drop_demoted`` is the structural drop (the
  ladder's "gone" rung, and a failed promotion), ``_droppable`` its guard.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


def _block_key(tokens) -> Tuple[int, ...]:
    return tuple(int(t) for t in tokens)


@dataclasses.dataclass
class BlockNode:
    """One cached token block -> its (dense K, dense V) physical pages."""
    key: Tuple[int, ...]
    kg_page: int
    vg_page: int
    parent: Optional["BlockNode"]
    children: Dict[Tuple[int, ...], "BlockNode"] = \
        dataclasses.field(default_factory=dict)
    locks: int = 0                 # active slots aliasing this node
    # Relay decode (engine-owned): ``resident`` caches a packed contiguous
    # copy of the chain's prefix pages, keyed by the page lists it was
    # built from; ``evicted`` marks a node dropped from the tree, so relay
    # groups over it stop forming (the slots keep their own references).
    resident: Optional[tuple] = None
    evicted: bool = False
    # KV tiers: ``tier`` says where the block's payload lives. "hot":
    # ``kg_page``/``vg_page`` are live device pages; a demoted node keeps
    # its place in the tree (still matchable) with its payload in host or
    # compressed pages (``tier_pages``, CRC-stamped at demotion), and its
    # device page ids are stale until promotion rewrites them.
    tier: str = "hot"
    tier_pages: Dict[str, list] = dataclasses.field(default_factory=dict)
    tier_crc: int = 0
    prefetched: bool = False
    compressible: bool = True   # int4 rung allowed (a hit re-plans cold)

    @property
    def is_leaf(self):
        return not self.children

    @property
    def hot_leaf(self):
        """No hot children: the node holds the deepest device pages on its
        path, so evicting or demoting it strands nothing (demoted children
        stay in the tree, so ``is_leaf`` would keep the ancestors of
        demoted leaves out of the eviction order)."""
        return not any(c.tier == "hot" for c in self.children.values())


@dataclasses.dataclass
class ChaiSnapshot:
    """STEADY-entry state of a fully processed prompt.

    ``pos`` is the decode position at STEADY entry (prompt + warmup);
    ``tokens`` the greedy tokens generated through warmup (replayed on a
    hit); ``ctx`` the slot's batch-free membership; the page lists cover
    positions [0, pos): full pages shared, the partial tail page a
    cache-owned copy."""
    prompt: Tuple[int, ...]
    pos: int
    tokens: List[int]
    ctx: Dict[str, np.ndarray]
    vg_pages: List[int]            # dense pool ([] under share_values)
    kc_pages: List[int]            # clustered pool
    vc_pages: List[int] = dataclasses.field(default_factory=list)
    # ^ clustered pool: the clustered V pages (share_values only)
    locks: int = 0
    evicted: bool = False
    # KV tiers: snapshots ride the host tier only; their replay is bitwise,
    # so the lossy int4 rung is off-limits.
    tier: str = "hot"
    tier_pages: Dict[str, list] = dataclasses.field(default_factory=dict)
    tier_crc: int = 0
    prefetched: bool = False
    compressible: bool = False


class PrefixCache:
    """Radix-tree prefix index over one engine's page pools."""

    def __init__(self, dense_pool, chai_pool, page_size: int):
        self.dense_pool = dense_pool
        self.chai_pool = chai_pool
        self.page_size = int(page_size)
        self.root = BlockNode(key=(), kg_page=-1, vg_page=-1, parent=None)
        self._snapshots: Dict[Tuple[int, ...], ChaiSnapshot] = {}
        # Evictable entries in last-use order (front = LRU victim), keyed
        # by id(entry).
        self._lru: "OrderedDict[int, object]" = OrderedDict()
        # "partial_hits" counts every block-prefix reuse (a radix match is
        # capped below a full prompt); full-prompt reuse counts as
        # "snapshot_hits".
        self.stats = {"partial_hits": 0, "misses": 0,
                      "snapshot_hits": 0, "tokens_reused": 0,
                      "tokens_prefilled": 0, "inserted_blocks": 0,
                      "evicted_blocks": 0, "evicted_snapshots": 0,
                      "demoted_blocks": 0, "demoted_snapshots": 0,
                      "promoted_blocks": 0, "promoted_snapshots": 0}
        # KV tiers, wired by the engine: ``tiers`` owns the host and
        # compressed pools and the demoted entries' LRUs; ``demote_hook``
        # (the engine's ``_demote_entry``) turns eviction into demotion
        # under ``kv_offload``.
        self.tiers = None
        self.demote_hook = None

    # -- bookkeeping -------------------------------------------------------
    def _touch(self, entry):
        if id(entry) in self._lru:
            self._lru.move_to_end(id(entry))
        elif self.tiers is not None and entry.tier != "hot":
            self.tiers.touch(entry)     # demoted: recency lives tier-side

    def _lru_file(self, entry):
        """(Re-)file an entry at the MRU end if it is evictable: unlocked,
        not dropped, and a snapshot or a node with no hot child. A demoted
        entry files in its tier's LRU instead: this one holds hot entries
        only."""
        if entry.locks or entry.evicted:
            return
        if entry.tier != "hot":
            if self.tiers is not None:
                self.tiers.unpin(entry)
            return
        if isinstance(entry, BlockNode) and not entry.hot_leaf:
            return
        self._lru[id(entry)] = entry
        self._lru.move_to_end(id(entry))

    def _lru_drop(self, entry):
        self._lru.pop(id(entry), None)

    @property
    def num_blocks(self):
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += len(node.children)
            stack.extend(node.children.values())
        return n

    @property
    def num_snapshots(self):
        return len(self._snapshots)

    def held_pages(self):
        """(dense, chai) DEVICE page references the cache holds. Demoted
        entries hold none: their payloads live in tier pages, which the
        tier pools account for."""
        dense = chai = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            for c in node.children.values():
                if c.tier == "hot":
                    dense += 2                       # kg + vg
                stack.append(c)
        for snap in self._snapshots.values():
            if snap.tier != "hot":
                continue
            dense += len(snap.vg_pages)
            chai += len(snap.kc_pages) + len(snap.vc_pages)
        return dense, chai

    # -- dense block index -------------------------------------------------
    def match(self, prompt) -> List[BlockNode]:
        """Longest cached whole-block prefix of ``prompt``, capped so at
        least one token remains for the suffix prefill. Matched nodes are
        LRU-touched; the caller locks the ones it aliases."""
        ps = self.page_size
        out: List[BlockNode] = []
        node = self.root
        for j in range((len(prompt) - 1) // ps):
            child = node.children.get(_block_key(prompt[j * ps:(j + 1) * ps]))
            if child is None:
                break
            self._touch(child)
            out.append(child)
            node = child
        return out

    def insert(self, prompt, kg_pages, vg_pages) -> int:
        """Index every full block of ``prompt``; ``kg_pages``/``vg_pages``
        are its logical page lists (aliased prefix + the slot's fresh
        pages). New nodes take a cache reference on their pages; existing
        nodes are untouched. Returns the number of new nodes."""
        ps = self.page_size
        node, created = self.root, 0
        for j in range(len(prompt) // ps):
            key = _block_key(prompt[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                kg, vg = int(kg_pages[j]), int(vg_pages[j])
                self.dense_pool.incref([kg])
                self.dense_pool.incref([vg])
                child = BlockNode(key=key, kg_page=kg, vg_page=vg,
                                  parent=node)
                node.children[key] = child
                created += 1
                if node is not self.root:
                    self._lru_drop(node)    # grew a child: not a leaf
                self._lru_file(child)
            self._touch(child)
            node = child
        self.stats["inserted_blocks"] += created
        return created

    # -- CHAI snapshots ----------------------------------------------------
    def snapshot_for(self, prompt) -> Optional[ChaiSnapshot]:
        snap = self._snapshots.get(_block_key(prompt))
        if snap is not None:
            self._touch(snap)
        return snap

    def add_snapshot(self, snap: ChaiSnapshot):
        """Register a snapshot (its pages already carry the cache's
        references). One snapshot per exact prompt."""
        assert snap.prompt not in self._snapshots
        self._snapshots[snap.prompt] = snap
        self._lru_file(snap)
        self._touch(snap)

    def drop_snapshot(self, snap: ChaiSnapshot):
        """Remove a registered, unlocked snapshot and return its pages."""
        if self._snapshots.get(snap.prompt) is not snap or snap.locks:
            return
        self._lru_drop(snap)
        del self._snapshots[snap.prompt]
        snap.evicted = True
        self._release_entry_pages(snap)
        self.stats["evicted_snapshots"] += 1

    # -- pinning -----------------------------------------------------------
    def lock(self, entries):
        for e in entries:
            e.locks += 1
            self._lru_drop(e)           # pinned: never a victim
            if self.tiers is not None and e.tier != "hot":
                self.tiers.pin(e)       # ...in any tier

    def unlock(self, entries):
        for e in entries:
            assert e.locks > 0
            e.locks -= 1
            if e.locks == 0:
                self._lru_file(e)       # evictable again (if leaf/snap)

    # -- eviction and the tier ladder --------------------------------------
    def _release_entry_pages(self, entry):
        """Return an entry's pages wherever they live: the device pools for
        a hot entry (recording hot -> gone when a tier manager is wired),
        tier storage otherwise."""
        if entry.tier != "hot":
            self.tiers.discard_entry(entry)     # records -> gone itself
            entry.tier = "gone"
            return
        if isinstance(entry, ChaiSnapshot):
            dense, chai = len(entry.vg_pages), (len(entry.kc_pages)
                                                + len(entry.vc_pages))
            if entry.vg_pages:
                self.dense_pool.free(entry.vg_pages)
            if entry.kc_pages:
                self.chai_pool.free(entry.kc_pages)
            if entry.vc_pages:
                self.chai_pool.free(entry.vc_pages)
        else:
            dense, chai = 2, 0
            self.dense_pool.free([entry.kg_page])
            self.dense_pool.free([entry.vg_page])
        if self.tiers is not None:
            self.tiers.record("hot", "gone", "dense", dense)
            self.tiers.record("hot", "gone", "chai", chai)

    def _droppable(self, entry) -> bool:
        """True when a structural drop of ``entry`` (a node: its whole
        subtree) strands no lock: the tier manager's drop guard."""
        if isinstance(entry, ChaiSnapshot):
            return not entry.locks
        stack = [entry]
        while stack:
            node = stack.pop()
            if node.locks:
                return False
            stack.extend(node.children.values())
        return True

    def drop_demoted(self, entry):
        """Drop an entry from the cache whatever its tier or locks: the
        ladder's last rung ("gone") and the recovery of a failed promotion
        (the request re-plans cold). A node takes its subtree with it. A
        locked entry is tolerated: its lock holder is the plan dropping
        it, and ``evicted`` keeps its ``unlock`` from filing a ghost."""
        if isinstance(entry, ChaiSnapshot):
            if self._snapshots.get(entry.prompt) is not entry:
                return
            self._lru_drop(entry)
            del self._snapshots[entry.prompt]
            entry.evicted = True
            self._release_entry_pages(entry)
            self.stats["evicted_snapshots"] += 1
            return
        if entry.evicted:
            return
        parent = entry.parent
        parent.children.pop(entry.key, None)
        stack = [entry]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            node.children = {}
            node.evicted = True
            node.resident = None
            self._lru_drop(node)
            if self.tiers is not None:
                self.tiers.unfile(node)
            self._release_entry_pages(node)
            self.stats["evicted_blocks"] += 1
        if (parent is not self.root and parent.hot_leaf
                and parent.tier == "hot"):
            self._lru_file(parent)

    def _evict_one(self, want_dense=True, want_chai=True) -> bool:
        """Evict the least recently used evictable entry that holds pages
        of a wanted pool (nodes hold dense pages only). The pool targeting
        matters under share_values: its snapshots hold no dense page, and
        dropping one for dense pressure would free nothing wanted. With a
        ``demote_hook`` the victim demotes (keeping its place in the
        cache) unless the hook declines, and then drops. Returns False
        when nothing evictable matches."""
        victim = None
        for entry in self._lru.values():
            if isinstance(entry, BlockNode):
                holds = want_dense
            else:
                holds = ((want_dense and bool(entry.vg_pages))
                         or (want_chai and bool(entry.kc_pages
                                                or entry.vc_pages)))
            if holds:
                victim = entry
                break
        if victim is None:
            return False
        self._lru_drop(victim)
        if (self.demote_hook is not None and victim.tier == "hot"
                and self.demote_hook(victim)):
            if isinstance(victim, ChaiSnapshot):
                self.stats["demoted_snapshots"] += 1
            else:
                self.stats["demoted_blocks"] += 1
                parent = victim.parent
                if parent is not self.root and parent.tier == "hot":
                    self._lru_file(parent)  # no hot child now: evictable
            return True
        if isinstance(victim, ChaiSnapshot):
            del self._snapshots[victim.prompt]
            victim.evicted = True
            self._release_entry_pages(victim)
            self.stats["evicted_snapshots"] += 1
        else:
            # the subtree's drop releases any demoted descendant's tier
            # pages too and files the parent if it became evictable
            self.drop_demoted(victim)
        return True

    def evict_until(self, dense_free: int = 0, chai_free: int = 0) -> bool:
        """Evict LRU entries until the pools have the requested free
        pages; False if eviction ran dry first. Only entries holding
        references in a still-short pool are dropped (a dropped reference
        frees a page only when no active slot still shares it)."""
        def shortfall():
            dense = self.dense_pool.free_pages < dense_free
            chai = bool(chai_free and self.chai_pool is not None
                        and self.chai_pool.free_pages < chai_free)
            return dense, chai

        dense_short, chai_short = shortfall()
        while dense_short or chai_short:
            if not self._evict_one(want_dense=dense_short,
                                   want_chai=chai_short):
                return False
            dense_short, chai_short = shortfall()
        return True

    def clear(self):
        """Drop every cache reference (pages shared with active slots
        survive until those slots retire)."""
        while self._evict_one():
            pass
