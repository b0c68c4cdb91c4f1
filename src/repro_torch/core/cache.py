"""CHAI KV-cache layouts: cohort (dense -> clustered), unified per-slot,
and the paged layout the continuous engine serves from.

Three layouts, one phase machine (PREFILL -> WARMUP -> CLUSTER -> STEADY):

1. **Cohort** (``init_chai_state`` / ``compact_kv``): PREFILL fills dense
   ``kg``/``vg``; WARMUP accumulates clustering features in
   ``chai_scores``; ``compact_kv`` is §3.5's "remove the Key tokens
   associated [with pruned heads]": after membership identification the
   dense K cache is gathered down to the representative rows (``kg_chai``,
   ``k_max`` rows instead of H) and the dense K cache is dropped, which
   frees its memory once no other reference holds it.
2. **Unified per-slot** (``unified_state_shapes``,
   ``EngineConfig.kv_layout="dense"``): dense ``kg``/``vg`` AND clustered
   ``kg_chai`` rectangles resident side by side, with a per-slot ``phase``
   vector; ``insert_slot`` / ``compact_kv_slot`` / ``reset_slot`` move one
   slot through its lifecycle.
3. **Paged** (``paged_state_shapes``, the engine default): pages of
   ``page_size`` tokens spanning all global layers, drawn from two device
   pools (``kvp``: dense K/V rows, ``n_kv_heads`` wide; ``cp``: clustered
   rows, ``k_max`` wide), addressed through per-slot int32 block tables
   (``bt_kg``/``bt_vg`` -> ``kvp``, ``bt_kc`` -> ``cp``). Page 0 of every
   pool is the null sink: unallocated block-table entries point at it, so
   masked writes land there harmlessly and reads from it are always
   masked by ``pos``. ``PagePool`` is the host-side allocator.
   ``compact_kv_slot_paged`` gathers the representative rows into
   clustered pages and nulls the dense K block-table row; the engine then
   returns those pages to the pool (``paged_kv_bytes`` falls).

The reference's functions return new state trees; these update the state
tensors IN PLACE and return the same dict. Only bf16/fp32 caches are
ported (no int8, no ``share_values``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clustering import chai_widths
from repro_torch.models.transformer import (decode_state_shapes,
                                            init_decode_state, model_dtype,
                                            zeros_state)

# Per-slot lifecycle phases (paper Fig 10). PREFILL and CLUSTER are
# transient (they happen inside one host call); the device ``phase``
# vector only ever holds FREE / WARMUP / STEADY. The mixed decode step
# relies on the order (STEADY is the largest).
PHASE_FREE = 0
PHASE_PREFILL = 1
PHASE_WARMUP = 2
PHASE_CLUSTER = 3
PHASE_STEADY = 4

NULL_PAGE = 0   # reserved per-pool sink; never allocated, never read valid


def _check(cfg: ModelConfig):
    if cfg.kv_cache_dtype:
        raise NotImplementedError("int8 KV cache is not ported yet")
    if cfg.chai.share_values:
        raise NotImplementedError("share_values (CHAI-QKV) is not ported yet")


def _chai_on(cfg: ModelConfig, chai: bool) -> bool:
    return chai and cfg.chai.enabled and cfg.k_max > 0


# ---------------------------------------------------------------------------
# Cohort layout
# ---------------------------------------------------------------------------

def init_chai_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zero decode state in the clustered layout (MHA + CHAI archs):
    ``kg_chai`` (nG, B, k_max, S, hd) in place of ``kg``."""
    _check(cfg)
    state = init_decode_state(cfg, batch, max_seq, device)
    if not (cfg.is_mha and cfg.chai.enabled):
        return state
    k_max, _ = chai_widths(cfg)
    ng, b, _, s, hd = state.pop("kg").shape
    state["kg_chai"] = torch.zeros((ng, b, k_max, s, hd),
                                   dtype=state["vg"].dtype, device=device)
    return state


def add_score_buffer(state, cfg: ModelConfig, batch: int):
    """Attach the warmup score buffer (nA, B, H, Wf), Wf = min(feature
    window, S): probabilities of the first Wf positions, summed over the
    WARMUP steps (masked positions add exactly 0)."""
    wf = min(cfg.chai.feature_window, int(state["kg"].shape[3]))
    state = dict(state)
    state["chai_scores"] = torch.zeros(
        (cfg.n_attn_layers, batch, cfg.n_heads, wf), dtype=torch.float32,
        device=state["kg"].device)
    return state


def pop_score_buffer(state):
    state = dict(state)
    scores = state.pop("chai_scores")
    return state, scores


def compact_kv(state, chai_ctx, cfg: ModelConfig):
    """Dense MHA decode state -> clustered layout.

    state["kg"]: (nG, B, H, S, hd); ctx reps: (nA, B, k) or (nA, k).
    Returns a new state dict with ``kg_chai`` (nG, B, k, S, hd) and no
    ``kg``."""
    _check(cfg)
    if not (cfg.is_mha and cfg.chai.enabled):
        return state
    reps = chai_ctx["reps"].long()
    kg = state["kg"]
    ng, b = kg.shape[0], kg.shape[1]
    if reps.ndim == 2:
        reps = reps[:, None, :].expand(ng, b, reps.shape[-1])
    # All-global MHA archs: attention layer i == global layer i.
    li = torch.arange(ng, device=kg.device)[:, None, None]
    bi = torch.arange(b, device=kg.device)[None, :, None]
    new_state = {k: v for k, v in state.items() if k != "kg"}
    new_state["kg_chai"] = kg[li, bi, reps]
    return new_state


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                   chai: bool = False):
    """Analytic steady-state KV-cache size in bytes (paper Fig 11)."""
    _check(cfg)
    if cfg.n_attn_layers == 0:
        return 0
    esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
    k_max, _ = chai_widths(cfg)
    k_rows = (k_max if (chai and cfg.is_mha and cfg.chai.enabled)
              else cfg.n_kv_heads)
    per_layer = int(batch * (k_rows + cfg.n_kv_heads) * seq * cfg.head_dim
                    * esize)
    return per_layer * cfg.n_global_layers


# ---------------------------------------------------------------------------
# Unified per-slot layout (continuous batching, kv_layout="dense")
# ---------------------------------------------------------------------------

def _score_shape(cfg: ModelConfig, batch: int, max_seq: int):
    wf = min(cfg.chai.feature_window, max_seq)
    return ((cfg.n_attn_layers, batch, cfg.n_heads, wf), torch.float32)


def unified_state_shapes(cfg: ModelConfig, batch: int, max_seq: int, *,
                         chai: bool = True):
    """{name: (shape, dtype)} of the continuous engine's unified state:
    the dense decode state plus ``phase`` (B,) and, with CHAI,
    ``chai_scores`` and the clustered ``kg_chai`` (nG, B, k_max, S, hd)."""
    _check(cfg)
    shapes = dict(decode_state_shapes(cfg, batch, max_seq))
    shapes["phase"] = ((batch,), torch.int32)
    if not _chai_on(cfg, chai):
        return shapes
    shapes["chai_scores"] = _score_shape(cfg, batch, max_seq)
    if cfg.is_mha and "kg" in shapes:
        k_max, _ = chai_widths(cfg)
        (ng, b, _, s, hd), dt = shapes["kg"]
        shapes["kg_chai"] = ((ng, b, k_max, s, hd), dt)
    return shapes


def init_unified_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                       chai: bool = True, device):
    return zeros_state(unified_state_shapes(cfg, batch, max_seq, chai=chai),
                       device)


def _put_slot(state, key, value, slot):
    """Write a batch-1 tensor into batch slot ``slot`` of ``state[key]``
    (batch is axis 0 of 1-D entries, axis 1 of layer-stacked ones)."""
    dst = state[key]
    if dst.ndim == 1:
        dst[slot] = value[0]
    else:
        dst[:, slot] = value[:, 0].to(dst.dtype)


def insert_slot(state, mini, slot, *, phase=PHASE_WARMUP):
    """Write a freshly prefilled batch=1 decode state into batch slot
    ``slot`` of a unified state and reset the slot's CHAI bookkeeping."""
    for k, v in mini.items():
        _put_slot(state, k, v, slot)
    if "chai_scores" in state:
        state["chai_scores"][:, slot] = 0
    state["phase"][slot] = phase
    return state


def compact_kv_slot(state, slot_ctx, cfg: ModelConfig, slot):
    """Per-slot compaction (unified layout): gather ONE slot's
    representative K rows from the dense cache into the clustered cache
    and advance that slot's phase to STEADY. ``slot_ctx``: batch-free
    membership (reps (nA, k))."""
    if cfg.is_mha and cfg.chai.enabled and "kg_chai" in state:
        reps = slot_ctx["reps"].long()                    # (nA, k)
        kg = state["kg"]
        # All-global MHA archs: attention layer i == global layer i.
        li = torch.arange(kg.shape[0], device=kg.device)[:, None]
        state["kg_chai"][:, slot] = kg[li, slot, reps]
    state["phase"][slot] = PHASE_STEADY
    return state


def reset_slot(state, slot):
    """Retire a slot: mark FREE and rewind its write position."""
    state["phase"][slot] = PHASE_FREE
    state["pos"][slot] = 0
    return state


def unified_kv_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                     chai: bool = True):
    """Resident KV bytes of the unified layout: dense AND clustered
    rectangles stay allocated, summed from the layout's own shapes."""
    shapes = unified_state_shapes(cfg, batch, seq, chai=chai)
    return int(sum(torch.Size(shape).numel()
                   * torch.empty((), dtype=dt).element_size()
                   for k, (shape, dt) in shapes.items()
                   if k in ("kg", "vg", "kg_chai")))


# ---------------------------------------------------------------------------
# Paged layout (continuous batching, kv_layout="paged")
# ---------------------------------------------------------------------------

class PagePool:
    """Host-side page allocator for one device pool.

    ``num_pages`` is the pool tensor's page dimension; page ``NULL_PAGE``
    is reserved as the sink for unallocated block-table entries, so the
    usable capacity is ``num_pages - 1``. Allocation state lives on the
    host (the device only ever sees block tables). Pages are reference
    counted: ``alloc`` hands out pages at refcount 1, ``incref`` adds a
    sharer, ``free`` drops one reference and returns the page to the free
    list only when the count reaches zero.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "pool needs the null page plus capacity"
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # Free list: alloc takes from the front, free appends; page 0
        # excluded (the reference's order, so both hand out the same ids).
        self._free = list(range(self.num_pages - 1, NULL_PAGE, -1))
        self._rc: dict = {}            # page id -> reference count

    @property
    def capacity(self):
        return self.num_pages - 1

    @property
    def free_pages(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.capacity - len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc.get(int(page), 0)

    def counters(self) -> dict:
        """Free pages, pages in use and total outstanding references."""
        return {"free": len(self._free),
                "in_use": self.pages_in_use,
                "refs": int(sum(self._rc.values()))}

    def alloc(self, n: int):
        """Pop ``n`` pages at refcount 1; raises if the pool cannot
        cover them."""
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"of {self.capacity}")
        pages, self._free = self._free[:n], self._free[n:]
        for p in pages:
            self._rc[p] = 1
        return pages

    def incref(self, pages):
        """Add one reference per page (aliasing an allocated page)."""
        for p in pages:
            p = int(p)
            assert self._rc.get(p, 0) > 0, f"incref of free page {p}"
            self._rc[p] += 1

    def free(self, pages):
        """Drop one reference per page; a page returns to the free list
        when its count reaches zero (double-free / null-free guarded)."""
        for p in pages:
            p = int(p)
            assert p != NULL_PAGE, "freeing the null page"
            assert 0 < p < self.num_pages, p
            rc = self._rc.get(p, 0)
            assert rc > 0, f"double free of page {p}"
            if rc == 1:
                del self._rc[p]
                self._free.append(p)
            else:
                self._rc[p] = rc - 1


def pages_needed(tokens: int, page_size: int):
    return -(-int(tokens) // int(page_size))


def gather_pages(pool, bt):
    """Dense logical view of one pool through block tables (a copy).

    pool: (nP, rows, page[, hd]); bt: (B, P) int ->
    (B, rows, P*page[, hd]). Entries pointing at the null page yield
    garbage rows; callers mask by ``pos`` validity, exactly as the dense
    rectangles mask their zero tail."""
    m = pool[bt.long()].movedim(2, 1)          # (B, rows, P, page[, hd])
    b, rows, p, ps = m.shape[:4]
    return m.reshape((b, rows, p * ps) + tuple(m.shape[4:]))


def paged_state_shapes(cfg: ModelConfig, batch: int, max_seq: int, *,
                       page_size: int, dense_pages: int, chai_pages: int = 0,
                       chai: bool = True):
    """{name: (shape, dtype)} of the paged layout.

    The dense per-slot ``kg``/``vg`` rectangles are replaced by one shared
    pool ``kvp`` (nG, dense_pages, KV, page, hd) plus per-slot block
    tables ``bt_kg``/``bt_vg`` (B, max_seq / page); MHA+CHAI archs add
    the clustered pool ``cp`` (nG, chai_pages, k_max, page, hd) with table
    ``bt_kc``. ``pos``/``phase``/``chai_scores`` are the unified
    layout's."""
    _check(cfg)
    assert max_seq % page_size == 0, (max_seq, page_size)
    shapes = dict(decode_state_shapes(cfg, batch, max_seq))
    shapes["phase"] = ((batch,), torch.int32)
    bt = ((batch, max_seq // page_size), torch.int32)
    if cfg.n_global_layers:
        ng, kv, hd = cfg.n_global_layers, cfg.n_kv_heads, cfg.head_dim
        dt = shapes.pop("kg")[1]
        shapes.pop("vg")
        shapes["kvp"] = ((ng, dense_pages, kv, page_size, hd), dt)
        shapes["bt_kg"] = bt
        shapes["bt_vg"] = bt
    if not _chai_on(cfg, chai):
        return shapes
    shapes["chai_scores"] = _score_shape(cfg, batch, max_seq)
    if cfg.is_mha and "kvp" in shapes:
        k_max, _ = chai_widths(cfg)
        ng, hd = cfg.n_global_layers, cfg.head_dim
        shapes["cp"] = ((ng, chai_pages, k_max, page_size, hd),
                        shapes["kvp"][1])
        shapes["bt_kc"] = bt
    return shapes


def init_paged_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                     page_size: int, dense_pages: int, chai_pages: int = 0,
                     chai: bool = True, device):
    return zeros_state(paged_state_shapes(
        cfg, batch, max_seq, page_size=page_size, dense_pages=dense_pages,
        chai_pages=chai_pages, chai=chai), device)


def _scatter_pages(pool, x, pages):
    """Scatter a dense batch-1 rectangle into pool pages.

    pool: (nG, nP, rows, page, hd); x: (nG, 1, rows, S, hd); pages: (P,)
    with null padding, S == P * page. The padding entries all name page
    0, so several rows of one index-put land on the null page; which one
    wins does not matter, because page 0 is never read as valid."""
    ng, _, rows, s = x.shape[:4]
    page = pool.shape[3]
    m = x.reshape((ng, rows, s // page, page) + tuple(x.shape[4:]))
    pool[:, pages.long()] = m.movedim(2, 1).to(pool.dtype)


def insert_slot_paged(state, mini, slot, kg_pages, vg_pages, *,
                      bt_kg_row=None, bt_vg_row=None):
    """Paged ``insert_slot``: write a prefilled batch=1 dense decode state
    into slot ``slot``, scattering its global K/V rows into the slot's
    pages (``kg_pages``/``vg_pages``: (P,) int32, null-padded) and
    recording the block tables.

    A chunk of a chunked prefill passes SCATTER vectors that null every
    page outside the chunk (so the mini state's zero rows land in the
    null sink) and the slot's full logical -> physical mapping as
    ``bt_kg_row``/``bt_vg_row``. Default: block tables == scatter
    vectors. Every call re-anchors ``pos`` and zeroes the slot's
    clustering features."""
    for k, v in mini.items():
        if k not in ("kg", "vg"):
            _put_slot(state, k, v, slot)
    if "kvp" in state and "kg" in mini:
        _scatter_pages(state["kvp"], mini["kg"], kg_pages)
        _scatter_pages(state["kvp"], mini["vg"], vg_pages)
        state["bt_kg"][slot] = kg_pages if bt_kg_row is None else bt_kg_row
        state["bt_vg"][slot] = vg_pages if bt_vg_row is None else bt_vg_row
    if "chai_scores" in state:
        state["chai_scores"][:, slot] = 0
    state["phase"][slot] = PHASE_WARMUP
    return state


def compact_kv_slot_paged(state, slot_ctx, cfg: ModelConfig, slot,
                          kc_pages):
    """Paged per-slot compaction: gather slot ``slot``'s representative K
    rows out of its dense pages into the clustered pages ``kc_pages``
    ((P,) int32, null-padded), record them in ``bt_kc`` and null the
    dense K block-table row; the engine then hands the dense K pages back
    to the ``PagePool``. V stays in the dense pool until retire."""
    if cfg.is_mha and cfg.chai.enabled and "cp" in state:
        reps = slot_ctx["reps"].long()                       # (nA, k)
        kvp = state["kvp"]
        bt_row = state["bt_kg"][slot].long()                 # (P,)
        li = torch.arange(kvp.shape[0], device=kvp.device)[:, None, None]
        # (nG, P, k, page, hd); null-padded table entries gather page 0
        # and land on page 0 of the clustered pool (never read valid).
        g = kvp[li, bt_row[None, :, None], reps[:, None, :]]
        state["cp"][:, kc_pages.long()] = g
        state["bt_kg"][slot] = NULL_PAGE
        state["bt_kc"][slot] = kc_pages
    state["phase"][slot] = PHASE_STEADY
    return state


def reset_slot_paged(state, slot):
    """Paged retire: phase -> FREE, rewind ``pos``, null every block-table
    row (the engine frees the physical pages host-side)."""
    reset_slot(state, slot)
    for key in ("bt_kg", "bt_vg", "bt_kc"):
        if key in state:
            state[key][slot] = NULL_PAGE
    return state


def paged_page_bytes(cfg: ModelConfig, page_size: int, *, kind: str):
    """Bytes of ONE page (``page_size`` tokens x all global layers):
    kind="dense": ``n_kv_heads`` rows; kind="chai": ``k_max`` rows."""
    _check(cfg)
    if cfg.n_global_layers == 0:
        return 0
    rows = cfg.n_kv_heads if kind == "dense" else chai_widths(cfg)[0]
    esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
    return int(cfg.n_global_layers * rows * page_size * cfg.head_dim * esize)


def paged_kv_bytes(cfg: ModelConfig, page_size: int, dense_in_use: int,
                   chai_in_use: int = 0):
    """ALLOCATED KV bytes of the paged layout: pages in use times page
    bytes. It falls when a slot's dense K pages are freed at compaction,
    unlike the unified layout's constant dense + clustered residency."""
    return int(dense_in_use * paged_page_bytes(cfg, page_size, kind="dense")
               + chai_in_use * paged_page_bytes(cfg, page_size, kind="chai"))
