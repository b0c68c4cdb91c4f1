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
   returns those pages to the pool (``paged_kv_bytes`` falls). The prefix
   cache shares pages between slots through the refcounts, copies a page
   it must not share (``copy_pool_page``) and resumes a slot from a CHAI
   snapshot (``restore_slot_snapshot``). Preemption swaps a slot's
   columns and page contents out (``save_slot_paged``) and back into
   fresh pages (``load_slot_paged``).

Under ``kv_cache_dtype="int8"`` every K/V rectangle and pool holds int8
codes beside a mirror-shaped fp32 scale tensor with the last axis dropped
(``kg_scale``/``vg_scale``/``kg_chai_scale``; ``kvp_scale``/``cp_scale``,
addressed by the same block tables): one scale a row (``quant_rows``).
Every move of codes (slot insert, compaction, page copy) moves their
scales with them; nothing is requantized.

``share_values`` (CHAI-QKV, MHA): V is clustered like K. The cohort and
unified layouts hold ``vg_chai`` (nG, B, k_max, S, hd) (the cohort in
place of ``vg``); the paged layout keeps clustered V pages in the ``cp``
pool, addressed by ``bt_vc``, and compaction frees the slot's dense V
pages too. As in the reference, clustered V carries no scales under int8:
compaction moves the dense V codes as they are and a decode step writes
its rows by a plain cast (``plain_int8``); the kernels read them as
values.

Local layers (gemma2, h2o-danube) keep rings ``kl``/``vl`` (nL, B, KV,
min(window, S), hd) in the model dtype in every layout: per slot and
never paged, as in the reference; a slot insert carries them with the
rest of the slot's state, and every byte count includes them.

The reference's functions return new state trees; these update the state
tensors IN PLACE and return the same dict.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.clustering import chai_widths
from repro_torch.models.transformer import (decode_state_shapes,
                                            init_decode_state, kv_int8,
                                            model_dtype, ring_width,
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


def quant_rows(x):
    """Symmetric int8 over the last axis, the reference's rule bit for
    bit. x: (..., hd) -> (int8 same shape, fp32 scale (...)). Every int8
    KV cache write goes through it (and the int8 QK kernel's inputs)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequant_rows(q, scale):
    """int8 codes (..., hd) and their fp32 scales (...) -> fp32 rows."""
    return q.float() * scale[..., None]


def plain_int8(x):
    """``x.astype(int8)`` as the reference's XLA convert gives it:
    truncation toward zero, saturated to [-128, 127], NaN to 0 (a torch
    cast wraps out-of-range values instead). The share_values clustered V
    rows enter an int8 cache this way, without a scale."""
    return torch.nan_to_num(x.float(), nan=0.0).clamp(-128, 127).to(
        torch.int8)


# -- int4 row quantization (the compressed KV tier) --------------------------
#
# Under host pressure the KV tiers (serving/kv_tiers.py) re-code demoted
# radix pages to int4: the symmetric per-row scheme of ``quant_rows`` with
# the extreme +-7 and two codes packed per byte. They run on host payloads
# (CPU tensors); codes, scales and packed bytes equal the reference's numpy
# versions bit for bit (``torch.round`` rounds half to even, as ``np.rint``).

def quant_rows_int4(x):
    """Symmetric int4 over the last axis. x: (..., hd) -> (int8 codes in
    [-7, 7] same shape, fp32 scale (...))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1), min=1e-6) / 7.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7)
    return q.to(torch.int8), scale


def dequant_rows_int4(q, scale):
    return q.to(torch.int8).float() * scale.float()[..., None]


def pack_int4(q):
    """Pack int4 codes (int8 values in [-8, 7]) two per byte along the
    last axis; an odd length is zero-padded. (..., n) int8 -> (...,
    ceil(n / 2)) uint8, the low nibble the even index."""
    q = q.to(torch.int8)
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros(q.shape[:-1] + (1,))], dim=-1)
    lo = (q[..., 0::2] & 0x0F).to(torch.uint8)
    hi = (q[..., 1::2] & 0x0F).to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed, n):
    """Inverse of ``pack_int4``: (..., ceil(n / 2)) uint8 -> (..., n) int8
    codes, each nibble sign-extended."""
    p = packed.to(torch.uint8)
    lo = (p & 0x0F).to(torch.int8)
    hi = ((p >> 4) & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(
        p.shape[:-1] + (2 * p.shape[-1],))[..., :n]


def _chai_on(cfg: ModelConfig, chai: bool) -> bool:
    return chai and cfg.chai.enabled and cfg.k_max > 0


# ---------------------------------------------------------------------------
# Cohort layout
# ---------------------------------------------------------------------------

def chai_state_structs(cfg: ModelConfig, batch: int, max_seq: int):
    """(tree of ``Struct``, tree of ``Ax``) of ``init_chai_state``'s
    state (the plain decode state on a GQA arch or with CHAI off), with
    the reference's logical names: the clustered rows on ``clusters``."""
    from repro_torch.models.transformer import decode_state_structs
    from repro_torch.sharding.rules import Ax, Struct
    shapes, logical = decode_state_structs(cfg, batch, max_seq)
    if not (cfg.is_mha and cfg.chai.enabled):
        return shapes, logical
    k_max, _ = chai_widths(cfg)
    dt = shapes["kg"].dtype
    ng, b, _, s, hd = shapes["kg"].shape
    rows = Ax("layers", "batch", "clusters", "seq", "head_dim")
    shapes, logical = dict(shapes), dict(logical)
    del shapes["kg"], logical["kg"]
    shapes["kg_chai"] = Struct((ng, b, k_max, s, hd), dt)
    logical["kg_chai"] = rows
    if "kg_scale" in shapes:
        del shapes["kg_scale"], logical["kg_scale"]
        shapes["kg_chai_scale"] = Struct((ng, b, k_max, s), torch.float32)
        logical["kg_chai_scale"] = Ax("layers", "batch", "clusters", "seq")
    if cfg.chai.share_values:
        del shapes["vg"], logical["vg"]
        shapes["vg_chai"] = Struct((ng, b, k_max, s, hd), dt)
        logical["vg_chai"] = rows
    return shapes, logical


def init_chai_state(cfg: ModelConfig, batch: int, max_seq: int, device):
    """Zero decode state in the clustered layout (MHA + CHAI archs):
    ``kg_chai`` (nG, B, k_max, S, hd) in place of ``kg`` (and, int8,
    ``kg_chai_scale`` (nG, B, k_max, S) in place of ``kg_scale``); under
    ``share_values`` also ``vg_chai`` of the same shape in place of
    ``vg`` (int8: ``vg_scale`` stays, as in the reference)."""
    state = init_decode_state(cfg, batch, max_seq, device)
    if not (cfg.is_mha and cfg.chai.enabled):
        return state
    k_max, _ = chai_widths(cfg)
    ng, b, _, s, hd = state.pop("kg").shape
    dt = state["vg"].dtype
    state["kg_chai"] = torch.zeros((ng, b, k_max, s, hd), dtype=dt,
                                   device=device)
    if state.pop("kg_scale", None) is not None:
        state["kg_chai_scale"] = torch.zeros((ng, b, k_max, s),
                                             dtype=torch.float32,
                                             device=device)
    if cfg.chai.share_values:
        del state["vg"]
        state["vg_chai"] = torch.zeros((ng, b, k_max, s, hd), dtype=dt,
                                       device=device)
    return state


def add_score_buffer(state, cfg: ModelConfig, batch: int):
    """Attach the warmup score buffer (nA, B, H, Wf), Wf = min(feature
    window, S): probabilities of the first Wf positions, summed over the
    WARMUP steps (masked positions add exactly 0). S is the global
    cache's length, or, without global layers, the ring's (the
    reference's rule)."""
    cache = state["kg"] if "kg" in state else state["kl"]
    wf = min(cfg.chai.feature_window, int(cache.shape[3]))
    state = dict(state)
    state["chai_scores"] = torch.zeros(
        (cfg.n_attn_layers, batch, cfg.n_heads, wf), dtype=torch.float32,
        device=cache.device)
    return state


def pop_score_buffer(state):
    state = dict(state)
    scores = state.pop("chai_scores")
    return state, scores


def compact_kv(state, chai_ctx, cfg: ModelConfig):
    """Dense MHA decode state -> clustered layout.

    state["kg"]: (nG, B, H, S, hd); ctx reps: (nA, B, k) or (nA, k).
    Returns a new state dict with ``kg_chai`` (nG, B, k, S, hd) and no
    ``kg`` (int8: ``kg_chai_scale`` gathered from ``kg_scale`` alike);
    under ``share_values`` also ``vg_chai`` gathered from ``vg`` (int8
    codes moved as they are) and no ``vg``."""
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
    new_state = {k: v for k, v in state.items()
                 if k not in ("kg", "kg_scale")}
    new_state["kg_chai"] = kg[li, bi, reps]
    if "kg_scale" in state:
        new_state["kg_chai_scale"] = state["kg_scale"][li, bi, reps]
    if cfg.chai.share_values:
        new_state["vg_chai"] = new_state.pop("vg")[li, bi, reps]
    return new_state


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq: int, *,
                   chai: bool = False):
    """Analytic steady-state KV-cache size in bytes (paper Fig 11); int8:
    1 + 4 / hd bytes an element (a code, and a row's fp32 scale). A local
    layer holds its ring, 2 KV rows of min(window, seq) positions (the
    reference's ``attn_local`` term)."""
    if cfg.n_attn_layers == 0:
        return 0
    if kv_int8(cfg):
        esize = 1 + 4 / cfg.head_dim
    else:
        esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
    k_max, _ = chai_widths(cfg)
    k_rows = (k_max if (chai and cfg.is_mha and cfg.chai.enabled)
              else cfg.n_kv_heads)
    # the reference's rule: share_values clusters V whenever chai is asked
    v_rows = (k_max if (chai and cfg.is_mha and cfg.chai.share_values)
              else cfg.n_kv_heads)
    per_layer = int(batch * (k_rows + v_rows) * seq * cfg.head_dim * esize)
    ring = int(batch * 2 * cfg.n_kv_heads * ring_width(cfg, seq)
               * cfg.head_dim * esize)
    return per_layer * cfg.n_global_layers + ring * cfg.n_local_layers


# ---------------------------------------------------------------------------
# Unified per-slot layout (continuous batching, kv_layout="dense")
# ---------------------------------------------------------------------------

def _score_shape(cfg: ModelConfig, batch: int, max_seq: int):
    """The slot layouts' score buffer: Wf = min(feature window, max_seq)
    whatever the layers (a ring narrower than Wf fills its first slots)."""
    wf = min(cfg.chai.feature_window, max_seq)
    return ((cfg.n_attn_layers, batch, cfg.n_heads, wf), torch.float32)


def unified_state_shapes(cfg: ModelConfig, batch: int, max_seq: int, *,
                         chai: bool = True):
    """{name: (shape, dtype)} of the continuous engine's unified state:
    the dense decode state plus ``phase`` (B,) and, with CHAI,
    ``chai_scores`` and the clustered ``kg_chai`` (nG, B, k_max, S, hd)
    (int8: and its ``kg_chai_scale`` (nG, B, k_max, S); ``share_values``:
    and ``vg_chai`` of ``kg_chai``'s shape)."""
    shapes = dict(decode_state_shapes(cfg, batch, max_seq))
    shapes["phase"] = ((batch,), torch.int32)
    if not _chai_on(cfg, chai):
        return shapes
    shapes["chai_scores"] = _score_shape(cfg, batch, max_seq)
    if cfg.is_mha and "kg" in shapes:
        k_max, _ = chai_widths(cfg)
        (ng, b, _, s, hd), dt = shapes["kg"]
        shapes["kg_chai"] = ((ng, b, k_max, s, hd), dt)
        if kv_int8(cfg):
            shapes["kg_chai_scale"] = ((ng, b, k_max, s), torch.float32)
        if cfg.chai.share_values:
            shapes["vg_chai"] = ((ng, b, k_max, s, hd), dt)
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
    representative K rows (``share_values``: and V rows) from the dense
    cache into the clustered cache and advance that slot's phase to
    STEADY. ``slot_ctx``: batch-free membership (reps (nA, k))."""
    if cfg.is_mha and cfg.chai.enabled and "kg_chai" in state:
        reps = slot_ctx["reps"].long()                    # (nA, k)
        kg = state["kg"]
        # All-global MHA archs: attention layer i == global layer i.
        li = torch.arange(kg.shape[0], device=kg.device)[:, None]
        state["kg_chai"][:, slot] = kg[li, slot, reps]
        if "kg_chai_scale" in state:
            state["kg_chai_scale"][:, slot] = state["kg_scale"][li, slot,
                                                                reps]
        if cfg.chai.share_values:
            state["vg_chai"][:, slot] = state["vg"][li, slot, reps]
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
    rectangles (and their int8 scales) stay allocated, and the local
    rings, summed from the layout's own shapes."""
    shapes = unified_state_shapes(cfg, batch, seq, chai=chai)
    return int(sum(torch.Size(shape).numel()
                   * torch.empty((), dtype=dt).element_size()
                   for k, (shape, dt) in shapes.items()
                   if k in ("kg", "vg", "kg_scale", "vg_scale", "kl", "vl",
                            "kg_chai", "kg_chai_scale", "vg_chai")))


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
    ``bt_kc`` (and ``bt_vc``, its clustered V pages, under
    ``share_values``). Under int8 each pool has a scale pool, ``kvp_scale`` /
    ``cp_scale``, of its shape without the last axis. ``pos``/``phase``/
    ``chai_scores`` are the unified layout's."""
    assert max_seq % page_size == 0, (max_seq, page_size)
    shapes = dict(decode_state_shapes(cfg, batch, max_seq))
    shapes["phase"] = ((batch,), torch.int32)
    bt = ((batch, max_seq // page_size), torch.int32)
    int8 = kv_int8(cfg)
    if cfg.n_global_layers:
        ng, kv, hd = cfg.n_global_layers, cfg.n_kv_heads, cfg.head_dim
        dt = shapes.pop("kg")[1]
        for key in ("vg", "kg_scale", "vg_scale"):
            shapes.pop(key, None)
        shapes["kvp"] = ((ng, dense_pages, kv, page_size, hd), dt)
        if int8:
            shapes["kvp_scale"] = ((ng, dense_pages, kv, page_size),
                                   torch.float32)
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
        if int8:
            shapes["cp_scale"] = ((ng, chai_pages, k_max, page_size),
                                  torch.float32)
        shapes["bt_kc"] = bt
        if cfg.chai.share_values:
            shapes["bt_vc"] = bt
    return shapes


def init_paged_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                     page_size: int, dense_pages: int, chai_pages: int = 0,
                     chai: bool = True, device):
    return zeros_state(paged_state_shapes(
        cfg, batch, max_seq, page_size=page_size, dense_pages=dense_pages,
        chai_pages=chai_pages, chai=chai), device)


def _scatter_pages(pool, x, pages):
    """Scatter a dense batch-1 rectangle into pool pages.

    pool: (nG, nP, rows, page[, hd]); x: (nG, 1, rows, S[, hd]); pages: (P,)
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
    into slot ``slot``, scattering its global K/V rows (and int8 scales)
    into the slot's pages (``kg_pages``/``vg_pages``: (P,) int32,
    null-padded) and recording the block tables.

    A chunk of a chunked prefill passes SCATTER vectors that null every
    page outside the chunk (so the mini state's zero rows land in the
    null sink) and the slot's full logical -> physical mapping as
    ``bt_kg_row``/``bt_vg_row``. Default: block tables == scatter
    vectors. Every call re-anchors ``pos`` and zeroes the slot's
    clustering features."""
    for k, v in mini.items():
        if k not in ("kg", "vg", "kg_scale", "vg_scale"):
            _put_slot(state, k, v, slot)
    if "kvp" in state and "kg" in mini:
        _scatter_pages(state["kvp"], mini["kg"], kg_pages)
        _scatter_pages(state["kvp"], mini["vg"], vg_pages)
        if "kvp_scale" in state:
            _scatter_pages(state["kvp_scale"], mini["kg_scale"], kg_pages)
            _scatter_pages(state["kvp_scale"], mini["vg_scale"], vg_pages)
        state["bt_kg"][slot] = kg_pages if bt_kg_row is None else bt_kg_row
        state["bt_vg"][slot] = vg_pages if bt_vg_row is None else bt_vg_row
    if "chai_scores" in state:
        state["chai_scores"][:, slot] = 0
    state["phase"][slot] = PHASE_WARMUP
    return state


def compact_kv_slot_paged(state, slot_ctx, cfg: ModelConfig, slot,
                          kc_pages, vc_pages=None):
    """Paged per-slot compaction: gather slot ``slot``'s representative K
    rows (and int8 scales) out of its dense pages into the clustered pages
    ``kc_pages`` ((P,) int32, null-padded), record them in ``bt_kc`` and
    null the dense K block-table row; the engine then hands the dense K
    pages back to the ``PagePool``. V stays in the dense pool until
    retire, except under ``share_values``: the rep V rows go to the
    clustered pages ``vc_pages`` (``kc_pages`` when None, as in the
    reference), int8 codes moved without their scales, into ``bt_vc``,
    and the dense V table row is nulled too."""
    if cfg.is_mha and cfg.chai.enabled and "cp" in state:
        reps = slot_ctx["reps"].long()                       # (nA, k)
        kvp = state["kvp"]
        li = torch.arange(kvp.shape[0], device=kvp.device)[:, None, None]

        def gather(pool, bt_key):
            # (nG, P, k, page[, hd]); null-padded table entries gather page
            # 0 and land on page 0 of the clustered pool (never read valid).
            bt_row = state[bt_key][slot].long()              # (P,)
            return pool[li, bt_row[None, :, None], reps[:, None, :]]

        state["cp"][:, kc_pages.long()] = gather(kvp, "bt_kg")
        if "cp_scale" in state:
            state["cp_scale"][:, kc_pages.long()] = gather(
                state["kvp_scale"], "bt_kg")
        state["bt_kg"][slot] = NULL_PAGE
        state["bt_kc"][slot] = kc_pages
        if cfg.chai.share_values:
            vd_pages = kc_pages if vc_pages is None else vc_pages
            state["cp"][:, vd_pages.long()] = gather(kvp, "bt_vg")
            state["bt_vc"][slot] = vd_pages
            state["bt_vg"][slot] = NULL_PAGE
    state["phase"][slot] = PHASE_STEADY
    return state


def copy_pool_page(state, src, dst, *, kind):
    """Copy ONE physical page (all global layers) inside a pool, the
    prefix cache's copy-on-write step: ``kind="dense"`` copies ``kvp``
    (and ``kvp_scale``), ``kind="chai"`` copies ``cp`` (and ``cp_scale``)."""
    for key in (("kvp", "kvp_scale") if kind == "dense"
                else ("cp", "cp_scale")):
        if key in state:
            state[key][:, int(dst)] = state[key][:, int(src)]
    return state


def restore_slot_snapshot(state, slot, bt_kg_row, bt_vg_row, bt_kc_row,
                          pos, bt_vc_row=None):
    """Prefix-cache snapshot resume: point slot ``slot``'s block tables at
    the snapshot's (shared or copied) pages (``bt_vc_row``: its clustered
    V pages, under ``share_values``), set ``pos`` to its STEADY-entry
    position, zero the slot's clustering features and enter STEADY
    directly, skipping PREFILL, WARMUP and CLUSTER."""
    for key, row in (("bt_kg", bt_kg_row), ("bt_vg", bt_vg_row),
                     ("bt_kc", bt_kc_row), ("bt_vc", bt_vc_row)):
        if key in state and row is not None:
            state[key][slot] = row
    state["pos"][slot] = pos
    if "chai_scores" in state:
        state["chai_scores"][:, slot] = 0
    state["phase"][slot] = PHASE_STEADY
    return state


_PAGED_POOL_KEYS = ("kvp", "kvp_scale", "cp", "cp_scale")


def _slot_index(t, slot):
    return torch.tensor([int(slot)], dtype=torch.long, device=t.device)


def save_slot_paged(state, slot, kg_pages, vg_pages, kc_pages, vc_pages):
    """Preemption swap-out: gather slot ``slot``'s whole per-slot state,
    every per-slot column (``pos``, ``phase``, ``chai_scores``, local
    rings, ...) and the CONTENTS of its pool pages, so the engine can free
    the physical pages and later restore the slot bit for bit
    (``load_slot_paged``). A resume by recompute could not be exact: CHAI
    decode approximates full attention, so the K/V rows a re-prefill
    writes for generated tokens are not the rows the decode wrote.

    Page vectors are int tensors of physical page ids: the null-padded
    (P,) maps, or only the pages the slot holds; a pool kind the slot does
    not hold passes nulls (or nothing) and round-trips null-sink rows.
    Returns ``(cols, pools)``: each column with the batch axis kept at
    size 1 (axis 0 of 1-D entries, axis 1 of the rest), and each pool's
    pages (nG, len(pages), ...) with their int8 scales under
    ``<kind>_scale``. Both are copies."""
    cols = {}
    for k, v in state.items():
        if k in _PAGED_POOL_KEYS or k.startswith("bt_"):
            continue
        cols[k] = v.index_select(0 if v.ndim == 1 else 1,
                                 _slot_index(v, slot))
    pools = {}

    def gather(kind, key, pages):
        pages = pages.long()
        pools[kind] = state[key].index_select(1, pages)
        if key + "_scale" in state:
            pools[kind + "_scale"] = state[key + "_scale"].index_select(
                1, pages)

    if "kvp" in state:
        gather("kg", "kvp", kg_pages)
        gather("vg", "kvp", vg_pages)
    if "cp" in state:
        gather("kc", "cp", kc_pages)
        if "bt_vc" in state:
            gather("vc", "cp", vc_pages)
    return cols, pools


def load_slot_paged(state, slot, cols, pools, kg_pages, vg_pages, kc_pages,
                    vc_pages, bt_kg_row, bt_vg_row, bt_kc_row, bt_vc_row):
    """Preemption swap-in, the inverse of ``save_slot_paged`` onto freshly
    allocated pages: the columns are written back verbatim, the saved page
    contents land at the new physical ids (``*_pages``, in the order they
    were saved) and the block tables are rebuilt from the new logical ->
    physical rows (null-padded ``(P,)``; a padded page vector's tail lands
    in the null sink, as every paged write does). A pool kind missing from
    ``pools`` (a kind the slot held no page of) writes no page, only its
    table row."""
    for k, v in cols.items():
        dst = state[k]
        dst.index_copy_(0 if dst.ndim == 1 else 1, _slot_index(dst, slot),
                        v.to(device=dst.device, dtype=dst.dtype,
                             non_blocking=True))

    def scatter(kind, key, pages):
        pages = pages.long()
        for name, dst in ((kind, key), (kind + "_scale", key + "_scale")):
            if name in pools and dst in state:
                state[dst].index_copy_(1, pages,
                                       pools[name].to(state[dst].dtype))

    if "kvp" in state:
        scatter("kg", "kvp", kg_pages)
        scatter("vg", "kvp", vg_pages)
        state["bt_kg"][slot] = bt_kg_row
        state["bt_vg"][slot] = bt_vg_row
    if "cp" in state:
        scatter("kc", "cp", kc_pages)
        state["bt_kc"][slot] = bt_kc_row
        if "bt_vc" in state:
            scatter("vc", "cp", vc_pages)
            state["bt_vc"][slot] = bt_vc_row
    return state


def reset_slot_paged(state, slot):
    """Paged retire: phase -> FREE, rewind ``pos``, null every block-table
    row (the engine frees the physical pages host-side)."""
    reset_slot(state, slot)
    for key in ("bt_kg", "bt_vg", "bt_kc", "bt_vc"):
        if key in state:
            state[key][slot] = NULL_PAGE
    return state


def paged_page_bytes(cfg: ModelConfig, page_size: int, *, kind: str):
    """Bytes of ONE page (``page_size`` tokens x all global layers):
    kind="dense": ``n_kv_heads`` rows; kind="chai": ``k_max`` rows. int8:
    a byte a code plus a row's 4-byte scale, hd + 4 bytes a row."""
    if cfg.n_global_layers == 0:
        return 0
    rows = cfg.n_kv_heads if kind == "dense" else chai_widths(cfg)[0]
    n = cfg.n_global_layers * rows * page_size
    if kv_int8(cfg):
        return int(n * cfg.head_dim + n * 4)
    esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
    return int(n * cfg.head_dim * esize)


def paged_kv_bytes(cfg: ModelConfig, page_size: int, dense_in_use: int,
                   chai_in_use: int = 0, *, batch: int = 0,
                   max_seq: int = 0):
    """ALLOCATED KV bytes of the paged layout: pages in use times page
    bytes, plus the local rings of ``batch`` slots (never paged; their
    width from ``max_seq``). It falls when a slot's dense K pages are
    freed at compaction, unlike the unified layout's constant dense +
    clustered residency."""
    total = (dense_in_use * paged_page_bytes(cfg, page_size, kind="dense")
             + chai_in_use * paged_page_bytes(cfg, page_size, kind="chai"))
    if batch and cfg.n_local_layers:
        esize = torch.empty((), dtype=model_dtype(cfg)).element_size()
        total += (2 * cfg.n_local_layers * batch * cfg.n_kv_heads
                  * ring_width(cfg, max_seq) * cfg.head_dim * esize)
    return int(total)
