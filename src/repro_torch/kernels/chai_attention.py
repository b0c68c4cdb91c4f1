"""Hand-written CUDA kernels for Clustered Head Attention, and their wrappers.

``chai_fused_decode`` launches ``csrc/chai_fused_decode.cu`` (the port of
the reference's Pallas ``chai_fused_decode``): one-pass clustered decode
over a dense cache — rep-head scores, online softmax per rep row, h2c
broadcast and per-head AV in one launch, with no (B, R, S) score tensor
in device memory. The wrapper takes CUDA tensors only; the CPU path is
the plain version in ``kernels.ref``, chosen by ``kernels.ops``.

``paged_chai_fused_decode`` launches ``csrc/paged_chai_fused_decode.cu``
(the port of the Pallas ``paged_chai_fused_decode``): the same function
over block-table page pools, the continuous engine's STEADY decode. Both
kernels run one block body (``csrc/chai_decode_tiles.cuh``): one block per
(S split, batch row, K row), the S axis streamed with fixed shared memory
(no sequence length is refused) and the splits merged in split order
inside the same launch. ``split_plan`` cuts S from (B, K rows, tiles)
alone and both wrappers call it, so at equal tile size (dense ``ts`` ==
page) their outputs are bitwise equal; ``decode_launch_config`` also
gives the block's shared memory.

Both take ``emit_state``: instead of the finalized output they return
the unnormalized online-softmax state (m (B, R), l (B, R), acc (B, H,
hd)), the suffix pass of the relay decode, which ``kernels.ops`` merges
with ``relay_prefix_decode``'s state and finalizes in torch.

``relay_prefix_decode`` launches ``csrc/relay_prefix_decode.cu`` (the port
of the Pallas ``relay_prefix_decode``): one pass per relay group over a
packed shared prefix, the member slots' rep queries stacked on one row
axis and routed by three int32 maps; it emits the same kind of state.
It runs the same streamed block body with one split.

The three-kernel pipeline (the reference's retired decode, kept as the
fused kernels' baseline): ``chai_qk``, ``chai_qk_i8`` and
``paged_chai_qk`` launch ``csrc/chai_qk.cu`` (raw masked rep scores
(B, R, S) fp32, exactly NEG_INF where masked); ``row_softmax`` launches
``csrc/row_softmax.cu``; ``chai_av`` and ``paged_chai_av`` launch
``csrc/chai_av.cu`` (head h reads A row h2c[b, h] and its own V rows,
summed over every position). ``kernels.ops.chai_three_kernel_decode``
and ``paged_chai_three_kernel_decode`` drive them.

``LAUNCHES`` counts each kernel's launches, one per successful launch,
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

LAUNCHES = {"chai_fused_decode": 0, "paged_chai_fused_decode": 0,
            "relay_prefix_decode": 0, "chai_qk": 0, "chai_qk_i8": 0,
            "row_softmax": 0, "chai_av": 0, "paged_chai_qk": 0,
            "paged_chai_av": 0}

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use

# chai_decode_tiles.cuh: the block body's constants
_CHUNK = 128            # kChunk: positions per chunk, the longest step
_THREADS = 128          # kThreads
_MAX_Q = 8              # kMaxQ: rep queries of one K row (reps_per_group)
_MAX_HD = 256           # kMaxHd
_MAX_SPLIT = 64         # kMaxSplit
_SLICE = 8              # kSlice: members (accumulator rows) of a block
_RED_VEC = 8            # kRedVec
_TAB = _CHUNK + 2       # kTab
# The split plan: aim at sixteen blocks per SM of the H100's 132 (short
# splits keep each block's chain of memory round trips short; the card
# holds that many blocks of this size at once), and cut no split shorter
# than four tiles (64 positions at the engine's page of 16).
SPLIT_TARGET_BLOCKS = 16 * 132
SPLIT_MIN_TILES = 4


def fused_tile_size(ts: int, s: int) -> int:
    """The S-tile the kernel uses: ``ts`` capped at S, and the whole
    sequence when ``ts`` does not divide it (the reference's rule)."""
    ts = min(ts, s) if ts else s
    return s if s % ts else ts


def decode_step_size(ts: int) -> int:
    """The decode kernels' online-softmax step for a tile of ``ts``
    positions: ``ts`` itself up to 128 (every tile the engine and the
    reference's sweeps use), else its largest divisor <= 128, so a step
    never straddles a tile (or a page) and the block's shared memory stays
    fixed whatever the tile."""
    return max(d for d in range(1, min(ts, _CHUNK) + 1) if ts % d == 0)


class DecodeLaunch(NamedTuple):
    """How a fused decode call is cut: ``n_split`` ranges of
    ``tiles_per_split`` whole tiles (the last may be shorter), ``n_cap``
    member heads (accumulator rows) per block, and the block's dynamic
    shared memory in bytes (``block_smem_bytes`` of
    ``csrc/chai_decode_tiles.cuh``)."""
    n_split: int
    tiles_per_split: int
    n_cap: int
    smem_bytes: int


def split_plan(b: int, k_rows: int, n_tiles: int):
    """(n_split, tiles_per_split) of a call with ``b`` batch rows,
    ``k_rows`` K rows per batch row (the work units are b * k_rows) and
    ``n_tiles`` tiles per row: enough splits that units x splits reaches
    ``SPLIT_TARGET_BLOCKS``, at most ``_MAX_SPLIT``, none shorter than
    ``SPLIT_MIN_TILES`` tiles. It reads no layout and no ``pos``, so the
    dense and the paged call at equal shapes cut alike."""
    want = min(_MAX_SPLIT, max(1, -(-SPLIT_TARGET_BLOCKS // (b * k_rows))))
    per = max(-(-n_tiles // want), SPLIT_MIN_TILES)
    return -(-n_tiles // per), per


def split_ranges(b: int, k_rows: int, n_tiles: int):
    """The tile ranges [t0, t1) of the splits, in order (the kernel's
    s * tps .. min(n_tiles, (s + 1) * tps))."""
    n_split, per = split_plan(b, k_rows, n_tiles)
    return [(s * per, min(n_tiles, (s + 1) * per)) for s in range(n_split)]


def _query_bucket(nq: int) -> int:
    return next(k for k in (1, 2, 4, _MAX_Q) if nq <= k)


def block_smem_bytes(kq: int, hd: int, n_map: int, n_cap: int) -> int:
    """``block_smem_bytes`` of ``csrc/chai_decode_tiles.cuh``: the block's
    queries, a chunk of scores and of step factors per query, the AV
    partials, n_cap accumulator rows, the merge factors and m/l/A (fp32),
    then the member list (3 ints per map entry), the chunk's block-table
    entries and two flags. No term depends on the sequence length."""
    floats = (kq * hd + 2 * kq * _CHUNK + _THREADS * _RED_VEC + n_cap * hd
              + kq * _MAX_SPLIT + 3 * kq)
    ints = 3 * n_map + 2 * _TAB + 2
    return (floats + ints) * 4


def decode_launch_config(b: int, k_rows: int, n_tiles: int, hd: int,
                         n_map: int, reps_per_group: int = 1,
                         n_split: int | None = None) -> DecodeLaunch:
    """The launch of one fused decode (or, with ``n_split=1``, relay)
    call: the split plan from (b, k_rows, n_tiles), and the block's shared
    memory for ``reps_per_group`` queries per block and an ``n_map``-entry
    member map (H heads; the relay's A acc rows)."""
    if n_split is None:
        n_split, per = split_plan(b, k_rows, n_tiles)
    else:
        per = -(-n_tiles // n_split)
    n_cap = max(1, min(n_map, _SLICE))
    return DecodeLaunch(n_split, per, n_cap, block_smem_bytes(
        _query_bucket(reps_per_group), hd, n_map, n_cap))


def dense_launch_config(q_rep, k_cache, h2c, *, reps_per_group=1, ts=512):
    """(the launch, the S-tile) of ``chai_fused_decode`` on these tensors
    (their shapes only: any device, ``meta`` too)."""
    s = k_cache.shape[2]
    ts = fused_tile_size(ts, s)
    return decode_launch_config(q_rep.shape[0], k_cache.shape[1], s // ts,
                                q_rep.shape[2], h2c.shape[-1],
                                reps_per_group), ts


def paged_launch_config(q_rep, k_pool, bt_k, h2c, *, reps_per_group=1):
    """The launch of ``paged_chai_fused_decode`` on these tensors (their
    shapes only); the tile is the page. Equal to the dense call's at
    S == P * page and ts == page."""
    return decode_launch_config(q_rep.shape[0], k_pool.shape[1],
                                bt_k.shape[1], q_rep.shape[2],
                                h2c.shape[-1], reps_per_group)


def _launcher(name, n_ptrs, n_ints):
    from repro_torch.kernels import build
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_unported(name, k_scale, v_scale, share_values, softcap):
    for flag, what, item in (
            (k_scale is not None, "int8 K scales", 2),
            (v_scale is not None, "int8 V scales", 2),
            (share_values, "share_values", 3), (bool(softcap), "softcap", 14)):
        if flag:
            raise NotImplementedError(f"{name}: {what} is not ported to "
                                      f"CUDA yet: ROADMAP Queue 1 #{item}")


def _check_block(name, hd, reps_per_group, cfg):
    """The block body's limits: 16-byte row loads, at most ``_MAX_Q``
    queries a block, and a block's shared memory (fixed in S; it grows
    with the member map only)."""
    if hd % 8 or not 0 < hd <= _MAX_HD:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 "
                         f"and at most {_MAX_HD} (16-byte row loads)")
    if not 0 < reps_per_group <= _MAX_Q:
        raise ValueError(f"{name}: reps_per_group {reps_per_group} must be "
                         f"1..{_MAX_Q}")
    if cfg.smem_bytes > _SMEM_LIMIT:
        raise ValueError(f"{name}: the member map needs {cfg.smem_bytes} B "
                         "of shared memory, above the block limit")


def _check_common(name, q_rep, k, v, h2c, reps_per_group):
    """Device, dtype and width checks both wrappers share; returns
    (b, R, hd, H, h2c as (B, H))."""
    if q_rep.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{q_rep.device}")
    b, r_total, hd = q_rep.shape
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    h_total = h2c.shape[1]
    if k.dtype != v.dtype or k.dtype not in _KV_DTYPES:
        raise TypeError(f"K/V must share one dtype of fp32/bf16; got "
                        f"{k.dtype}, {v.dtype}")
    if k.shape[1] * reps_per_group != r_total or h_total % v.shape[1]:
        raise ValueError(f"R={r_total} must be KVk={k.shape[1]} x "
                         f"reps_per_group={reps_per_group} and KVv="
                         f"{v.shape[1]} must divide H={h_total}")
    return b, r_total, hd, h_total, h2c


def _check_aligned(name, **tensors):
    """The kernels load rows 16 bytes at a time."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _small(t, dev):
    """int32 contiguous copy of a small index tensor (h2c, pos, tables)."""
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _outputs(b, r_total, h_total, hd, dev, emit_state):
    """The decode kernels' outputs: (B, H, hd) fp32, and with
    ``emit_state`` the (B, R) m and l as well (else None)."""
    out = torch.empty((b, h_total, hd), dtype=torch.float32, device=dev)
    if not emit_state:
        return out, None, None
    return (out,) + tuple(torch.empty((b, r_total), dtype=torch.float32,
                                      device=dev) for _ in range(2))


# Ticket counters of the in-launch split merge, one int32 per work unit,
# kept per (device, stream): zero between launches (each unit's merging
# block resets its own), so a launch needs no fill of its own.
_COUNTERS: dict = {}


def _split_scratch(cfg, b, r_total, h_total, hd, units, dev, stream):
    """(mp, lp, accp, counter) of a split launch: the partial m and l
    (B, n_split, R) and the raw partial acc (B, n_split, H, hd), fp32, in
    one ``torch.empty`` (the kernel reads no slot it has not written),
    and the unit counters; all None when the call is not split."""
    if cfg.n_split == 1:
        return None, None, None, None
    key = (dev.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < units:
        counter = torch.zeros(units, dtype=torch.int32, device=dev)
        _COUNTERS[key] = counter
    ns = cfg.n_split
    buf = torch.empty(b * ns * (h_total * hd + 2 * r_total),
                      dtype=torch.float32, device=dev)
    # acc first: the merge reads it 16 bytes at a time (hd % 8 == 0)
    acc, m, l = buf.split([b * ns * h_total * hd, b * ns * r_total,
                           b * ns * r_total])
    return m, l, acc, counter


def _ptr(t):
    """A tensor's address, or a null pointer for None."""
    return None if t is None else t.data_ptr()


def chai_fused_decode(q_rep, k_cache, v_cache, h2c, pos, *, k_scale=None,
                      v_scale=None, reps_per_group=1, share_values=False,
                      window=0, ts=512, softcap=0.0, emit_state=False):
    """One-pass fused clustered decode over a dense cache, on the GPU.

    q_rep: (B, R, hd) rep-head queries (any float dtype; read as fp32);
    k_cache: (B, KVk, S, hd) with KVk * reps_per_group == R (MHA
    clustered cache: KVk == R); v_cache: (B, KVv, S, hd), per-head
    (KVv == H) or per-group (H % KVv == 0); K/V fp32 or bf16, one dtype;
    h2c: (B, H) or (H,) head -> rep row, values in [0, R); pos: (B,).
    Any S: the kernel streams it with fixed shared memory, cut into
    ``split_plan`` ranges merged inside the launch. Returns (B, H, hd)
    fp32 from ONE kernel launch, or with ``emit_state`` the unnormalized
    (m (B, R), l (B, R), acc (B, H, hd)) fp32 state.
    """
    _refuse_unported("chai_fused_decode", k_scale, v_scale, share_values,
                     softcap)
    s = k_cache.shape[2]
    b, r_total, hd, h_total, h2c = _check_common(
        "chai_fused_decode", q_rep, k_cache, v_cache, h2c, reps_per_group)
    kv_k, kv_v = k_cache.shape[1], v_cache.shape[1]
    if (k_cache.shape[0] != b or k_cache.shape[3] != hd
            or v_cache.shape != (b, kv_v, s, hd)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    cfg, ts = dense_launch_config(q_rep, k_cache, h2c,
                                  reps_per_group=reps_per_group, ts=ts)
    _check_block("chai_fused_decode", hd, reps_per_group, cfg)
    dev = q_rep.device
    q = q_rep.float().contiguous()
    k = k_cache.contiguous()
    v = v_cache.contiguous()
    _check_aligned("chai_fused_decode", k_cache=k, v_cache=v)
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    out, m, l = _outputs(b, r_total, h_total, hd, dev, emit_state)
    fn = _launcher("chai_fused_decode", 12, 16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _split_scratch(cfg, b, r_total, h_total, hd, b * kv_k, dev,
                                 stream)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
                 *(_ptr(t) for t in scratch), b, r_total, h_total, kv_k,
                 kv_v, s, hd, ts, decode_step_size(ts), reps_per_group,
                 h_total // kv_v, int(window), cfg.n_split,
                 cfg.tiles_per_split, cfg.n_cap, _KV_DTYPES[k.dtype], stream)
    if err:
        raise RuntimeError(f"chai_fused_decode launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["chai_fused_decode"] += 1
    return (m, l, out) if emit_state else out


def paged_chai_fused_decode(q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos, *,
                            k_scale_pool=None, v_scale_pool=None,
                            reps_per_group=1, share_values=False, window=0,
                            softcap=0.0, emit_state=False):
    """One-pass fused clustered decode over block-table page pools, on
    the GPU.

    q_rep: (B, R, hd) (any float dtype; read as fp32); k_pool:
    (nPk, KVk, page, hd), the clustered pool of one layer (MHA: KVk ==
    k_max); v_pool: (nPv, KVv, page, hd), the dense per-head pool;
    bt_k/bt_v: (B, P) block tables into their own pools (tile t of row b
    is page bt[b, t]; the tile size is the page); h2c: (B, H) or (H,);
    pos: (B,). K/V fp32 or bf16, one dtype. Any P: the split plan is the
    dense call's at equal shapes, so at page == ts the two are bitwise
    equal. The pools are layer slices of the engine's state and are read
    in place: they must be contiguous already (a copy would move the whole
    pool every call). Returns (B, H, hd) fp32 from ONE kernel launch, or
    the ``emit_state`` triple.
    """
    _refuse_unported("paged_chai_fused_decode", k_scale_pool, v_scale_pool,
                     share_values, softcap)
    n_pages = bt_k.shape[1]
    page = k_pool.shape[2]
    b, r_total, hd, h_total, h2c = _check_common(
        "paged_chai_fused_decode", q_rep, k_pool, v_pool, h2c,
        reps_per_group)
    kv_k, kv_v = k_pool.shape[1], v_pool.shape[1]
    if (k_pool.shape[3] != hd or v_pool.shape[2:] != (page, hd)
            or bt_k.shape != (b, n_pages) or bt_v.shape != (b, n_pages)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}, bt_k {tuple(bt_k.shape)}, "
                         f"bt_v {tuple(bt_v.shape)}")
    cfg = paged_launch_config(q_rep, k_pool, bt_k, h2c,
                              reps_per_group=reps_per_group)
    _check_block("paged_chai_fused_decode", hd, reps_per_group, cfg)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pools are read "
                             "in place, never copied)")
    _check_aligned("paged_chai_fused_decode", k_pool=k_pool, v_pool=v_pool)
    dev = q_rep.device
    q = q_rep.float().contiguous()
    bt_k_i, bt_v_i = _small(bt_k, dev), _small(bt_v, dev)
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    out, m, l = _outputs(b, r_total, h_total, hd, dev, emit_state)
    fn = _launcher("paged_chai_fused_decode", 14, 16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _split_scratch(cfg, b, r_total, h_total, hd, b * kv_k, dev,
                                 stream)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 bt_k_i.data_ptr(), bt_v_i.data_ptr(), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
                 *(_ptr(t) for t in scratch), b, r_total, h_total, kv_k,
                 kv_v, n_pages, page, hd, decode_step_size(page),
                 reps_per_group, h_total // kv_v, int(window), cfg.n_split,
                 cfg.tiles_per_split, cfg.n_cap, _KV_DTYPES[k_pool.dtype],
                 stream)
    if err:
        raise RuntimeError(f"paged_chai_fused_decode launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["paged_chai_fused_decode"] += 1
    return (m, l, out) if emit_state else out


def relay_prefix_decode(q, k, v, k_row, a_row, v_row, plen, *, ts=0):
    """One pass per relay group over its packed shared prefix, on the GPU.

    q: (G, NR, hd) member rep queries stacked per group (any float dtype;
    read as fp32); k: (G, KV, Sp, hd) and v: (G, VR, Sp, hd) the packed
    prefix, fp32 or bf16, one dtype; k_row: (G, NR) query row -> K row;
    a_row: (G, A) acc row -> query row; v_row: (G, A) acc row -> V row;
    plen: (G,) valid prefix lengths (positions >= plen masked). ``ts``:
    the S-tile (0: Sp; the whole prefix when it does not divide Sp). Any
    Sp: the kernel streams it with fixed shared memory. Returns (m (G,
    NR), l (G, NR), acc (G, A, hd)) fp32, unnormalized, from ONE kernel
    launch.
    """
    if q.device.type != "cuda":
        raise ValueError(f"relay_prefix_decode launches a CUDA kernel; got "
                         f"tensors on {q.device}")
    g, nr, hd = q.shape
    kv, sp = k.shape[1], k.shape[2]
    vr, a_total = v.shape[1], a_row.shape[1]
    if k.dtype != v.dtype or k.dtype not in _KV_DTYPES:
        raise TypeError(f"K/V must share one dtype of fp32/bf16; got "
                        f"{k.dtype}, {v.dtype}")
    if (k.shape != (g, kv, sp, hd) or v.shape != (g, vr, sp, hd)
            or k_row.shape != (g, nr) or a_row.shape != (g, a_total)
            or v_row.shape != (g, a_total) or plen.shape != (g,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, k_row "
                         f"{tuple(k_row.shape)}, a_row {tuple(a_row.shape)},"
                         f" v_row {tuple(v_row.shape)}, plen "
                         f"{tuple(plen.shape)}")
    ts = fused_tile_size(ts, sp)
    cfg = decode_launch_config(g, nr, sp // ts, hd, a_total, n_split=1)
    _check_block("relay_prefix_decode", hd, 1, cfg)
    dev = q.device
    qf = q.float().contiguous()
    kc, vc = k.contiguous(), v.contiguous()
    _check_aligned("relay_prefix_decode", k=kc, v=vc)
    maps = [_small(t, dev) for t in (k_row, a_row, v_row, plen)]
    m = torch.empty((g, nr), dtype=torch.float32, device=dev)
    l = torch.empty((g, nr), dtype=torch.float32, device=dev)
    acc = torch.empty((g, a_total, hd), dtype=torch.float32, device=dev)
    fn = _launcher("relay_prefix_decode", 10, 11)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qf.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                 *(t.data_ptr() for t in maps), m.data_ptr(), l.data_ptr(),
                 acc.data_ptr(), g, nr, a_total, kv, vr, sp, hd, ts,
                 decode_step_size(ts), cfg.n_cap, _KV_DTYPES[kc.dtype],
                 stream)
    if err:
        raise RuntimeError(f"relay_prefix_decode launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["relay_prefix_decode"] += 1
    return m, l, acc


# ---------------------------------------------------------------------------
# The three-kernel pipeline: QK -> row softmax -> AV
# ---------------------------------------------------------------------------

def _tile_check(name, ts, s):
    """The Pallas wrappers' tile assertion: ``ts`` (capped at S) must
    divide S. The CUDA kernels do not tile by it."""
    ts = min(ts, s)
    if ts <= 0 or s % ts:
        raise ValueError(f"{name}: S={s} is not a multiple of ts={ts}")


def _check_rows(name, x, hd):
    """Even head dim and two-element alignment (the paired loads)."""
    if hd % 2:
        raise ValueError(f"{name}: head_dim {hd} must be even (paired "
                         "loads)")
    if x.data_ptr() % (2 * x.element_size()):
        raise ValueError(f"{name}: K/V must be aligned to two elements")


def _qk_inputs(name, q_rep, k, pos, reps_per_group, dtypes, s):
    """Checks shared by the QK wrappers; returns (b, R, hd, q fp32, pos
    int32, the (B, R, S) fp32 output)."""
    if q_rep.device.type != "cuda" or k.device != q_rep.device:
        raise ValueError(f"{name} launches a CUDA kernel; got q on "
                         f"{q_rep.device} and K on {k.device}")
    if k.dtype not in dtypes:
        raise TypeError(f"{name}: K must be {dtypes}; got {k.dtype}")
    b, r_total, hd = q_rep.shape
    if k.shape[1] * reps_per_group != r_total or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q_rep.shape)} against K "
                         f"{tuple(k.shape)} with reps_per_group="
                         f"{reps_per_group}")
    _check_rows(name, k, hd)
    dev = q_rep.device
    return (b, r_total, hd, q_rep.float().contiguous(), _small(pos, dev),
            torch.empty((b, r_total, s), dtype=torch.float32, device=dev))


def _launched(name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def chai_qk(q_rep, k_cache, pos, *, reps_per_group=1, window=0, ts=512):
    """Raw masked clustered scores over a dense cache, on the GPU.

    q_rep: (B, R, hd) (any float dtype; read as fp32); k_cache: (B, KV,
    S, hd) fp32 or bf16 with KV * reps_per_group == R (rep j reads K row
    j // reps_per_group); pos: (B,). Returns (B, R, S) fp32:
    dot(q, k) * (1 / sqrt(hd)), exactly NEG_INF (-2e38) where s > pos or
    (window > 0 and pos - s >= window). ``ts`` must divide S, as in the
    Pallas wrapper. ONE launch."""
    k = k_cache.contiguous()
    s = k.shape[2]
    _tile_check("chai_qk", ts, s)
    b, r_total, hd, q, pos_i, out = _qk_inputs(
        "chai_qk", q_rep, k, pos, reps_per_group, tuple(_KV_DTYPES), s)
    if k.shape[0] != b:
        raise ValueError(f"chai_qk: K batch {k.shape[0]} != {b}")
    fn = _launcher("chai_qk", 4, 8)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), pos_i.data_ptr(),
                 out.data_ptr(), b, r_total, k.shape[1], s, hd,
                 reps_per_group, int(window), _KV_DTYPES[k.dtype], stream)
    _launched("chai_qk", err)
    return out


def chai_qk_i8(q_rep, k_cache_i8, k_scale, pos, *, reps_per_group=1,
               window=0, ts=512):
    """``chai_qk`` over an int8 cache (B, KV, S, hd), read one byte per
    element, with fp32 per-row scales k_scale (B, KV, S) applied after the
    dot: dot(k_i8, q) * k_scale[row] * (1 / sqrt(hd)), the Pallas
    kernel's order. Returns (B, R, S) fp32. ONE launch."""
    k = k_cache_i8.contiguous()
    s = k.shape[2]
    _tile_check("chai_qk_i8", ts, s)
    b, r_total, hd, q, pos_i, out = _qk_inputs(
        "chai_qk_i8", q_rep, k, pos, reps_per_group, (torch.int8,), s)
    if k.shape[0] != b or k_scale.shape != k.shape[:3]:
        raise ValueError(f"chai_qk_i8: K {tuple(k.shape)}, k_scale "
                         f"{tuple(k_scale.shape)}, batch {b}")
    if k_scale.dtype != torch.float32 or k_scale.device != k.device:
        raise TypeError(f"chai_qk_i8: k_scale must be fp32 on {k.device}; "
                        f"got {k_scale.dtype} on {k_scale.device}")
    ks = k_scale.contiguous()
    fn = _launcher("chai_qk_i8", 5, 7)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), ks.data_ptr(), pos_i.data_ptr(),
                 out.data_ptr(), b, r_total, k.shape[1], s, hd,
                 reps_per_group, int(window), stream)
    _launched("chai_qk_i8", err)
    return out


def paged_chai_qk(q_rep, k_pool, bt, pos, *, reps_per_group=1, window=0):
    """``chai_qk`` over a K page pool (nP, KV, page, hd), fp32 or bf16,
    read in place through the block table bt (B, P): position s of row b
    is row s % page of page bt[b, s // page]. Returns (B, R, P * page)
    fp32. ONE launch."""
    if not k_pool.is_contiguous():
        raise ValueError("paged_chai_qk: k_pool must be contiguous (pools "
                         "are read in place, never copied)")
    n_pages, page = bt.shape[1], k_pool.shape[2]
    b, r_total, hd, q, pos_i, out = _qk_inputs(
        "paged_chai_qk", q_rep, k_pool, pos, reps_per_group,
        tuple(_KV_DTYPES), n_pages * page)
    if bt.shape != (b, n_pages):
        raise ValueError(f"paged_chai_qk: bt {tuple(bt.shape)} for batch {b}")
    bt_i = _small(bt, q.device)
    fn = _launcher("paged_chai_qk", 5, 9)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), bt_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), b, r_total,
                 k_pool.shape[1], n_pages, page, hd, reps_per_group,
                 int(window), _KV_DTYPES[k_pool.dtype], stream)
    _launched("paged_chai_qk", err)
    return out


def row_softmax(scores):
    """Masked softmax of each (b, rep) row of raw scores (B, R, S) fp32,
    on the GPU: p = exp(x - max(max(x), -1e30)), p / max(sum(p), 1e-37);
    a row masked everywhere gives zeros. Returns (B, R, S) fp32. ONE
    launch."""
    if scores.device.type != "cuda":
        raise ValueError(f"row_softmax launches a CUDA kernel; got tensors "
                         f"on {scores.device}")
    if scores.dtype != torch.float32 or scores.ndim != 3:
        raise TypeError(f"row_softmax: scores must be (B, R, S) fp32; got "
                        f"{tuple(scores.shape)} {scores.dtype}")
    x = scores.contiguous()
    b, r, s = x.shape
    out = torch.empty_like(x)
    fn = _launcher("row_softmax", 2, 2)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b * r, s, stream)
    _launched("row_softmax", err)
    return out


def _av_inputs(name, a, v, h2c, h):
    """Checks shared by the AV wrappers; returns (b, R, a fp32, h2c as a
    (B, H) int32 tensor, the (B, H, hd) output)."""
    if a.device.type != "cuda" or v.device != a.device:
        raise ValueError(f"{name} launches a CUDA kernel; got A on "
                         f"{a.device} and V on {v.device}")
    if a.dtype != torch.float32 or a.ndim != 3:
        raise TypeError(f"{name}: A must be (B, R, S) fp32; got "
                        f"{tuple(a.shape)} {a.dtype}")
    if v.dtype not in _KV_DTYPES:
        raise TypeError(f"{name}: V must be fp32 or bf16; got {v.dtype}")
    b, r_total = a.shape[:2]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    if h2c.shape != (b, h):
        raise ValueError(f"{name}: h2c {tuple(h2c.shape)} for (B, H) = "
                         f"({b}, {h})")
    hd = v.shape[3]
    _check_rows(name, v, hd)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=a.device)
    return b, r_total, a.contiguous(), _small(h2c, a.device), out


def chai_av(a, v_cache, h2c, *, ts=512):
    """Broadcast-and-accumulate over a dense V cache, on the GPU.

    a: (B, R, S) fp32 normalized clustered scores; v_cache: (B, H, S, hd)
    fp32 or bf16, one V row per head; h2c: (B, H) or (H,), head -> A row.
    Returns (B, H, hd) fp32: out[b, h] = sum over every s of
    a[b, h2c[b, h], s] * v[b, h, s] (no pos cut: A is zero past pos
    because the softmax made it so). ``ts`` must divide S, as in the
    Pallas wrapper. ONE launch."""
    v = v_cache.contiguous()
    b_v, h, s, hd = v.shape
    _tile_check("chai_av", ts, s)
    b, r_total, af, h2c_i, out = _av_inputs("chai_av", a, v, h2c, h)
    if b_v != b or af.shape[2] != s:
        raise ValueError(f"chai_av: A {tuple(a.shape)} against V "
                         f"{tuple(v.shape)}")
    fn = _launcher("chai_av", 4, 6)
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream(af.device).cuda_stream
        err = fn(af.data_ptr(), v.data_ptr(), h2c_i.data_ptr(),
                 out.data_ptr(), b, r_total, h, s, hd, _KV_DTYPES[v.dtype],
                 stream)
    _launched("chai_av", err)
    return out


def paged_chai_av(a, v_pool, bt_v, h2c):
    """``chai_av`` over a V page pool (nP, H, page, hd), fp32 or bf16,
    read in place through bt_v (B, P): head h's position s is row s %
    page of page bt_v[b, s // page]. a: (B, R, P * page). Returns (B, H,
    hd) fp32. ONE launch."""
    if not v_pool.is_contiguous():
        raise ValueError("paged_chai_av: v_pool must be contiguous (pools "
                         "are read in place, never copied)")
    h, page = v_pool.shape[1], v_pool.shape[2]
    n_pages = bt_v.shape[1]
    if a.shape[2] != n_pages * page or bt_v.shape != (a.shape[0], n_pages):
        raise ValueError(f"paged_chai_av: A {tuple(a.shape)} against "
                         f"{n_pages} pages of {page} (bt_v "
                         f"{tuple(bt_v.shape)})")
    b, r_total, af, h2c_i, out = _av_inputs("paged_chai_av", a, v_pool, h2c,
                                            h)
    bt_i = _small(bt_v, af.device)
    fn = _launcher("paged_chai_av", 5, 7)
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream(af.device).cuda_stream
        err = fn(af.data_ptr(), v_pool.data_ptr(), bt_i.data_ptr(),
                 h2c_i.data_ptr(), out.data_ptr(), b, r_total, h, n_pages,
                 page, v_pool.shape[3], _KV_DTYPES[v_pool.dtype], stream)
    _launched("paged_chai_av", err)
    return out
