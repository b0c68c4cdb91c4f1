"""Hand-written CUDA prefill attention kernels, and their wrappers.

``flash_prefill`` launches ``csrc/flash_prefill.cu`` (the port of the
reference's Pallas ``flash_prefill``): causal attention of queries at
``offset + t`` over keys ``0..S-1``, finalized or as the head-major
online-softmax state. ``paged_prefix_attend`` launches
``csrc/paged_prefix_attend.cu`` (the port of the Pallas
``paged_prefix_attend``): queries over every cached position ``< plen``
of a page pool, read through block tables, as that state. The chunked
prefill runs both in every global layer and merges the two states
(``kernels.ops.merge_prefill_states``). Both kernels share the tile steps
of ``csrc/flash_tiles.cuh``. Head dim 320 (gemma3-4b's global layers)
runs their wide block (the warp groups split the output columns), built
into the wide libraries (``build.VARIANTS``), counted in the ``wide``
mode.

``flash_decode`` launches ``csrc/flash_decode.cu`` (the port of the Pallas
``flash_decode``): plain MHA/GQA decode attention of one query token over
a dense (B, KV, S, hd) cache; ``paged_decode`` launches
``csrc/paged_decode.cu`` (the port of the Pallas ``paged_decode``): the
same over one shared K/V page pool read through block tables. The MHA
baseline (CHAI off) decodes through them. Both share the block body of
``csrc/decode_tiles.cuh``, so at ts == page they are bitwise equal.

The decode pair takes head dims up to 256 on the block body's instance
of kMaxHd and head_dim 320 (gemma3-4b) on its wide-head instance
(kWideHd), whose shared memory and accumulator slots are sized for 320;
the launchers pick it by the head dim.

The wrappers take CUDA tensors only; the CPU path is the plain version in
``kernels.ref``, chosen by ``kernels.ops``. ``LAUNCHES`` counts each
kernel's launches, one per successful launch, and every launch is
counted by mode in ``chai_attention.MODE_LAUNCHES`` too (the decode
pair's wide-head launches under "wide").
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import chai_attention as ck
from repro_torch.kernels.chai_attention import _launcher, fused_tile_size

LAUNCHES = {"flash_prefill": 0, "paged_prefix_attend": 0,
            "flash_decode": 0, "paged_decode": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# flash_tiles.cuh: with_head_dim, and kWideHd on the wide libraries
_HEAD_DIMS = (8, 16, 32, 64, 128, 224, 256, ck.WIDE_HD)
_DECODE_MAX_HD = 256     # decode_tiles.cuh: kMaxHd
_DECODE_WIDE_HD = 320    # decode_tiles.cuh: kWideHd, the wide instance
# Query heads of one KV group a decode block serves: at most 2
# (decode_tiles.cuh: with_heads). Timed on the card for nemotron-4-15b's
# 6-head groups at 1 to 6 heads a block, 2 was the fastest: a block's chain
# of dependent phases grows with its heads, and the group's K/V rows come
# again from L2.
_DECODE_HEADS = 2
_DECODE_CHUNK = 64       # decode_tiles.cuh: kChunk
_DECODE_THREADS = 128    # decode_tiles.cuh: kThreads
_DECODE_RED_VEC = 8      # decode_tiles.cuh: kRedVec
_DECODE_MAX_SPLIT = 64   # decode_tiles.cuh: kMaxSplit (split_plan's cap)


def _check_heads(name, q, kv_heads, hd):
    """Head, device and dtype checks both wrappers share (the head dim
    first: shapes alone decide it, on any device)."""
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} is not one the kernel is "
                         f"built for {_HEAD_DIMS}")
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be fp32 or bf16; got {q.dtype}")
    if q.ndim != 4 or q.shape[3] != hd:
        raise ValueError(f"{name}: q must be (B, T, H, hd={hd}); got "
                         f"{tuple(q.shape)}")
    if kv_heads == 0 or q.shape[2] % kv_heads:
        raise ValueError(f"{name}: KV={kv_heads} must divide H="
                         f"{q.shape[2]}")


def _check_aligned(name, **tensors):
    """The kernels load rows 16 bytes at a time."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _state(b, h, t, hd, dev):
    return (torch.empty((b, h, t), dtype=torch.float32, device=dev),
            torch.empty((b, h, t), dtype=torch.float32, device=dev),
            torch.empty((b, h, t, hd), dtype=torch.float32, device=dev))


def flash_prefill(q, k, v, *, offset=0, window=0, softcap=0.0,
                  emit_state=False):
    """Causal attention on the GPU: query t at absolute position
    ``offset + t`` attends keys ``0..S-1`` with key <= query.

    q: (B, T, H, hd); k/v: (B, S, KV, hd) (time-major, as projected),
    one dtype of fp32/bf16; H % KV == 0 (GQA: head h reads KV head
    h // (H // KV)). ``offset``: an int or a one-element integer tensor
    (read on the device; no host sync). ``window`` > 0: key k is visible
    to the query at p only when p - k < window (tiles outside every
    row's window are skipped); ``softcap`` != 0: each scaled score
    becomes softcap * tanh(score / softcap) before the mask. Returns
    (B, T, H, hd) in q's dtype, or with ``emit_state`` the head-major
    triple (m (B, H, T), l (B, H, T), acc (B, H, T, hd)) fp32, from ONE
    kernel launch; a row that sees no key holds the merge identity (m =
    -2e38, l = 0, acc = 0; finalized: zeros).
    """
    b, t, h, hd = q.shape
    _check_heads("flash_prefill", q, k.shape[2], hd)
    if (k.dtype != q.dtype or v.dtype != q.dtype or k.ndim != 4
            or k.shape[0] != b or k.shape[3] != hd or v.shape != k.shape):
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} {q.dtype}, k "
                         f"{tuple(k.shape)} {k.dtype}, v {tuple(v.shape)} "
                         f"{v.dtype} do not match")
    dev = q.device
    s, kv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned("flash_prefill", q=q, k=k, v=v)
    if torch.is_tensor(offset):
        if offset.numel() != 1:
            raise ValueError("flash_prefill: offset must be one element")
        off = offset.to(device=dev, dtype=torch.int32).reshape(1)
    else:
        off = torch.full((1,), int(offset), dtype=torch.int32, device=dev)
    if emit_state:
        m, l, acc = _state(b, h, t, hd, dev)
        out = None
        ptrs = (None, m.data_ptr(), l.data_ptr(), acc.data_ptr())
    else:
        out = torch.empty((b, t, h, hd), dtype=q.dtype, device=dev)
        ptrs = (out.data_ptr(), None, None, None)
    wide = hd == ck.WIDE_HD
    fn = _launcher("flash_prefill", 8, 9, 1,
                   lib="flash_prefill_wide" if wide else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                 *ptrs, b, t, s, h, kv, hd, max(int(window), 0),
                 int(emit_state), _DTYPES[q.dtype], float(softcap), stream)
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    ck.count_launch(LAUNCHES, "flash_prefill", softcap=softcap,
                    window=int(window) > 0, wide=wide)
    return (m, l, acc) if emit_state else out


def paged_prefix_attend(q, kv_pool, bt_k, bt_v, plen, *, k_scale_pool=None,
                        v_scale_pool=None, softcap=0.0):
    """Queries over cached prefix pages on the GPU, with no causal mask.

    q: (B, T, H, hd); kv_pool: (nP, KV, page, hd), one layer's pool in
    q's dtype (fp32/bf16), read in place: it must be contiguous already
    (a copy would move the whole pool every call); bt_k/bt_v: (B, P)
    block tables (K and V are distinct pages of the one pool); plen:
    (B,) cached positions (cut at P * page). The pool may also be int8
    codes beside a q of either dtype. Each side takes its fp32 scale pool
    or none, as the Pallas wrapper does: k_scale_pool and v_scale_pool
    (nP, KV, page), read through the same tables (the int8 mode: an int8
    pool with both; the engine passes one scale pool as both); the K
    scale multiplies the score after the dot, the V scale the probability
    before p.V, and a side without one is read as values (int8 codes
    too). ``softcap`` != 0: each scaled score (after the K scale) becomes
    softcap * tanh(score / softcap).
    Returns the head-major triple (m (B, H, T), l (B, H, T), acc (B, H,
    T, hd)) fp32 from ONE kernel launch; a row with plen == 0 holds the
    merge identity (m = -2e38, l = 0, acc = 0) and reads no page.
    """
    ck._check_scales("paged_prefix_attend", kv_pool, kv_pool, k_scale_pool,
                     v_scale_pool)
    int8 = kv_pool.dtype == torch.int8
    b, t, h, hd = q.shape
    _check_heads("paged_prefix_attend", q, kv_pool.shape[1], hd)
    n_pages = bt_k.shape[-1]
    if ((kv_pool.dtype != q.dtype and not int8) or kv_pool.ndim != 4
            or kv_pool.shape[3] != hd or bt_k.shape != (b, n_pages)
            or bt_v.shape != (b, n_pages) or plen.shape != (b,)):
        raise ValueError(f"paged_prefix_attend: q {tuple(q.shape)} "
                         f"{q.dtype}, kv_pool {tuple(kv_pool.shape)} "
                         f"{kv_pool.dtype}, bt_k {tuple(bt_k.shape)}, bt_v "
                         f"{tuple(bt_v.shape)}, plen {tuple(plen.shape)} do "
                         "not match")
    if not all(x is None or x.is_contiguous()
               for x in (kv_pool, k_scale_pool, v_scale_pool)):
        raise ValueError("paged_prefix_attend: kv_pool and its scale pools "
                         "must be contiguous (pools are read in place, never "
                         "copied)")
    dev = q.device
    q = q.contiguous()
    _check_aligned("paged_prefix_attend", q=q, kv_pool=kv_pool)
    tables = [x.to(device=dev, dtype=torch.int32).contiguous()
              for x in (bt_k, bt_v, plen)]
    # the serving paths' pools keep their instances (kPool 0 and 1); the
    # int8 one reads both scale pools, so raw int8 V is a general pairing
    body = ck.kv_body(kv_pool, k_scale_pool, kv_pool, v_scale_pool,
                      int8_raw_v=False)
    m, l, acc = _state(b, h, t, hd, dev)
    wide = hd == ck.WIDE_HD
    fn = _launcher("paged_prefix_attend", 10, 10, 1,
                   lib="paged_prefix_attend_wide" if wide else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), kv_pool.data_ptr(), ck._ptr(k_scale_pool),
                 ck._ptr(v_scale_pool), *(x.data_ptr() for x in tables),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(), b, t, h,
                 kv_pool.shape[1], n_pages, kv_pool.shape[2], hd,
                 _DTYPES[q.dtype], int(int8), body, float(softcap), stream)
    if err:
        raise RuntimeError(f"paged_prefix_attend launch failed: CUDA error "
                           f"{err}")
    ck.count_launch(LAUNCHES, "paged_prefix_attend",
                    **ck.kv_modes(body, kv_pool, k_scale_pool, kv_pool,
                                  v_scale_pool), softcap=softcap,
                    wide=wide)
    return m, l, acc


class FlashDecodeLaunch(NamedTuple):
    """How a flash decode call is cut: ``n_split`` ranges of
    ``tiles_per_split`` whole tiles (the last may be shorter), each block
    serving ``heads_per_block`` query heads of one KV group, and the
    block's shared memory in bytes (fixed in S)."""
    n_split: int
    tiles_per_split: int
    heads_per_block: int
    smem_bytes: int


def decode_block_smem_bytes(heads_per_block: int, hd: int = 0) -> int:
    """``sizeof(BlockSmem<kH, kHdMax>)`` of ``csrc/decode_tiles.cuh`` for
    the instance head dim ``hd`` takes (kMaxHd up to 256, kWideHd above;
    0: the kMaxHd one): the block's queries, a chunk of scores per head,
    the AV partials, the merge factors and m, l, alpha per head (fp32),
    and a flag. No term depends on the sequence length."""
    kh = 1 if heads_per_block == 1 else _DECODE_HEADS
    widest = _DECODE_WIDE_HD if hd > _DECODE_MAX_HD else _DECODE_MAX_HD
    floats = (kh * widest + kh * _DECODE_CHUNK
              + kh * _DECODE_THREADS * _DECODE_RED_VEC
              + kh * _DECODE_MAX_SPLIT + 3 * kh)
    return floats * 4 + 4


def flash_decode_launch_config(b: int, h: int, kv: int, n_tiles: int,
                               hd: int = 0) -> FlashDecodeLaunch:
    """The launch of a flash decode call with ``b`` batch rows, ``h``
    query heads over ``kv`` KV groups and ``n_tiles`` tiles per row (the
    dense call's S / ts, the paged call's pages), at head dim ``hd`` (0:
    any up to 256): blocks of up to two heads of a group, and
    ``chai_attention.split_plan`` over the units (b, group, head slice).
    It reads shapes only, never ``pos`` or the layout, so the dense and
    the paged call at equal shapes cut alike."""
    qpk = h // kv
    hb = min(qpk, _DECODE_HEADS)
    n_split, per = ck.split_plan(b, kv * -(-qpk // hb), n_tiles)
    return FlashDecodeLaunch(n_split, per, hb,
                             decode_block_smem_bytes(hb, hd))


def dense_decode_config(q, k_cache, ts=0):
    """(the launch, the S-tile) of ``flash_decode`` on these tensors
    (their shapes only: any device, ``meta`` too)."""
    s = k_cache.shape[2]
    tile = fused_tile_size(ts, s)
    return flash_decode_launch_config(q.shape[0], q.shape[1],
                                      k_cache.shape[1], s // tile,
                                      q.shape[2]), tile


def paged_decode_config(q, kv_pool, bt_k):
    """The launch of ``paged_decode`` on these tensors (their shapes
    only); the tile is the page. Equal to the dense call's at S == P *
    page and ts == page."""
    return flash_decode_launch_config(q.shape[0], q.shape[1],
                                      kv_pool.shape[1], bt_k.shape[-1],
                                      q.shape[2])


def _check_decode(name, q, kv_heads, hd, pos):
    """Checks both decode wrappers share; returns q's type flag."""
    b, h = q.shape[:2]
    if hd % 8 or not 0 < hd <= _DECODE_WIDE_HD:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 "
                         f"and at most {_DECODE_WIDE_HD} (16-byte row loads; "
                         f"the wide instance above {_DECODE_MAX_HD})")
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be fp32 or bf16; got {q.dtype}")
    if q.ndim != 3 or kv_heads == 0 or h % kv_heads:
        raise ValueError(f"{name}: q must be (B, H, hd) with KV={kv_heads} "
                         f"dividing H; got {tuple(q.shape)}")
    if pos.shape != (b,):
        raise ValueError(f"{name}: pos must be (B={b},); got "
                         f"{tuple(pos.shape)}")
    return _DTYPES[q.dtype]


def _decode_scratch(cfg, b, h, kv, hd, dev, stream):
    """The split scratch (all None when not split): partial m, l
    (B, n_split, H), acc (B, n_split, H, hd) and one ticket counter per
    unit (b, group, head slice), shared with the CHAI kernels."""
    units = b * kv * -(-(h // kv) // cfg.heads_per_block)
    return ck.split_scratch(cfg.n_split, b, h, h, hd, units, dev, stream)


def flash_decode(q, k_cache, v_cache, pos, *, window=0, ts=0):
    """Decode attention of one query token over a dense cache on the GPU.

    q: (B, H, hd) fp32/bf16; k_cache/v_cache: (B, KV, S, hd) fp32/bf16,
    contiguous (read in place); pos: (B,) int (the current position; keys
    idx <= pos are visible, and pos - idx < window when window > 0). Head
    h reads KV row h // (H // KV). ``ts``: the S-tile of the online
    softmax (0: S; the whole sequence when it does not divide S, the
    reference's rule). Returns (B, H, hd) fp32 from ONE kernel launch."""
    b, h, hd = q.shape
    q_bf16 = _check_decode("flash_decode", q, k_cache.shape[1], hd, pos)
    if (k_cache.ndim != 4 or k_cache.shape[0] != b
            or k_cache.shape[3] != hd or v_cache.shape != k_cache.shape
            or v_cache.dtype != k_cache.dtype
            or k_cache.dtype not in _DTYPES):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)} {k_cache.dtype}, v "
                         f"{tuple(v_cache.shape)} {v_cache.dtype} do not "
                         "match")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("flash_decode: the caches must be contiguous (they "
                         "are read in place, never copied)")
    dev = q.device
    n_kv, s = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    _check_aligned("flash_decode", q=q, k_cache=k_cache, v_cache=v_cache)
    cfg, tile = dense_decode_config(q, k_cache, ts)
    p = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _launcher("flash_decode", 9, 12)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _decode_scratch(cfg, b, h, n_kv, hd, dev, stream)
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 p.data_ptr(), out.data_ptr(), *map(ck._ptr, scratch), b, h,
                 n_kv, s, hd, tile, int(window), cfg.heads_per_block,
                 cfg.n_split, cfg.tiles_per_split, q_bf16,
                 _DTYPES[k_cache.dtype], stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    ck.count_launch(LAUNCHES, "flash_decode", wide=hd > _DECODE_MAX_HD)
    return out


def paged_decode(q, kv_pool, bt_k, bt_v, pos, *, window=0):
    """``flash_decode`` over one shared K/V page pool on the GPU.

    q: (B, H, hd) fp32/bf16; kv_pool: (nP, KV, page, hd) fp32/bf16, one
    layer's pool, read in place (it must be contiguous already: a copy
    would move the whole pool every call); bt_k/bt_v: (B, P) block tables
    (K and V are distinct pages of the one pool; null entries name page 0
    and lie past pos); pos: (B,). The logical length is P * page, the
    tile is the page. Returns (B, H, hd) fp32 from ONE kernel launch,
    bitwise equal to ``flash_decode`` of the densified pool at
    ts == page."""
    b, h, hd = q.shape
    q_bf16 = _check_decode("paged_decode", q, kv_pool.shape[1], hd, pos)
    n_pages = bt_k.shape[-1]
    if (kv_pool.ndim != 4 or kv_pool.shape[3] != hd
            or kv_pool.dtype not in _DTYPES
            or bt_k.shape != (b, n_pages) or bt_v.shape != (b, n_pages)):
        raise ValueError(f"paged_decode: q {tuple(q.shape)}, kv_pool "
                         f"{tuple(kv_pool.shape)} {kv_pool.dtype}, bt_k "
                         f"{tuple(bt_k.shape)}, bt_v {tuple(bt_v.shape)} do "
                         "not match")
    if not kv_pool.is_contiguous():
        raise ValueError("paged_decode: kv_pool must be contiguous (pools "
                         "are read in place, never copied)")
    dev = q.device
    n_kv, page = kv_pool.shape[1], kv_pool.shape[2]
    q = q.contiguous()
    _check_aligned("paged_decode", q=q, kv_pool=kv_pool)
    cfg = paged_decode_config(q, kv_pool, bt_k)
    tables = [x.to(device=dev, dtype=torch.int32).contiguous()
              for x in (bt_k, bt_v, pos)]
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _launcher("paged_decode", 10, 12)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = _decode_scratch(cfg, b, h, n_kv, hd, dev, stream)
        err = fn(q.data_ptr(), kv_pool.data_ptr(),
                 *(x.data_ptr() for x in tables), out.data_ptr(),
                 *map(ck._ptr, scratch), b, h, n_kv, n_pages, page, hd,
                 int(window), cfg.heads_per_block, cfg.n_split,
                 cfg.tiles_per_split, q_bf16, _DTYPES[kv_pool.dtype],
                 stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    ck.count_launch(LAUNCHES, "paged_decode", wide=hd > _DECODE_MAX_HD)
    return out
