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
of ``csrc/flash_tiles.cuh``.

``flash_decode`` launches ``csrc/flash_decode.cu`` (the port of the Pallas
``flash_decode``): plain MHA/GQA decode attention of one query token over
a dense (B, KV, S, hd) cache; ``paged_decode`` launches
``csrc/paged_decode.cu`` (the port of the Pallas ``paged_decode``): the
same over one shared K/V page pool read through block tables. The MHA
baseline (CHAI off) decodes through them. Both share the block body of
``csrc/decode_tiles.cuh``, so at ts == page they are bitwise equal.

The wrappers take CUDA tensors only; the CPU path is the plain version in
``kernels.ref``, chosen by ``kernels.ops``. ``LAUNCHES`` counts each
kernel's launches, one per successful launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.chai_attention import (decode_step_size,
                                                 fused_tile_size)

LAUNCHES = {"flash_prefill": 0, "paged_prefix_attend": 0,
            "flash_decode": 0, "paged_decode": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (8, 16, 32, 64, 128, 256)     # flash_tiles.cuh: with_head_dim
_DECODE_MAX_HD = 256     # decode_tiles.cuh: kMaxHd
_DECODE_HEADS = 8        # decode_tiles.cuh: with_heads, query heads a block


def _launcher(name, n_ptrs, n_ints):
    from repro_torch.kernels import build
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_unported(name, window=0, softcap=0.0, scale_pools=False):
    for flag, what in ((bool(window), "window (local attention: ROADMAP "
                        "Queue 1 #14, rest of the arch zoo)"),
                       (bool(softcap), "softcap (ROADMAP Queue 1 #14, rest "
                        "of the arch zoo)"),
                       (scale_pools, "int8 scale pools (int8 KV: ROADMAP "
                        "Queue 1 #2)")):
        if flag:
            raise NotImplementedError(f"{name}: {what} is not ported yet")


def _check_heads(name, q, kv_heads, hd):
    """Device, dtype and head checks both wrappers share."""
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
    if hd not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} is not one the kernel is "
                         f"built for {_HEAD_DIMS}")


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
    (read on the device; no host sync). Returns (B, T, H, hd) in q's
    dtype, or with ``emit_state`` the head-major triple (m (B, H, T),
    l (B, H, T), acc (B, H, T, hd)) fp32, from ONE kernel launch.
    """
    _refuse_unported("flash_prefill", window=window, softcap=softcap)
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
    fn = _launcher("flash_prefill", 8, 8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), off.data_ptr(),
                 *ptrs, b, t, s, h, kv, hd, int(emit_state),
                 _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    LAUNCHES["flash_prefill"] += 1
    return (m, l, acc) if emit_state else out


def paged_prefix_attend(q, kv_pool, bt_k, bt_v, plen, *, k_scale_pool=None,
                        v_scale_pool=None, softcap=0.0):
    """Queries over cached prefix pages on the GPU, with no causal mask.

    q: (B, T, H, hd); kv_pool: (nP, KV, page, hd), one layer's pool in
    q's dtype (fp32/bf16), read in place: it must be contiguous already
    (a copy would move the whole pool every call); bt_k/bt_v: (B, P)
    block tables (K and V are distinct pages of the one pool); plen:
    (B,) cached positions (cut at P * page). Returns the head-major
    triple (m (B, H, T), l (B, H, T), acc (B, H, T, hd)) fp32 from ONE
    kernel launch; a row with plen == 0 holds the merge identity
    (m = -2e38, l = 0, acc = 0) and reads no page.
    """
    _refuse_unported("paged_prefix_attend", softcap=softcap,
                     scale_pools=(k_scale_pool is not None
                                  or v_scale_pool is not None))
    b, t, h, hd = q.shape
    _check_heads("paged_prefix_attend", q, kv_pool.shape[1], hd)
    n_pages = bt_k.shape[-1]
    if (kv_pool.dtype != q.dtype or kv_pool.ndim != 4
            or kv_pool.shape[3] != hd or bt_k.shape != (b, n_pages)
            or bt_v.shape != (b, n_pages) or plen.shape != (b,)):
        raise ValueError(f"paged_prefix_attend: q {tuple(q.shape)} "
                         f"{q.dtype}, kv_pool {tuple(kv_pool.shape)} "
                         f"{kv_pool.dtype}, bt_k {tuple(bt_k.shape)}, bt_v "
                         f"{tuple(bt_v.shape)}, plen {tuple(plen.shape)} do "
                         "not match")
    if not kv_pool.is_contiguous():
        raise ValueError("paged_prefix_attend: kv_pool must be contiguous "
                         "(pools are read in place, never copied)")
    dev = q.device
    q = q.contiguous()
    _check_aligned("paged_prefix_attend", q=q, kv_pool=kv_pool)
    tables = [x.to(device=dev, dtype=torch.int32).contiguous()
              for x in (bt_k, bt_v, plen)]
    m, l, acc = _state(b, h, t, hd, dev)
    fn = _launcher("paged_prefix_attend", 8, 8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), kv_pool.data_ptr(),
                 *(x.data_ptr() for x in tables), m.data_ptr(), l.data_ptr(),
                 acc.data_ptr(), b, t, h, kv_pool.shape[1], n_pages,
                 kv_pool.shape[2], hd, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"paged_prefix_attend launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["paged_prefix_attend"] += 1
    return m, l, acc


def _check_decode(name, q, kv_heads, hd, pos):
    """Checks both decode wrappers share; returns (hb, q_bf16): the
    query heads each block serves and q's type flag."""
    b, h = q.shape[:2]
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: q must be fp32 or bf16; got {q.dtype}")
    if q.ndim != 3 or kv_heads == 0 or h % kv_heads:
        raise ValueError(f"{name}: q must be (B, H, hd) with KV={kv_heads} "
                         f"dividing H; got {tuple(q.shape)}")
    if hd % 8 or not 0 < hd <= _DECODE_MAX_HD:
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 "
                         f"and at most {_DECODE_MAX_HD} (16-byte row loads)")
    if pos.shape != (b,):
        raise ValueError(f"{name}: pos must be (B={b},); got "
                         f"{tuple(pos.shape)}")
    return min(h // kv_heads, _DECODE_HEADS), _DTYPES[q.dtype]


def flash_decode(q, k_cache, v_cache, pos, *, window=0, ts=0):
    """Decode attention of one query token over a dense cache on the GPU.

    q: (B, H, hd) fp32/bf16; k_cache/v_cache: (B, KV, S, hd) fp32/bf16,
    contiguous (read in place); pos: (B,) int (the current position; keys
    idx <= pos are visible, and pos - idx < window when window > 0). Head
    h reads KV row h // (H // KV). ``ts``: the S-tile of the online
    softmax (0: S; the whole sequence when it does not divide S, the
    reference's rule). Returns (B, H, hd) fp32 from ONE kernel launch."""
    b, h, hd = q.shape
    hb, q_bf16 = _check_decode("flash_decode", q, k_cache.shape[1], hd, pos)
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
    step = decode_step_size(fused_tile_size(ts, s))
    p = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _launcher("flash_decode", 5, 10)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 p.data_ptr(), out.data_ptr(), b, h, n_kv, s, hd, step,
                 int(window), hb, q_bf16, _DTYPES[k_cache.dtype], stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    LAUNCHES["flash_decode"] += 1
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
    hb, q_bf16 = _check_decode("paged_decode", q, kv_pool.shape[1], hd, pos)
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
    tables = [x.to(device=dev, dtype=torch.int32).contiguous()
              for x in (bt_k, bt_v, pos)]
    out = torch.empty((b, h, hd), dtype=torch.float32, device=dev)
    fn = _launcher("paged_decode", 6, 11)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), kv_pool.data_ptr(),
                 *(x.data_ptr() for x in tables), out.data_ptr(), b, h,
                 n_kv, n_pages, page, hd, decode_step_size(page),
                 int(window), hb, q_bf16, _DTYPES[kv_pool.dtype], stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    LAUNCHES["paged_decode"] += 1
    return out
