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
kernels run one block body (``csrc/chai_decode_tiles.cuh``), so at equal
tile size (dense ``ts`` == page) their outputs are bitwise equal.

``LAUNCHES`` counts each kernel's launches, one per successful launch,
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"chai_fused_decode": 0, "paged_chai_fused_decode": 0}

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use


def fused_tile_size(ts: int, s: int) -> int:
    """The S-tile the kernel uses: ``ts`` capped at S, and the whole
    sequence when ``ts`` does not divide it (the reference's rule)."""
    ts = min(ts, s) if ts else s
    return s if s % ts else ts


def _launcher(name, n_ptrs, n_ints):
    from repro_torch.kernels import build
    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _refuse_unported(name, k_scale, v_scale, share_values, softcap,
                     emit_state):
    for flag, what in ((k_scale is not None, "int8 K scales"),
                       (v_scale is not None, "int8 V scales"),
                       (share_values, "share_values"),
                       (bool(softcap), "softcap"),
                       (emit_state, "emit_state")):
        if flag:
            raise NotImplementedError(
                f"{name}: {what} is not ported to CUDA yet")


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
    if hd % 2:
        raise ValueError(f"head_dim {hd} must be even (paired V loads)")
    return b, r_total, hd, h_total, h2c


def _small(t, dev):
    """int32 contiguous copy of a small index tensor (h2c, pos, tables)."""
    return t.to(device=dev, dtype=torch.int32).contiguous()


def chai_fused_decode(q_rep, k_cache, v_cache, h2c, pos, *, k_scale=None,
                      v_scale=None, reps_per_group=1, share_values=False,
                      window=0, ts=512, softcap=0.0, emit_state=False):
    """One-pass fused clustered decode over a dense cache, on the GPU.

    q_rep: (B, R, hd) rep-head queries (any float dtype; read as fp32);
    k_cache: (B, KVk, S, hd) with KVk * reps_per_group == R (MHA
    clustered cache: KVk == R); v_cache: (B, KVv, S, hd), per-head
    (KVv == H) or per-group (H % KVv == 0); K/V fp32 or bf16, one dtype;
    h2c: (B, H) or (H,) head -> rep row, values in [0, R); pos: (B,).
    Returns (B, H, hd) fp32 from ONE kernel launch.
    """
    _refuse_unported("chai_fused_decode", k_scale, v_scale, share_values,
                     softcap, emit_state)
    s = k_cache.shape[2]
    b, r_total, hd, h_total, h2c = _check_common(
        "chai_fused_decode", q_rep, k_cache, v_cache, h2c, reps_per_group)
    kv_k, kv_v = k_cache.shape[1], v_cache.shape[1]
    if (k_cache.shape[0] != b or k_cache.shape[3] != hd
            or v_cache.shape != (b, kv_v, s, hd)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    ts = fused_tile_size(ts, s)
    smem = (hd + s + 3 * (s // ts)) * 4 + h_total * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"S={s} (tile {ts}) needs {smem} B of shared "
                         "memory for its scores, above the block limit")
    dev = q_rep.device
    q = q_rep.float().contiguous()
    k = k_cache.contiguous()
    v = v_cache.contiguous()
    for name, t in (("k_cache", k), ("v_cache", v)):
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must be aligned to two elements")
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    out = torch.empty((b, h_total, hd), dtype=torch.float32, device=dev)
    fn = _launcher("chai_fused_decode", 6, 12)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), b, r_total, h_total, kv_k,
                 kv_v, s, hd, ts, reps_per_group, h_total // kv_v,
                 int(window), _KV_DTYPES[k.dtype], stream)
    if err:
        raise RuntimeError(f"chai_fused_decode launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["chai_fused_decode"] += 1
    return out


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
    pos: (B,). K/V fp32 or bf16, one dtype. The pools are layer slices
    of the engine's state and are read in place: they must be contiguous
    already (a copy would move the whole pool every call). Returns
    (B, H, hd) fp32 from ONE kernel launch.
    """
    _refuse_unported("paged_chai_fused_decode", k_scale_pool, v_scale_pool,
                     share_values, softcap, emit_state)
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
    smem = ((hd + n_pages * page + 3 * n_pages) * 4 + h_total * 4
            + 2 * n_pages * 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{n_pages} pages of {page} need {smem} B of "
                         "shared memory, above the block limit")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pools are read "
                             "in place, never copied)")
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must be aligned to two elements")
    dev = q_rep.device
    q = q_rep.float().contiguous()
    bt_k_i, bt_v_i = _small(bt_k, dev), _small(bt_v, dev)
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    out = torch.empty((b, h_total, hd), dtype=torch.float32, device=dev)
    fn = _launcher("paged_chai_fused_decode", 8, 12)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 bt_k_i.data_ptr(), bt_v_i.data_ptr(), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), b, r_total, h_total,
                 kv_k, kv_v, n_pages, page, hd, reps_per_group,
                 h_total // kv_v, int(window), _KV_DTYPES[k_pool.dtype],
                 stream)
    if err:
        raise RuntimeError(f"paged_chai_fused_decode launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["paged_chai_fused_decode"] += 1
    return out
