"""Hand-written CUDA kernels for Clustered Head Attention, and their wrappers.

``chai_fused_decode`` launches ``csrc/chai_fused_decode.cu`` (the port of
the reference's Pallas ``chai_fused_decode``): one-pass clustered decode
over a dense cache — rep-head scores, online softmax per rep row, h2c
broadcast and per-head AV in one launch, with no (B, R, S) score tensor
in device memory. The wrapper takes CUDA tensors only; the CPU path is
the plain version in ``kernels.ref``, chosen by ``kernels.ops``.

``LAUNCHES`` counts the kernel's launches, one per successful launch,
so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"chai_fused_decode": 0}

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use


def fused_tile_size(ts: int, s: int) -> int:
    """The S-tile the kernel uses: ``ts`` capped at S, and the whole
    sequence when ``ts`` does not divide it (the reference's rule)."""
    ts = min(ts, s) if ts else s
    return s if s % ts else ts


def _launcher():
    from repro_torch.kernels import build
    fn = build.load("chai_fused_decode").chai_fused_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    for flag, name in ((k_scale is not None, "k_scale"),
                       (v_scale is not None, "v_scale"),
                       (share_values, "share_values"),
                       (bool(softcap), "softcap"),
                       (emit_state, "emit_state")):
        if flag:
            raise NotImplementedError(
                f"chai_fused_decode: {name} is not ported to CUDA yet")
    if q_rep.device.type != "cuda":
        raise ValueError("chai_fused_decode launches a CUDA kernel; got "
                         f"tensors on {q_rep.device}")
    b, r_total, hd = q_rep.shape
    _, kv_k, s, _ = k_cache.shape
    kv_v = v_cache.shape[1]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    h_total = h2c.shape[1]
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _KV_DTYPES:
        raise TypeError(f"K/V must share one dtype of fp32/bf16; got "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if (k_cache.shape[0] != b or k_cache.shape[3] != hd
            or v_cache.shape != (b, kv_v, s, hd)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if kv_k * reps_per_group != r_total or h_total % kv_v:
        raise ValueError(f"R={r_total} must be KVk={kv_k} x reps_per_group="
                         f"{reps_per_group} and KVv={kv_v} must divide "
                         f"H={h_total}")
    if hd % 2:
        raise ValueError(f"head_dim {hd} must be even (paired V loads)")
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
    h2c_i = h2c.to(device=dev, dtype=torch.int32).contiguous()
    pos_i = pos.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((b, h_total, hd), dtype=torch.float32, device=dev)
    fn = _launcher()
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
