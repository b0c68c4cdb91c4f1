"""Int8 error-feedback gradient compression for the cross-pod reduction
(the reference's ``optim/compression.py`` in torch ops).

Gradients are reduced within a pod at full precision; across pods each
leaf is quantized to int8 with one fp32 scale, the quantization error is
carried into the next step's gradient (error feedback keeps the scheme
unbiased over steps), and the int8 payload is summed as int32 over the
pods. ``compressed_psum`` takes an explicit ``torch.distributed`` process
group in place of the reference's ``shard_map`` axis name; the pod-manual
wrapper (``wrap_pod_manual``) and the compressed train step need a mesh
with a pod axis and wait for ROADMAP #16.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map, tree_pick


def _quantize(g):
    """Symmetric per-tensor int8. Returns (q int8, scale 0-d fp32)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def compress_residual_init(params):
    """Error-feedback residual buffer, same shapes as params (fp32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grads, residual, group=None):
    """Error-feedback int8 sum over the ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default group).

    grads/residual: local (already in-pod-reduced) fp32 trees. Returns
    (mean grads fp32, new residual fp32): each rank's codes are summed in
    int32 (no wraparound up to 2^23 ranks) and scaled by the mean of the
    ranks' scales, as in the reference."""
    n = dist.get_world_size(group)

    def one(g, r):
        g = g.float() + r                       # fold in carried error
        q, scale = _quantize(g)
        err = g - _dequantize(q, scale)          # local quantization error
        total = q.to(torch.int32)
        dist.all_reduce(total, group=group)
        s_tot = scale.reshape(1).clone()
        dist.all_reduce(s_tot, group=group)      # shared mean scale
        mean = total.float() * (s_tot[0] / n) / n
        return mean, err

    out = tree_map(one, grads, residual)
    return tree_pick(out, 0), tree_pick(out, 1)

