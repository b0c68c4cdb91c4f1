"""K-Means on tensors, batched over any leading dimensions.

Same algorithm and tie rules as the reference's ``core/kmeans.py``, so
both give the same membership from the same features: distances are
``x² + c² − 2x·c``, ``argmax``/``argmin`` take the first index,
initialization is deterministic farthest-point, and an empty cluster keeps
its old center. ``x`` is ``(..., n, f)``; every leading index is an
independent problem (the reference vmaps, the port batches).

Ties are structural here: the two members of a two-head cluster lie at
exactly the same distance from their center, so which one becomes the
representative is decided by rounding. To pick the same one as the
reference, the sums that feed a distance are taken in the order the
reference's CPU backend takes them, which is fixed IEEE fp32 arithmetic
and so gives the same bits on any device: ``xla_sum`` adds each run of 32
elements left to right and then the run totals (XLA's CPU tree-reduction
rewrite), and ``xla_dot`` runs interleaved fused multiply-add
accumulators and adds them pairwise at the end: four for the distance
products against at most 24 centers, two against more, one for the
center sums (the loops XLA's CPU dot emitter produces for these shapes,
found by matching its results bit for bit; ``tests/test_torch_chai_core``
holds the port to them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _seq_sum(x):
    """Left-to-right fp32 sum over the last axis."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x):
    """fp32 sum over the last axis: runs of 32 left to right, then the
    run totals the same way."""
    n = x.shape[-1]
    if n <= 32 or n % 32:
        return _seq_sum(x)
    return xla_sum(_seq_sum(x.unflatten(-1, (n // 32, 32))))


def xla_dot(a, b, lanes):
    """a: (..., n, f), b: (..., k, f) -> (..., n, k) fp32 dot products
    over f in ``lanes`` interleaved accumulators (accumulator i takes
    positions i, i + lanes, ...), summed pairwise at the end. Each step is
    a fused multiply-add (exact product, one rounding), carried out in
    fp64 and rounded to fp32."""
    f = a.shape[-1]
    if f % lanes:
        pad = (0, lanes - f % lanes)
        a, b = F.pad(a, pad), F.pad(b, pad)
    a2 = a.double().unflatten(-1, (-1, lanes))[..., :, None, :, :]
    b2 = b.double().unflatten(-1, (-1, lanes))[..., None, :, :, :]
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    acc = torch.zeros(lead + (a.shape[-2], b.shape[-2], lanes),
                      dtype=torch.float32, device=a.device)
    for i in range(a2.shape[-2]):
        acc = (acc.double() + a2[..., i, :] * b2[..., i, :]).float()
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc[..., 0]


def _sq_norms(x):
    return xla_sum(x.square())


def _pairwise_sq_dists(x, c):
    """x: (..., n, f); c: (..., k, f) -> (..., n, k)."""
    lanes = 4 if c.shape[-2] <= 24 else 2
    return (_sq_norms(x)[..., None] + _sq_norms(c)[..., None, :]
            - 2.0 * xla_dot(x, c, lanes))


def _take_row(x, idx):
    """x: (..., n, f); idx: (...) -> (..., f)."""
    return torch.gather(x, -2, idx[..., None, None].expand(
        *idx.shape, 1, x.shape[-1])).squeeze(-2)


def farthest_point_init(x, k):
    """Deterministic k-center init: start at the point farthest from the
    mean, then greedily add the point farthest from chosen centers."""
    mean = _seq_sum(x.transpose(-1, -2)) / x.shape[-2]
    d0 = _sq_norms(x - mean[..., None, :])
    first = _take_row(x, torch.argmax(d0, -1))
    centers = [first]
    mind = _sq_norms(x - first[..., None, :])
    for _ in range(1, k):
        nxt = _take_row(x, torch.argmax(mind, -1))
        centers.append(nxt)
        mind = torch.minimum(mind, _sq_norms(x - nxt[..., None, :]))
    return torch.stack(centers, dim=-2)


def kmeans(x, k: int, iters: int = 12):
    """Lloyd's algorithm. x: (..., n, f). Returns (assign (..., n) int64,
    centers (..., k, f), error (...): sum of squared distances)."""
    x = x.float()
    centers = farthest_point_init(x, k)
    for _ in range(iters):
        d = _pairwise_sq_dists(x, centers)
        onehot = F.one_hot(torch.argmin(d, -1), k).float()   # (..., n, k)
        counts = onehot.sum(-2)                               # (..., k)
        sums = xla_dot(onehot.transpose(-1, -2),
                       x.transpose(-1, -2), 1)                # (..., k, f)
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts[..., None], min=1.0),
                              centers)
    d = _pairwise_sq_dists(x, centers)
    return torch.argmin(d, -1), centers, d.amin(-1).sum(-1)


def representatives(x, assign, centers, k: int):
    """Representative member per cluster = member closest to its center.

    Returns (reps (..., k) int32 — indices into x; valid (..., k) bool).
    An empty cluster points its rep at member 0 (never referenced)."""
    d = _pairwise_sq_dists(x, centers)                     # (..., n, k)
    member = F.one_hot(assign, k).bool()
    reps = torch.argmin(torch.where(member, d, torch.inf), dim=-2)
    valid = member.any(-2)
    return torch.where(valid, reps, 0).to(torch.int32), valid
