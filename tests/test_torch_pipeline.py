"""The port's three-kernel CHAI decode pipeline against the JAX package's,
on the CPU.

Stage level: each plain version (``kernels/ref.py``) against its Pallas
kernel in interpret mode, on the same numpy inputs: raw scores of
``chai_qk_ref`` / ``chai_qk_i8_ref`` / ``paged_chai_qk_ref`` at atol =
rtol = 1e-5 with the masked entries exactly ``NEG_INF`` (-2e38) in both,
``row_softmax_ref`` (a fully masked row gives zeros) and
``softmax_launch_config`` (every entry read once, clusters and blocks
within their limits; the kernel's arithmetic in its plan order against
the Pallas ``row_softmax``), ``chai_av_ref`` /
``paged_chai_av_ref`` (h2c (B, H) and (H,); fp32, bf16 and int8 V codes
read as values) at 2e-5; MHA, GQA, window, int8 and paged (shuffled
pages, null page 0 in the tables past pos), and the QK pair on raw int8
codes read as values (the Pallas bodies' cast). The QK kernels' launch
plan (``qk_launch_config``: every (batch row, K row, position) once,
every rep served) and their summation order in torch (per-load fma
partials, lane sums, the shuffle tree) against the Pallas ``chai_qk`` /
``chai_qk_i8``. The AV kernels' split plan
(``av_launch_config``: every tile once and in order, dense == paged,
its scratch, its load width) and their split-and-merge in torch against
the Pallas ``chai_av``.

Driver level: ``ops.chai_three_kernel_decode`` and
``ops.paged_chai_three_kernel_decode`` against the reference's
``ref.chai_three_kernel_decode`` / ``paged_chai_three_kernel_decode``
(k_scale, v_scale, share_values, GQA, window) at 2e-5; the lane's three
estimators equal to the reference's; ``quant_rows`` / ``dequant_rows``
bit-equal to the reference's; the CUDA wrappers refuse CPU tensors (the
QK and AV pairs' int8 codes too) and keep the Pallas wrappers' shape
assertions.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import cache as jcache
from repro.kernels import chai_attention as jck
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import cache as tcache
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
TOL = dict(atol=2e-5, rtol=2e-5)
NEG_INF = -2.0e38


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _hold_scores(got, want, value_range=1.0):
    """Raw scores: masked entries exactly NEG_INF in both, the rest at
    1e-5 (over ``value_range``: raw int8 codes are held over theirs)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    masked = want == np.float32(NEG_INF)
    assert np.array_equal(got == np.float32(NEG_INF), masked)
    np.testing.assert_allclose(got[~masked] / value_range,
                               want[~masked] / value_range, **SCORE_TOL)
    return masked


def _tables(rng, b, n_pages, n_pool, pos, page):
    """Shuffled distinct pages per row; entries past a row's last live
    page point at the null page 0."""
    perm = rng.permutation(np.arange(1, n_pool))[:b * n_pages]
    bt = perm.reshape(b, n_pages).astype(np.int32)
    for i in range(b):
        bt[i, pos[i] // page + 1:] = 0
    return bt


def _gqa_h2c(rng, b, kv, rpg, qpk):
    cluster_of = rng.integers(0, rpg, size=(b, kv, qpk))
    return (np.arange(kv)[None, :, None] * rpg
            + cluster_of).reshape(b, kv * qpk).astype(np.int32)


# ------------------------------------------------------------ QK ---------
@pytest.mark.parametrize("b,kv,rpg,s,hd,ts,window", [
    (2, 4, 1, 32, 16, 8, 0),       # MHA clustered cache (KV == R)
    (2, 2, 3, 64, 16, 16, 0),      # GQA: rep j reads K row j // 3
    (3, 3, 1, 64, 8, 16, 24),      # window
])
def test_chai_qk_ref_matches_pallas(rng, b, kv, rpg, s, hd, ts, window):
    q = _normal(rng, (b, kv * rpg, hd))
    k = _normal(rng, (b, kv, s, hd))
    pos = rng.integers(1, s, size=b).astype(np.int32)
    pos[0] = 0                                      # one live position
    want = jck.chai_qk(_j(q), _j(k), _j(pos), reps_per_group=rpg,
                       window=window, ts=ts, interpret=True)
    got = tref.chai_qk_ref(_t(q), _t(k), _t(pos), reps_per_group=rpg,
                           window=window)
    masked = _hold_scores(got, want)
    assert masked[0, :, 1:].all() and not masked[0, :, 0].any()


def test_chai_qk_ref_bf16_cache(rng):
    b, r, s, hd = 2, 3, 32, 16
    q = _normal(rng, (b, r, hd))
    k = _j(_normal(rng, (b, r, s, hd))).astype(jnp.bfloat16)
    pos = np.array([31, 9], np.int32)
    want = jck.chai_qk(_j(q), k, _j(pos), ts=8, interpret=True)
    k_t = torch.from_numpy(np.array(k).view(np.uint16)).view(
        torch.bfloat16)
    _hold_scores(tref.chai_qk_ref(_t(q), k_t, _t(pos)), want)


@pytest.mark.parametrize("b,kv,rpg,s,hd,ts,window", [
    (2, 4, 1, 32, 16, 8, 0),
    (1, 2, 3, 64, 32, 16, 0),
    (2, 2, 2, 64, 16, 32, 20),
])
def test_chai_qk_i8_ref_matches_pallas(rng, b, kv, rpg, s, hd, ts, window):
    """int8 codes from the port's ``quant_rows``; the scale applied after
    the dot, in the kernel's order."""
    q = _normal(rng, (b, kv * rpg, hd))
    kq, ks = tcache.quant_rows(_t(_normal(rng, (b, kv, s, hd))))
    pos = rng.integers(1, s, size=b).astype(np.int32)
    want = jck.chai_qk_i8(_j(q), _j(kq.numpy()), _j(ks.numpy()), _j(pos),
                          reps_per_group=rpg, window=window, ts=ts,
                          interpret=True)
    got = tref.chai_qk_i8_ref(_t(q), kq, ks, _t(pos), reps_per_group=rpg,
                              window=window)
    _hold_scores(got, want)


@pytest.mark.parametrize("b,kv,rpg,n_pages,page,hd", [
    (2, 3, 1, 4, 8, 16),           # MHA clustered pool
    (2, 2, 3, 4, 16, 8),           # GQA groups
])
def test_paged_chai_qk_ref_matches_pallas(rng, b, kv, rpg, n_pages, page,
                                          hd):
    n_pool = b * n_pages + 3
    k_pool = _normal(rng, (n_pool, kv, page, hd))
    pos = rng.integers(1, n_pages * page, size=b).astype(np.int32)
    pos[0] = page + 2                             # later pages null
    bt = _tables(rng, b, n_pages, n_pool, pos, page)
    q = _normal(rng, (b, kv * rpg, hd))
    want = jck.paged_chai_qk(_j(q), _j(k_pool), _j(bt), _j(pos),
                             reps_per_group=rpg, interpret=True)
    got = tref.paged_chai_qk_ref(_t(q), _t(k_pool), _t(bt), _t(pos),
                                 reps_per_group=rpg)
    _hold_scores(got, want)


def _plain_codes(rng, shape):
    """int8 codes to +-127, the scale-less cast (``plain_int8``) of
    values up to ~240, saturated."""
    codes = tcache.plain_int8(_t(_normal(rng, shape) * 60)).numpy()
    assert np.abs(codes).max() == 127
    return codes


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chai_qk_ref_matches_pallas_int8_codes(rng, paged):
    """int8 K without scales, read as its values by the Pallas QK bodies
    (``k_ref[...].astype(float32)``); GQA with a window, the null page 0
    past pos in the tables."""
    b, kv, rpg, n_pages, page, hd, window = 2, 2, 3, 4, 8, 16, 20
    q = _normal(rng, (b, kv * rpg, hd))
    pos = np.array([page + 2, n_pages * page - 1], np.int32)
    kw = dict(reps_per_group=rpg, window=window)
    if paged:
        n_pool = b * n_pages + 1
        k_pool = _plain_codes(rng, (n_pool, kv, page, hd))
        bt = _tables(rng, b, n_pages, n_pool, pos, page)
        want = jck.paged_chai_qk(_j(q), _j(k_pool), _j(bt), _j(pos),
                                 interpret=True, **kw)
        got = tref.paged_chai_qk_ref(_t(q), _t(k_pool), _t(bt), _t(pos),
                                     **kw)
    else:
        k = _plain_codes(rng, (b, kv, n_pages * page, hd))
        want = jck.chai_qk(_j(q), _j(k), _j(pos), ts=page, interpret=True,
                           **kw)
        got = tref.chai_qk_ref(_t(q), _t(k), _t(pos), **kw)
    masked = _hold_scores(got, want)
    assert masked.any() and not masked.all()


# ------------------------------------------------------- QK launch plan ----
def _qk_blocks(cfg, b, kv):
    """The kernel's blocks, as chai_qk.cu numbers them: (chunk, batch
    row, K row, rep slice) of each block index."""
    blk = np.arange(b * kv * cfg.slices * cfg.n_chunks)
    chunk, unit = blk % cfg.n_chunks, blk // cfg.n_chunks
    return (chunk, unit // cfg.slices // kv, unit // cfg.slices % kv,
            unit % cfg.slices)


@pytest.mark.parametrize("hd", [64, 80, 128, 224, 256])
@pytest.mark.parametrize("elem", [4, 2, 1], ids=["fp32", "bf16", "int8"])
@pytest.mark.parametrize("rpg", [1, 5, 12])
def test_qk_launch_config_covers_each_position_once(rpg, elem, hd):
    """Every (batch row, K row, position) in one block and one thread's
    rows, every rep of a K row in one block (at most ``QK_MAX_REPS``),
    every element of a row in one lane's loads, for S from 16 to 65,536;
    the dense and the paged call cut alike (the plan reads S only), and
    the lane's layer-0 shapes and S = 65,536 give the grid at least
    ``QK_FILL_BLOCKS`` blocks."""
    b, kv = 3, 2
    for s in (16, 48, 1024, 4096, 65536):
        cfg = tck.qk_launch_config(b, kv * rpg, kv, s, hd, elem)
        # a block's threads: group g of 128 / lanes, row u of rows, in
        # each round
        groups = tck._THREADS // cfg.lanes
        per_round = groups * cfg.rows
        assert groups * cfg.lanes == tck._THREADS
        assert 1 <= cfg.rows <= tck.QK_ROWS and cfg.positions % 4 == 0
        assert cfg.positions == per_round * cfg.rounds
        assert cfg.positions <= max(tck.QK_MAX_POSITIONS, per_round)
        offs = (np.arange(0, cfg.positions, per_round)[:, None, None]
                + np.arange(groups)[None, :, None]
                + groups * np.arange(cfg.rows)[None, None, :]).ravel()
        assert np.array_equal(np.sort(offs), np.arange(cfg.positions))
        # chunks: c0 = chunk * positions covers [0, S) once, clipped at S
        assert (cfg.n_chunks - 1) * cfg.positions < s
        assert cfg.n_chunks * cfg.positions >= s
        chunk, bb, kr, z = _qk_blocks(cfg, b, kv)
        seen = np.zeros((b, kv, cfg.slices, cfg.n_chunks), np.int64)
        np.add.at(seen, (bb, kr, z, chunk), 1)
        assert (seen == 1).all()
        # reps: slice z of K row kr serves reps [z * rpg // n, (z + 1) *
        # rpg // n), the slices partition the row's reps
        bounds = [z_ * rpg // cfg.slices for z_ in range(cfg.slices + 1)]
        sizes = np.diff(bounds)
        assert bounds[-1] == rpg and (sizes >= 1).all()
        assert sizes.max() == cfg.reps <= tck.QK_MAX_REPS
        # a row's loads: lane l takes loads l, l + lanes, ... of hd / vec
        assert cfg.vec >= 2 and cfg.vec * elem <= 16 and hd % cfg.vec == 0
        cols = hd // cfg.vec
        assert cfg.lanes & (cfg.lanes - 1) == 0 and cfg.lanes <= 32
        assert cfg.lanes >= cols or cfg.lanes == 32
        assert cols > cfg.lanes // 2
        passes = -(-cols // cfg.lanes)
        loads = (np.arange(cfg.lanes)[:, None]
                 + cfg.lanes * np.arange(passes)[None, :]).ravel()
        assert np.array_equal(np.sort(loads[loads < cols]), np.arange(cols))
        assert b * kv * cfg.slices * cfg.n_chunks < 2 ** 31
        # paged: S = P * page gives the same plan
        assert cfg == tck.qk_launch_config(b, kv * rpg, kv, (s // 16) * 16,
                                           hd, elem)
    for bb_, kv_, s_ in ((4, 25, 1024), (4, 8, 1024), (1, 25, 65536)):
        if rpg == 1 or kv_ == 8:
            cfg = tck.qk_launch_config(bb_, kv_ * rpg, kv_, s_, hd, elem)
            assert (bb_ * kv_ * cfg.slices * cfg.n_chunks
                    >= tck.QK_FILL_BLOCKS)


def _qk_body_order(q, k, pos, *, reps_per_group=1, window=0, k_scale=None):
    """chai_qk.cu's arithmetic in torch, in its order: each load's partial
    (a fused multiply-add chain from zero over its elements; fma taken
    as one rounding of the float64 sum), each lane's loads added in load
    order, then the lane group's shuffle tree (offsets lanes / 2 .. 1);
    the row scale and 1 / sqrt(hd) after the dot, and the mask."""
    b, r, hd = q.shape
    s = k.shape[2]
    cfg = tck.qk_launch_config(b, r, k.shape[1], s, hd, k.element_size())
    cols, lanes = hd // cfg.vec, cfg.lanes
    rows = torch.arange(r) // reps_per_group
    prod = (k[:, rows].double() * q.double()[:, :, None, :]).reshape(
        b, r, s, cols, cfg.vec)
    part = torch.zeros(b, r, s, cols)
    for e in range(cfg.vec):
        part = (part.double() + prod[..., e]).float()
    passes = -(-cols // lanes)
    pieces = torch.zeros(b, r, s, passes * lanes)
    pieces[..., :cols] = part
    acc = torch.zeros(b, r, s, lanes)
    for t in range(passes):
        acc = acc + pieces[..., t * lanes:(t + 1) * lanes]
    m = lanes // 2
    while m:
        acc = acc[..., :m] + acc[..., m:2 * m]
        m //= 2
    sc = acc[..., 0]
    if k_scale is not None:
        sc = sc * k_scale[:, rows]
    sc = sc * torch.tensor(1.0 / hd ** 0.5, dtype=torch.float32)
    mask = tref.chai_qk_ref(q, k.float(), pos, reps_per_group=reps_per_group,
                            window=window) == NEG_INF
    return torch.where(mask, torch.tensor(NEG_INF), sc)


@pytest.mark.parametrize("mode", ["mha", "gqa_window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8_scaled",
                                   "int8_codes"])
def test_qk_body_order_matches_pallas(rng, dtype, mode):
    """The QK body's summation order (``_qk_body_order``) against the
    Pallas ``chai_qk`` (``chai_qk_i8`` with scales) in interpret mode at
    1e-5, masked entries exactly NEG_INF: MHA at hd 80 (idle lanes in a
    bf16 group of 16), GQA 5 reps a K row at hd 256 (two passes of fp32
    loads) with a window; raw int8 codes held over their range."""
    b, kv, rpg, s, hd, ts, window = ((2, 3, 1, 48, 80, 16, 0) if mode == "mha"
                                     else (2, 2, 5, 64, 256, 16, 24))
    q = _normal(rng, (b, kv * rpg, hd))
    pos = np.array([5, s - 1], np.int32)
    kw = dict(reps_per_group=rpg, window=window)
    scale = 1.0
    if dtype == "int8_scaled":
        kq, ks = tcache.quant_rows(_t(_normal(rng, (b, kv, s, hd))))
        want = jck.chai_qk_i8(_j(q), _j(kq.numpy()), _j(ks.numpy()), _j(pos),
                              ts=ts, interpret=True, **kw)
        got = _qk_body_order(_t(q), kq, _t(pos), k_scale=ks, **kw)
    else:
        if dtype == "int8_codes":
            k_np, scale = _plain_codes(rng, (b, kv, s, hd)), 127.0
            k_t = _t(k_np)
        else:
            k_j = _j(_normal(rng, (b, kv, s, hd))).astype(dtype)
            k_np = np.array(k_j)
            k_t = (torch.from_numpy(k_np.view(np.uint16)).view(torch.bfloat16)
                   if dtype == "bfloat16" else _t(k_np))
        want = jck.chai_qk(_j(q), _j(k_np) if dtype != "bfloat16" else k_j,
                           _j(pos), ts=ts, interpret=True, **kw)
        got = _qk_body_order(_t(q), k_t, _t(pos), **kw)
    masked = _hold_scores(got, want, value_range=scale)
    assert masked.any() and not masked.all()


# -------------------------------------------------------- softmax --------
def test_row_softmax_ref_matches_pallas_with_masked_row(rng):
    """Scores from the Pallas QK kernel with one row whose pos is -1 (no
    live position): its softmax is all zeros, not NaN."""
    b, r, s, hd = 3, 4, 64, 16
    q = _normal(rng, (b, r, hd))
    k = _normal(rng, (b, r, s, hd)) * 3
    pos = np.array([-1, 17, 63], np.int32)
    sc = jck.chai_qk(_j(q), _j(k), _j(pos), ts=16, interpret=True)
    want = jck.row_softmax(sc, interpret=True)
    got = tref.row_softmax_ref(_t(sc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got[0], torch.zeros(r, s))
    assert np.all(np.asarray(want)[0] == 0)
    torch.testing.assert_close(got[1:].sum(-1), torch.ones(b - 1, r))


def _softmax_threads(cfg, rows, s):
    """The (row, element) pairs each launch of ``row_softmax.cu`` reads
    under plan ``cfg``, as its indexing gives them: [(row, elements) per
    (block, thread, chunk, load)] flattened into two int64 arrays, and
    each thread's (row, place g among the row's threads)."""
    threads = cfg.team * (1 if cfg.cluster > 1 else cfg.rows_per_block)
    bx, tid = np.divmod(np.arange(cfg.blocks * threads), threads)
    if cfg.cluster > 1:
        row, g = bx // cfg.cluster, (bx % cfg.cluster) * cfg.team + tid
    else:
        row, g = bx * cfg.rows_per_block + tid // cfg.team, tid % cfg.team
    tt = cfg.team * cfg.cluster
    loads = np.arange(cfg.chunks * cfg.vecs)
    vi = loads[None, :] * tt + g[:, None]             # (threads, loads)
    live = (row[:, None] < rows) & (vi < cfg.n_vec)
    elem = vi[..., None] * cfg.vw + np.arange(cfg.vw)
    r = np.broadcast_to(row[:, None, None], elem.shape)
    keep = np.broadcast_to(live[..., None], elem.shape)
    return r[keep], elem[keep], row, g


@pytest.mark.parametrize("rows,s", [
    (1, 3), (3, 16), (100, 1024), (160, 1024), (4, 77), (1000, 2048),
    (25, 8192), (400, 8192), (2, 16384), (25, 65536), (3, 65537),
    (2, 131072)])
def test_row_softmax_launch_config_covers_each_entry_once(rows, s):
    """``softmax_launch_config``: every (row, position) read by exactly
    one thread's load, none past the row; 16-byte loads only where S % 4
    == 0; teams of whole warps in one block of at most 256 threads; a
    cluster of at most 8 blocks (the portable size) whose blocks take one
    row; at most 8 loads a thread; one read (the row held in registers)
    up to S = 65,536 at 16-byte loads, two reads past it; the static
    shared memory within the block limit."""
    cfg = tck.softmax_launch_config(rows, s)
    r, e, row, g = _softmax_threads(cfg, rows, s)
    assert e.max() < s and r.max() < rows
    counts = np.bincount(r * s + e, minlength=rows * s)
    assert counts.min() == 1 and counts.max() == 1
    assert cfg.vw == (4 if s % 4 == 0 else 1)
    assert cfg.team % 32 == 0 and cfg.vecs in (1, 2, 4, 8)
    assert cfg.team * cfg.rows_per_block <= tck.SOFTMAX_THREADS
    assert 1 <= cfg.cluster <= tck.SOFTMAX_MAX_CLUSTER
    if cfg.cluster > 1:
        assert cfg.rows_per_block == 1 and cfg.blocks % cfg.cluster == 0
    capacity = (tck.SOFTMAX_MAX_CLUSTER * tck.SOFTMAX_THREADS
                * tck.SOFTMAX_MAX_VECS)     # loads a cluster holds
    assert (cfg.chunks == 1) == (cfg.n_vec <= capacity)
    assert cfg.smem_bytes <= tck._SMEM_LIMIT
    assert set(np.unique(row[row < rows])) == set(range(rows))


def _softmax_in_plan_order(x, cfg):
    """``row_softmax.cu``'s arithmetic in torch on the plan's threads:
    each thread's (m_t, l_t) over its loads (chunk by chunk, merged
    online), the warp's max and its rescaled sum, the team's warps and
    the cluster's blocks merged in order, then y = exp(x - m_t) exp(m_t -
    m) / l (one read) or exp(x - m) / l (two), the quotient as a
    reciprocal and one correction (exact in fp64 here)."""
    b, rr, s = x.shape
    rows = b * rr
    xf = x.reshape(rows, s)
    tt = cfg.team * cfg.cluster
    xp = torch.full((rows, cfg.chunks * cfg.vecs * tt * cfg.vw),
                    tref.NEG_INF)
    xp[:, :s] = xf
    # (row, thread g, load i, element) of load vi = i * tt + g
    vals = xp.reshape(rows, cfg.chunks * cfg.vecs, tt, cfg.vw).transpose(
        1, 2)                                   # (rows, tt, loads, vw)
    vals = vals.reshape(rows, tt, cfg.chunks, cfg.vecs * cfg.vw)

    def merge(m1, l1, m2, l2):
        m = torch.maximum(m1, m2)
        return m, l1 * torch.exp(m1 - m) + l2 * torch.exp(m2 - m)
    m_t = torch.full((rows, tt), -1e30)
    l_t = torch.zeros(rows, tt)
    for c in range(cfg.chunks):
        mc = torch.clamp(vals[:, :, c].amax(-1), min=-1e30)
        lc = torch.exp(vals[:, :, c] - mc[..., None]).sum(-1)
        m_t, l_t = merge(m_t, l_t, mc, lc)
    warps = m_t.reshape(rows, tt // 32, 32)
    mw = warps.amax(-1)
    lw = (l_t.reshape(rows, tt // 32, 32)
          * torch.exp(warps - mw[..., None])).sum(-1)
    m, l = mw[:, 0], lw[:, 0]
    for w in range(1, tt // 32):
        m, l = merge(m, l, mw[:, w], lw[:, w])
    l = torch.clamp(l, min=1e-37)
    if cfg.chunks == 1:
        p = torch.exp(vals[:, :, 0] - m_t[..., None]) * torch.exp(
            m_t - m[:, None])[..., None]
    else:
        p = torch.exp(vals - m[:, None, None, None])
    rcp = (1.0 / l.double()).float()
    q0 = p * rcp.reshape(rows, *([1] * (p.ndim - 1)))
    e = p.double() - l.double().reshape(rows, *([1] * (p.ndim - 1))) * \
        q0.double()
    y = (q0.double() + e * rcp.double().reshape(
        rows, *([1] * (p.ndim - 1)))).float()
    y = y.reshape(rows, tt, cfg.chunks * cfg.vecs, cfg.vw).transpose(1, 2)
    return y.reshape(rows, -1)[:, :s].reshape(b, rr, s)


@pytest.mark.parametrize("shape", [(4, 25, 1024), (1, 3, 8192),
                                   (1, 2, 65536), (1, 2, 131072),
                                   (2, 3, 77)])
def test_row_softmax_plan_order_matches_pallas(rng, shape):
    """The kernel's arithmetic in plan order (per-thread (m, l), pairs
    merged by warp, block and cluster rank; the quotient by a reciprocal
    and one correction) against the Pallas ``row_softmax`` in interpret
    mode at 2e-5, with row 1 masked everywhere (zeros) and row 0 masked
    past a third of S. The outputs are held scaled by S: the mean entry
    is 1 / S, below the tolerance at long S, so a wrong entry would pass
    unscaled."""
    b, r, s = shape
    sc = (_normal(rng, shape) * 2).astype(np.float32)
    sc[0, 0, s // 3:] = tref.NEG_INF
    sc[0, 1] = tref.NEG_INF
    want = np.asarray(jck.row_softmax(_j(sc), interpret=True))
    got = _softmax_in_plan_order(_t(sc), tck.softmax_launch_config(b * r, s))
    np.testing.assert_allclose(got.numpy() * s, want * s, **TOL)
    assert not got[0, 1].any()


@pytest.mark.parametrize("s,offset,copied", [(4096, 1, True),
                                             (4096, 4, False),
                                             (4095, 1, False)])
def test_row_softmax_input_alignment(s, offset, copied):
    """``row_softmax``'s input under its plan's loads: a contiguous view
    that starts off a 16-byte boundary is copied before the kernel's
    16-byte loads (vw 4) read it; an aligned view, or one that 4-byte
    loads read (vw 1, S % 4 != 0), is read in place."""
    base = torch.arange(s + 8, dtype=torch.float32)
    x = base[offset:offset + s].view(1, 1, s)
    cfg = tck.softmax_launch_config(1, s)
    got = tck._aligned(x, cfg.vw)
    assert (got.data_ptr() != x.data_ptr()) == copied
    assert got.data_ptr() % (cfg.vw * 4) == 0
    assert torch.equal(got, x)


# ------------------------------------------------------------- AV --------
@pytest.mark.parametrize("shared_h2c", [False, True],
                         ids=["h2c_BH", "h2c_H"])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_chai_av_ref_matches_pallas(rng, shared_h2c, dtype):
    b, h, r, s, hd, ts = 2, 8, 3, 32, 16, 8
    a = rng.random((b, r, s)).astype(np.float32)
    vj = _j(_normal(rng, (b, h, s, hd)))
    if dtype == "bfloat16":
        vj = vj.astype(jnp.bfloat16)
        vt = torch.from_numpy(np.array(vj).view(np.uint16)).view(
            torch.bfloat16)
    else:
        vt = _t(vj)
    h2c = rng.integers(0, r, size=(h,) if shared_h2c else (b, h))
    h2c = h2c.astype(np.int32)
    want = jck.chai_av(_j(a), vj, _j(h2c), ts=ts, interpret=True)
    got = tref.chai_av_ref(_t(a), vt, _t(h2c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shared_h2c", [False, True],
                         ids=["h2c_BH", "h2c_H"])
def test_paged_chai_av_ref_matches_pallas(rng, shared_h2c):
    """The AV sums over every position: A is given nonzero past pos too,
    so a pos cut in either version would show."""
    b, h, r, n_pages, page, hd = 2, 8, 3, 4, 8, 16
    n_pool = b * n_pages + 1
    a = rng.random((b, r, n_pages * page)).astype(np.float32)
    v_pool = _normal(rng, (n_pool, h, page, hd))
    bt_v = _tables(rng, b, n_pages, n_pool, [n_pages * page] * b, page)
    h2c = rng.integers(0, r, size=(h,) if shared_h2c else (b, h))
    h2c = h2c.astype(np.int32)
    want = jck.paged_chai_av(_j(a), _j(v_pool), _j(bt_v), _j(h2c),
                             interpret=True)
    got = tref.paged_chai_av_ref(_t(a), _t(v_pool), _t(bt_v), _t(h2c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _codes(rng, shape, kind):
    """int8 V codes to +-127: the share_values clustered V's scale-less
    codes (``plain_int8`` of values up to 160, saturated) or
    ``quant_rows`` codes of normal rows."""
    x = _t(_normal(rng, shape) * 60)
    if kind == "plain":
        return tcache.plain_int8(x).numpy()
    return tcache.quant_rows(x)[0].numpy()


@pytest.mark.parametrize("shared_h2c", [False, True],
                         ids=["h2c_BH", "h2c_H"])
@pytest.mark.parametrize("kind", ["plain", "quant"])
def test_chai_av_ref_matches_pallas_int8_codes(rng, kind, shared_h2c):
    """int8 V read as its values, with no scale (the Pallas body's cast),
    under softmax-normalized A rows; at 2e-5, the rtol term carrying the
    codes' range."""
    b, h, r, s, hd, ts = 2, 8, 3, 32, 16, 8
    a = np.asarray(tref.row_softmax_ref(_t(_normal(rng, (b, r, s)) * 2)))
    v = _codes(rng, (b, h, s, hd), kind)
    assert np.abs(v).max() >= 120
    h2c = rng.integers(0, r, size=(h,) if shared_h2c else (b, h))
    h2c = h2c.astype(np.int32)
    want = jck.chai_av(_j(a), _j(v), _j(h2c), ts=ts, interpret=True)
    got = tref.chai_av_ref(_t(a), _t(v), _t(h2c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shared_h2c", [False, True],
                         ids=["h2c_BH", "h2c_H"])
def test_paged_chai_av_ref_matches_pallas_int8_codes(rng, shared_h2c):
    """The paged AV over an int8 pool of raw codes, the null page 0 past
    pos in the tables and A nonzero there (no pos cut)."""
    b, h, r, n_pages, page, hd = 2, 8, 3, 4, 8, 16
    n_pool = b * n_pages + 1
    a = np.asarray(tref.row_softmax_ref(
        _t(_normal(rng, (b, r, n_pages * page)))))
    v_pool = _codes(rng, (n_pool, h, page, hd), "plain")
    bt_v = _tables(rng, b, n_pages, n_pool, [2 * page, n_pages * page - 1],
                   page)
    h2c = rng.integers(0, r, size=(h,) if shared_h2c else (b, h))
    h2c = h2c.astype(np.int32)
    want = jck.paged_chai_av(_j(a), _j(v_pool), _j(bt_v), _j(h2c),
                             interpret=True)
    got = tref.paged_chai_av_ref(_t(a), _t(v_pool), _t(bt_v), _t(h2c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ AV split plan ----
def _av_split_sum(a, v, h2c, ts, cfg):
    """The AV kernels' algorithm in torch: each split's partial row over
    its whole tiles of ts positions, the partials added in split order."""
    out = 0
    for t0, t1 in tck.split_ranges(a.shape[0], v.shape[1], v.shape[2] // ts):
        sl = slice(t0 * ts, t1 * ts)
        out = out + tref.chai_av_ref(a[:, :, sl], v[:, :, sl], h2c)
    assert len(tck.split_ranges(a.shape[0], v.shape[1],
                                v.shape[2] // ts)) == cfg.n_split
    return out


@pytest.mark.parametrize("b,h,n_tiles,hd,elem", [
    (4, 32, 64, 128, 2),           # phase 3 / layer 0: S 1024 at page 16
    (1, 32, 4096, 128, 2),         # S = 65,536
    (4, 32, 64, 128, 1),           # int8 codes
    (2, 8, 3, 16, 4),              # fewer tiles than one split's minimum
    (4, 600, 10, 80, 4),           # more units than the target: one split
])
def test_av_launch_config_covers_tiles_once_in_order(b, h, n_tiles, hd,
                                                     elem):
    """Tiles [0, n_tiles) once and in order; the dense call (S / ts
    tiles) and the paged call (the pages) at equal shapes get one plan;
    the scratch is what ``av_scratch`` allocates (on ``meta``)."""
    cfg = tck.av_launch_config(b, h, n_tiles, hd, elem)
    s = n_tiles * 16                       # dense: S / ts at ts == page
    assert cfg == tck.av_launch_config(
        b, h, s // tck.fused_tile_size(16, s), hd, elem)
    ranges = tck.split_ranges(b, h, n_tiles)
    assert len(ranges) == cfg.n_split
    covered = [t for t0, t1 in ranges for t in range(t0, t1)]
    assert covered == list(range(n_tiles))
    assert all(t1 - t0 == cfg.tiles_per_split for t0, t1 in ranges[:-1])
    assert cfg.vec * elem == 16
    scratch, counter = tck.av_scratch(cfg, b * h, torch.device("meta"), -1)
    if cfg.n_split == 1:
        assert scratch is None and counter is None and not cfg.scratch_floats
    else:
        assert (scratch.numel() == cfg.scratch_floats
                == b * h * cfg.n_split * hd)
        assert counter.numel() >= b * h
    if (b, h, n_tiles) == (4, 32, 64):
        assert b * h * cfg.n_split >= 4 * 132


@pytest.mark.parametrize("hd,elem,vec", [
    (128, 4, 4), (80, 2, 8), (224, 1, 16), (18, 4, 2), (18, 1, 2),
    (12, 1, 4), (20, 2, 4), (1100, 4, 4)])
def test_av_launch_config_load_width(hd, elem, vec):
    """The widest load of 16, 8, 4 or 2 bytes whose element count divides
    the row, at least two elements."""
    assert tck.av_launch_config(2, 4, 8, hd, elem).vec == vec


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_av_split_algorithm_matches_pallas(rng, dtype):
    """The kernels' split-and-merge over ``av_launch_config``'s plan,
    in torch, against the Pallas ``chai_av`` (interpret mode) at 2e-5."""
    b, h, r, s, hd, ts = 1, 4, 2, 256, 16, 8
    cfg = tck.av_launch_config(b, h, s // ts, hd, 1 if dtype == "int8" else 4)
    assert cfg.n_split > 1
    a = np.asarray(tref.row_softmax_ref(_t(_normal(rng, (b, r, s)))))
    v = (_codes(rng, (b, h, s, hd), "plain") if dtype == "int8"
         else _normal(rng, (b, h, s, hd)))
    h2c = rng.integers(0, r, size=(b, h)).astype(np.int32)
    want = jck.chai_av(_j(a), _j(v), _j(h2c), ts=ts, interpret=True)
    got = _av_split_sum(_t(a), _t(v), _t(h2c), ts, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------- drivers -------
def _dense_case(rng, *, mode, int8, b=2, s=64, hd=16):
    """One decode problem per mode (MHA, MHA + share_values, GQA), the
    reference's ``_fused_case`` shapes; int8 K (and V unless
    share_values) from the port's ``quant_rows``."""
    if mode == "gqa":
        kv, rpg, qpk = 2, 3, 4
        h = kv * qpk
        h2c = _gqa_h2c(rng, b, kv, rpg, qpk)
        v_rows = kv
    else:
        kv, rpg, h = 3, 1, 8
        h2c = rng.integers(0, kv, size=(b, h)).astype(np.int32)
        v_rows = kv if mode == "mha_share" else h
    q = _normal(rng, (b, kv * rpg, hd))
    k = _normal(rng, (b, kv, s, hd))
    v = _normal(rng, (b, v_rows, s, hd))
    pos = rng.integers(1, s, size=b).astype(np.int32)
    pos[0] = s - 1
    kw = dict(reps_per_group=rpg, share_values=mode == "mha_share")
    scales = {}
    if int8:
        kq, ks = tcache.quant_rows(_t(k))
        k, scales["k_scale"] = kq.numpy(), ks.numpy()
        if mode != "mha_share":
            vq, vs = tcache.quant_rows(_t(v))
            v, scales["v_scale"] = vq.numpy(), vs.numpy()
    return (q, k, v, h2c, pos), kw, scales


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("mode", ["mha", "mha_share", "gqa"])
def test_three_kernel_decode_matches_reference(rng, mode, int8, window):
    args, kw, scales = _dense_case(rng, mode=mode, int8=int8)
    want = jref.chai_three_kernel_decode(
        *map(_j, args), ts=16, window=window,
        **{k: _j(v) for k, v in scales.items()}, **kw)
    got = tops.chai_three_kernel_decode(
        *map(_t, args), ts=16, window=window,
        **{k: _t(v) for k, v in scales.items()}, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["mha", "mha_share", "gqa"])
def test_paged_three_kernel_decode_matches_reference(rng, mode):
    b, n_pages, page, hd = 2, 4, 16, 16
    if mode == "gqa":
        kv, rpg, qpk = 2, 3, 4
        h = kv * qpk
        h2c = _gqa_h2c(rng, b, kv, rpg, qpk)
        v_rows = kv
    else:
        kv, rpg, h = 3, 1, 8
        h2c = rng.integers(0, kv, size=(b, h)).astype(np.int32)
        v_rows = kv if mode == "mha_share" else h
    n_pool = b * n_pages + 2
    pos = rng.integers(1, n_pages * page, size=b).astype(np.int32)
    pos[0] = n_pages * page - 1
    args = (_normal(rng, (b, kv * rpg, hd)),
            _normal(rng, (n_pool, kv, page, hd)),
            _tables(rng, b, n_pages, n_pool, pos, page),
            _normal(rng, (n_pool, v_rows, page, hd)),
            _tables(rng, b, n_pages, n_pool, [n_pages * page] * b, page),
            h2c, pos)
    kw = dict(reps_per_group=rpg, share_values=mode == "mha_share")
    want = jref.paged_chai_three_kernel_decode(*map(_j, args), **kw)
    got = tops.paged_chai_three_kernel_decode(*map(_t, args), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_three_kernel_decode_matches_fused_plain(rng):
    """Inside the port: the pipeline and the fused decode's plain version
    compute one function (two summation orders)."""
    args, kw, _ = _dense_case(rng, mode="gqa", int8=False)
    args = tuple(map(_t, args))
    pipe = tops.chai_three_kernel_decode(*args, ts=16, **kw)
    fused = tops.chai_decode_attention(*args, ts=16, **kw)
    torch.testing.assert_close(pipe, fused, **TOL)


# -------------------------------------------------- lane estimators ------
@pytest.mark.parametrize("kw", [
    dict(), dict(share_values=True), dict(window=100),
    dict(cache_bytes=2), dict(fused=False),
    dict(fused=False, share_values=True, window=64, cache_bytes=1)])
def test_lane_estimators_equal_reference(kw):
    shape = (4, 48, 40, 1024, 128)
    assert (tops.decode_hbm_bytes_estimate(*shape, **kw)
            == jops.decode_hbm_bytes_estimate(*shape, **kw))
    fkw = {k: v for k, v in kw.items() if k in ("share_values", "window")}
    assert (tops.decode_flop_estimate(*shape, **fkw)
            == jops.decode_flop_estimate(*shape, **fkw))
    for fused in (True, False):
        assert (tops.decode_launch_count(fused=fused)
                == jops.decode_launch_count(fused=fused))
    assert tops.decode_launch_count(fused=False) == 3


def test_quant_rows_bit_equal_to_reference(rng):
    x = _normal(rng, (2, 3, 17, 16)) * 4
    x[0, 0, 0] = 0.0                               # scale floor 1e-6
    x[1, 2, 3, 5] = 1e4
    qj, sj = jcache.quant_rows(_j(x))
    qt, st = tcache.quant_rows(_t(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    dj = jcache.dequant_rows(qj, sj)
    assert np.array_equal(tcache.dequant_rows(qt, st).numpy(),
                          np.asarray(dj))


# --------------------------------------------------- wrapper checks ------
def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """On a CPU tensor each kernel wrapper raises (``kernels.ops`` takes
    the plain versions there); nothing falls back."""
    q = torch.zeros(1, 2, 8)
    k = torch.zeros(1, 2, 16, 8)
    pos = torch.zeros(1, dtype=torch.int32)
    a = torch.zeros(1, 2, 16)
    h2c = torch.zeros(1, 2, dtype=torch.int32)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    pool = torch.zeros(3, 2, 8, 8)
    calls = [
        lambda: tck.chai_qk(q, k, pos, ts=8),
        lambda: tck.chai_qk_i8(q, k.to(torch.int8), torch.ones(1, 2, 16),
                               pos, ts=8),
        lambda: tck.paged_chai_qk(q, pool, bt, pos),
        lambda: tck.chai_qk(q, k.to(torch.int8), pos, ts=8),
        lambda: tck.paged_chai_qk(q, pool.to(torch.int8), bt, pos),
        lambda: tck.row_softmax(a),
        lambda: tck.chai_av(a, k, h2c, ts=8),
        lambda: tck.paged_chai_av(a, pool, bt, h2c),
        lambda: tck.chai_av(a, k.to(torch.int8), h2c, ts=8),
        lambda: tck.paged_chai_av(a, pool.to(torch.int8), bt, h2c)]
    before = dict(tck.LAUNCHES)
    for call in calls:
        with pytest.raises(ValueError, match="CUDA kernel"):
            call()
    assert tck.LAUNCHES == before


def test_wrappers_keep_the_pallas_shape_assertions():
    """``ts`` must divide S (chai_qk, chai_qk_i8, chai_av), and A must
    span P * page positions (paged_chai_av), checked before any launch."""
    q = torch.zeros(1, 2, 8)
    k = torch.zeros(1, 2, 24, 8)
    pos = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of ts"):
        tck.chai_qk(q, k, pos, ts=16)
    with pytest.raises(ValueError, match="multiple of ts"):
        tck.chai_qk_i8(q, k.to(torch.int8), torch.ones(1, 2, 24), pos,
                       ts=16)
    with pytest.raises(ValueError, match="multiple of ts"):
        tck.chai_av(torch.zeros(1, 2, 24), k, torch.zeros(1, 2), ts=16)
    with pytest.raises(ValueError, match="pages of 8"):
        tck.paged_chai_av(torch.zeros(1, 2, 24), torch.zeros(3, 2, 8, 8),
                          torch.zeros(1, 2, dtype=torch.int32),
                          torch.zeros(1, 2, dtype=torch.int32))
