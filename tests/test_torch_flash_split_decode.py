"""The flash decode pair's split-S design against the JAX package, on the
CPU.

The CUDA kernels (``csrc/decode_tiles.cuh``) cut the S axis into the
ranges of ``kernels.flash_attention.flash_decode_launch_config`` (the
fused CHAI decode's ``split_plan`` over the units (batch row, KV group,
head slice)), compute each range's online-softmax state and merge the
states in split order inside the launch. Here:

* the plan: its ranges are whole tiles, in order, covering every tile
  once; it is the same for the dense and the paged call at equal shapes
  (``dense_decode_config`` / ``paged_decode_config``, the helpers both
  wrappers call); a block's shared memory does not grow with S and stays
  under the 48 KB of static shared memory a block may take;
* the algorithm: per-split states from the port's plain pieces
  (``ref.flash_decode_state_ref`` over each split's positions), merged in
  split order with ``ops.merge_prefill_states`` and finalized, held
  against the reference's Pallas ``flash_decode`` / ``paged_decode``
  (interpret mode) at atol = rtol = 1e-5 (fp32: tile and split order
  round differently in the last bits) on MHA, GQA 4:1, MQA, a window, a
  row at pos 0, a partial last split, and shuffled pages with the null
  page past pos.

The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` (phase 3).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as jfk
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 8
STATIC_SMEM_LIMIT = 48 * 1024   # bytes of static shared memory a block


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _ranges(cfg, n_tiles):
    per = cfg.tiles_per_split
    return [(s * per, min(n_tiles, (s + 1) * per))
            for s in range(cfg.n_split)]


# ------------------------------------------------------------- the plan ---
@pytest.mark.parametrize("b,h,kv,n_tiles", [
    (4, 32, 32, 64), (4, 48, 8, 64), (1, 32, 32, 4096), (1, 48, 8, 65536),
    (2, 8, 2, 18), (3, 6, 1, 7), (1, 4, 4, 1), (64, 32, 32, 2)])
def test_split_ranges_are_whole_tiles_in_order_covering_every_tile(
        b, h, kv, n_tiles):
    cfg = tfk.flash_decode_launch_config(b, h, kv, n_tiles)
    ranges = _ranges(cfg, n_tiles)
    assert 1 <= cfg.n_split == len(ranges) <= 64
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    for (t0, t1), (u0, _) in zip(ranges, ranges[1:]):
        assert t1 == u0
    assert all(0 < t1 - t0 <= cfg.tiles_per_split for t0, t1 in ranges)
    if n_tiles >= tck.SPLIT_MIN_TILES:
        assert cfg.tiles_per_split >= tck.SPLIT_MIN_TILES
    # the fused CHAI decode's plan over (b, group, head slice) units
    slices = -(-(h // kv) // cfg.heads_per_block)
    assert (cfg.n_split, cfg.tiles_per_split) == tck.split_plan(
        b, kv * slices, n_tiles)


@pytest.mark.parametrize("b,h,kv,n_pages", [
    (4, 32, 32, 64), (4, 48, 8, 64), (1, 32, 32, 4096), (2, 8, 2, 18)])
def test_split_plan_is_the_same_for_dense_and_paged(b, h, kv, n_pages):
    hd, meta = 128, dict(device="meta")
    q = torch.empty(b, h, hd, **meta)
    k = torch.empty(b, kv, n_pages * PAGE, hd, **meta)
    pool = torch.empty(b * n_pages + 1, kv, PAGE, hd, **meta)
    bt = torch.empty(b, n_pages, dtype=torch.int32, **meta)
    dense, ts = tfk.dense_decode_config(q, k, ts=PAGE)
    paged = tfk.paged_decode_config(q, pool, bt)
    assert ts == PAGE
    assert dense == paged
    assert dense.n_split * dense.tiles_per_split >= n_pages


@pytest.mark.parametrize("h,kv", [(32, 32), (48, 8), (8, 1)])
def test_block_shared_memory_does_not_grow_with_s(h, kv):
    meta = dict(device="meta")
    q = torch.empty(4, h, 128, **meta)
    sizes = []
    for s in (1024, 1048576):
        k = torch.empty(4, kv, s, 128, dtype=torch.bfloat16, **meta)
        pool = torch.empty(4 * s // PAGE + 1, kv, PAGE, 128,
                           dtype=torch.bfloat16, **meta)
        bt = torch.empty(4, s // PAGE, dtype=torch.int32, **meta)
        sizes += [tfk.dense_decode_config(q, k, ts=PAGE)[0].smem_bytes,
                  tfk.paged_decode_config(q, pool, bt).smem_bytes]
    assert len(set(sizes)) == 1
    assert sizes[0] <= STATIC_SMEM_LIMIT


# -------------------------------------------------------- the algorithm ---
def _inputs(rng, *, b=2, h=8, kv=8, n_tiles=18, hd=16, pos=(70, 141)):
    s = n_tiles * PAGE
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, hd)).astype(np.float32)
    return q, k, v, np.asarray(pos, np.int32)


def _pages(rng, k, v, null_past):
    """k, v (B, KV, S, hd) -> (pool, bt_k, bt_v): both on shuffled pages
    of one pool; every table entry of a page wholly past ``null_past``
    (B,) names the null page 0, whose rows are garbage."""
    b, kv, s, hd = k.shape
    n = s // PAGE
    pool = rng.normal(size=(2 * b * n + 3, kv, PAGE, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, 2 * b * n + 3))[:2 * b * n]
    bt_k, bt_v = ids[:b * n].reshape(b, n), ids[b * n:].reshape(b, n)
    for i in range(b):
        for t in range(n):
            pool[bt_k[i, t]] = k[i, :, t * PAGE:(t + 1) * PAGE]
            pool[bt_v[i, t]] = v[i, :, t * PAGE:(t + 1) * PAGE]
            if t * PAGE > null_past[i]:
                bt_k[i, t] = bt_v[i, t] = 0
    return pool, bt_k.astype(np.int32), bt_v.astype(np.int32)


def _split_state(q, k, v, pos, *, window, ranges):
    """The kernels' algorithm from the port's plain pieces: each split's
    state over its own positions (pos shifted to the split's start), the
    states merged in split order. Returns (the merged state, the splits'
    states)."""
    states = [tref.flash_decode_state_ref(
        q, k[:, :, t0 * PAGE:t1 * PAGE], v[:, :, t0 * PAGE:t1 * PAGE],
        pos - t0 * PAGE, window=window) for t0, t1 in ranges]
    state = states[0]
    for st in states[1:]:
        state = tops.merge_prefill_states(state, st)
    return state, states


CASES = {
    "mha": dict(),
    "gqa4": dict(inp=dict(h=8, kv=2)),
    "mqa": dict(inp=dict(h=6, kv=1)),
    "window": dict(inp=dict(pos=(90, 143)), window=37),
    "row_at_pos_0": dict(inp=dict(pos=(0, 97))),
    "partial_last_split": dict(inp=dict(n_tiles=18, pos=(143, 143))),
    "shuffled_pages_null_past_pos": dict(inp=dict(h=8, kv=2, pos=(45, 101)),
                                         paged=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_split_merge_matches_reference_kernel(name):
    case = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    window = case.get("window", 0)
    q, k, v, pos = _inputs(rng, **case.get("inp", {}))
    b, h = q.shape[:2]
    kv, s = k.shape[1], k.shape[2]
    cfg = tfk.flash_decode_launch_config(b, h, kv, s // PAGE)
    ranges = _ranges(cfg, s // PAGE)
    assert len(ranges) > 1
    if name == "partial_last_split":
        assert ranges[-1][1] - ranges[-1][0] < cfg.tiles_per_split
    if case.get("paged"):
        pool, bt_k, bt_v = _pages(rng, k, v, pos)
        assert (bt_k == 0).any() and (bt_v == 0).any()
        want = jfk.paged_decode(_j(q), _j(pool), _j(bt_k), _j(bt_v),
                                _j(pos), window=window, interpret=True)
        k = tref.gather_pages_ref(_t(pool), _t(bt_k)).numpy()
        v = tref.gather_pages_ref(_t(pool), _t(bt_v)).numpy()
    else:
        want = jfk.flash_decode(_j(q), _j(k), _j(v), _j(pos), window=window,
                                ts=PAGE, interpret=True)
    state, split_states = _split_state(_t(q), _t(k), _t(v), _t(pos),
                                       window=window, ranges=ranges)
    m, l, acc = state
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    # the merged m is exactly the largest of the splits' m, and the merge
    # of the splits equals the one-shot plain version at TOL
    assert torch.equal(m, torch.stack([st[0] for st in split_states])
                       .amax(0))
    whole = tref.flash_decode_ref(_t(q), _t(k), _t(v), _t(pos),
                                  window=window)
    np.testing.assert_allclose(out.numpy(), whole.numpy(), **TOL)
