"""The fused decode kernels' split-S design against the JAX package, on
the CPU.

The CUDA kernels (``csrc/chai_decode_tiles.cuh``) cut the S axis into the
ranges of ``kernels.chai_attention.split_plan``, compute each range's
online-softmax state and merge the states in split order inside the
launch. Here:

* the plan: its ranges are whole tiles, in order, covering every tile
  once; it is the same for the dense and the paged call at equal shapes
  (``dense_launch_config`` / ``paged_launch_config``, the helpers both
  wrappers call); a block's shared memory does not grow with S and stays
  under the block limit;
* the algorithm: per-split states from the port's plain pieces (each
  split's positions only), merged in split order with
  ``ops.merge_decode_states`` and finalized with
  ``ops.finalize_decode_state``, held against the reference's Pallas
  ``chai_fused_decode`` / ``paged_chai_fused_decode`` (interpret mode) at
  atol = rtol = 1e-5 (fp32: tile and split order round differently in the
  last bits), and the merged state against the Pallas ``emit_state``
  output at 1e-5 (its m exactly the largest of the splits' m; the Pallas
  m rounds its own dot, one ulp apart here).

The kernels themselves are held against the plain versions on the card
by ``chip_smoke.py`` (phase 3).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import chai_attention as jck
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 8
BLOCK_SMEM_LIMIT = 232448      # bytes of shared memory a Hopper block may use


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


# ------------------------------------------------------------- the plan ---
@pytest.mark.parametrize("b,k_rows,n_tiles", [
    (4, 25, 64), (4, 8, 64), (1, 25, 4096), (1, 8, 65536), (2, 5, 18),
    (3, 3, 7), (1, 1, 1), (64, 25, 2)])
def test_split_ranges_are_whole_tiles_in_order_covering_every_tile(
        b, k_rows, n_tiles):
    ranges = tck.split_ranges(b, k_rows, n_tiles)
    n_split, per = tck.split_plan(b, k_rows, n_tiles)
    assert 1 <= n_split == len(ranges) <= 64
    assert ranges[0][0] == 0 and ranges[-1][1] == n_tiles
    for (t0, t1), (u0, _) in zip(ranges, ranges[1:]):
        assert t1 == u0
    assert all(t1 - t0 == per for t0, t1 in ranges[:-1])
    assert all(0 < t1 - t0 <= per for t0, t1 in ranges)
    if n_tiles >= tck.SPLIT_MIN_TILES:
        assert per >= tck.SPLIT_MIN_TILES


@pytest.mark.parametrize("b,r,h,kv_v,rpg,n_pages", [
    (4, 25, 32, 32, 1, 64), (4, 40, 48, 8, 5, 64), (1, 25, 32, 32, 1, 4096),
    (2, 5, 8, 8, 1, 18)])
def test_split_plan_is_the_same_for_dense_and_paged(b, r, h, kv_v, rpg,
                                                    n_pages):
    page, hd = 16, 128
    meta = dict(device="meta")
    q = torch.empty(b, r, hd, **meta)
    h2c = torch.empty(b, h, dtype=torch.int32, **meta)
    k = torch.empty(b, r // rpg, n_pages * page, hd, **meta)
    k_pool = torch.empty(b * n_pages + 1, r // rpg, page, hd, **meta)
    bt = torch.empty(b, n_pages, dtype=torch.int32, **meta)
    dense, ts = tck.dense_launch_config(q, k, h2c, reps_per_group=rpg,
                                        ts=page)
    paged = tck.paged_launch_config(q, k_pool, bt, h2c,
                                    reps_per_group=rpg)
    assert ts == page
    assert dense == paged
    assert dense.n_split * dense.tiles_per_split >= n_pages


@pytest.mark.parametrize("h,kv_k,rpg", [(32, 25, 1), (48, 8, 5)])
def test_block_shared_memory_does_not_grow_with_s(h, kv_k, rpg):
    hd, page = 128, 16
    meta = dict(device="meta")
    q = torch.empty(4, kv_k * rpg, hd, **meta)
    h2c = torch.empty(4, h, dtype=torch.int32, **meta)
    sizes = []
    for s in (1024, 1048576):
        k = torch.empty(4, kv_k, s, hd, dtype=torch.bfloat16, **meta)
        cfg, _ = tck.dense_launch_config(q, k, h2c, reps_per_group=rpg,
                                         ts=page)
        bt = torch.empty(4, s // page, dtype=torch.int32, **meta)
        pcfg = tck.paged_launch_config(q, k[0], bt, h2c, reps_per_group=rpg)
        sizes += [cfg.smem_bytes, pcfg.smem_bytes]
    assert len(set(sizes)) == 1
    assert sizes[0] < BLOCK_SMEM_LIMIT


# -------------------------------------------------------- the algorithm ---
def _inputs(rng, *, b=2, r=5, h=8, kv_v=None, rpg=1, n_tiles=18, hd=16,
            pos=(70, 141), empty_rep=True):
    """q (B, R, hd); K (B, R / rpg, S, hd); V (B, kv_v, S, hd); h2c with
    one memberless rep (MHA) or heads picking reps of their own group
    (GQA); S = n_tiles * PAGE."""
    kv_k = r // rpg
    kv_v = kv_v or h
    s = n_tiles * PAGE
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv_k, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv_v, s, hd)).astype(np.float32)
    if rpg == 1:
        reps = [j for j in range(r) if not (empty_rep and j == 1)]
        h2c = rng.choice(reps, size=(b, h))
    else:
        grp = np.arange(h) // (h // kv_k)
        h2c = grp[None] * rpg + rng.integers(0, rpg, size=(b, h))
    return q, k, v, h2c.astype(np.int32), np.asarray(pos, np.int32)


def _pages(rng, x, null_past=None):
    """x (B, rows, S, hd) -> (pool, bt) on shuffled pool pages; with
    ``null_past`` (B,) every table entry of a page wholly past that
    position names the null page 0, whose rows are garbage."""
    b, rows, s, hd = x.shape
    n = s // PAGE
    pool = rng.normal(size=(b * n + 3, rows, PAGE, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, b * n + 3))[:b * n].reshape(b, n)
    for i in range(b):
        for t in range(n):
            pool[bt[i, t]] = x[i, :, t * PAGE:(t + 1) * PAGE]
            if null_past is not None and t * PAGE > null_past[i]:
                bt[i, t] = 0
    return pool, bt.astype(np.int32)


def _split_state(q, k, v, h2c, pos, *, rpg, window, ranges):
    """The kernel's algorithm from the port's plain pieces: each split's
    state over its own positions (pos shifted to the split's start), the
    states merged in split order. Returns (the merged state, the splits'
    states)."""
    states = [tref.chai_fused_decode_ref(
        q, k[:, :, t0 * PAGE:t1 * PAGE], v[:, :, t0 * PAGE:t1 * PAGE], h2c,
        pos - t0 * PAGE, reps_per_group=rpg, window=window, emit_state=True)
        for t0, t1 in ranges]
    state = states[0]
    for st in states[1:]:
        state = tops.merge_decode_states(state, st, h2c)
    return state, states


CASES = {
    "mha_one_empty_rep": dict(),
    "gqa_rpg2": dict(inp=dict(r=4, h=8, kv_v=2, rpg=2)),
    "pos_in_first_split_only": dict(inp=dict(pos=(3, 30))),
    "row_at_pos_0": dict(inp=dict(pos=(0, 97))),
    "partial_last_split": dict(inp=dict(n_tiles=18, pos=(143, 143))),
    "window": dict(inp=dict(pos=(90, 143)), window=37),
    "shuffled_pages_null_past_pos": dict(inp=dict(pos=(45, 101)),
                                         paged=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_split_merge_matches_reference_kernel(name):
    case = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    inp = dict(case.get("inp", {}))
    rpg = inp.get("rpg", 1)
    window = case.get("window", 0)
    q, k, v, h2c, pos = _inputs(rng, **inp)
    b, kv_k, s, _ = k.shape
    ranges = tck.split_ranges(b, kv_k, s // PAGE)
    assert len(ranges) > 1
    if case.get("paged"):
        k_pool, bt_k = _pages(rng, k, null_past=pos)
        v_pool, bt_v = _pages(rng, v, null_past=pos)
        assert (bt_k == 0).any() and (bt_v == 0).any()
        jargs = (k_pool, bt_k, v_pool, bt_v)
        k = tref.gather_pages_ref(_t(k_pool), _t(bt_k)).numpy()
        v = tref.gather_pages_ref(_t(v_pool), _t(bt_v)).numpy()

        def pallas(**kw):
            return jck.paged_chai_fused_decode(
                _j(q), *(_j(a) for a in jargs), _j(h2c), _j(pos),
                reps_per_group=rpg, window=window, **kw)
    else:
        def pallas(**kw):
            return jck.chai_fused_decode(
                _j(q), _j(k), _j(v), _j(h2c), _j(pos), reps_per_group=rpg,
                window=window, ts=PAGE, **kw)
    state, split_states = _split_state(_t(q), _t(k), _t(v), _t(h2c),
                                       _t(pos), rpg=rpg, window=window,
                                       ranges=ranges)
    out = tops.finalize_decode_state(state, _t(h2c))
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas()), **TOL)
    # The merged m is exactly the largest of the splits' m; the Pallas m
    # comes from its own dot, whose sum rounds differently in the last
    # bit (as does torch's at another S), so it is held at TOL.
    assert torch.equal(state[0], torch.stack(
        [st[0] for st in split_states]).amax(0))
    for got, want in zip(state, pallas(emit_state=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
