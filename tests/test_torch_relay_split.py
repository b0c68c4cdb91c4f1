"""The relay kernel's split-S, two-kind-of-block design against the JAX
package, on the CPU.

The CUDA kernel (``csrc/relay_prefix_decode.cu``) cuts each group's
prefix into the ranges of ``kernels.chai_attention.split_plan`` over the
group's K rows. In each range, score blocks (a slice of at most 8 query
rows of one K row) stream their K row once and keep each query's scores,
max and sum; sum blocks (a slice of at most 8 acc rows of one V row)
stream their V row once, weighting each position by its query's
exp(score - max). The splits merge in split order. Here:

* the algorithm: per-split states from the port's plain version on each
  split's positions (K/V sliced, plen clamped to the split), merged in
  split order with ``ops.merge_decode_states``'s algebra (``a_row`` as
  the acc row -> query row map), held against the reference's Pallas
  ``relay_prefix_decode`` (interpret mode) at atol = rtol = 1e-5: MHA maps
  with a padded member, plen inside a split, a split wholly past plen (the
  merge identity, exactly) and GQA maps with more than 8 query rows on
  one K row. The same splits are also computed through the kernel's
  routing (``relay_units``), unit by unit, and held alike;
* the routing: every query row in exactly one score unit and every acc
  row in exactly one sum unit, its V row and its query unchanged; no
  slice above 8; the slices of a row of near-equal size, in map order;
  the slots ``relay_launch_config`` gives are enough;
* ``ops.relay_prefix_hbm_bytes_estimate``, the bound's byte count, against
  the reference's estimator.

The plan's whole tiles and the fixed shared memory are cases of the
parametrised tests in ``tests/test_torch_split_decode.py``. The kernel
itself is held against the plain version on the card by
``chip_smoke.py`` (phase 3 and phases 8-9).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import chai_attention as jck
from repro.kernels import ops as jops
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)
PAGE = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _maps(rng, members, nmax, *, gqa, n_kv=2, r_g=5, qpk=3, h=8, r=5):
    """Routing maps as the engine builds them (``serving.engine.
    _relay_row_maps``) for groups of ``members`` real slots of ``nmax``;
    padded entries stay 0. MHA: R reps of H heads, K and V rows per head
    (query row j*R + i reads K row reps[i]; head h reads query row j*R +
    h2c[h], one rep without a head, and V row h). GQA: n_kv groups of r_g
    reps and qpk heads (query row j*R + c*r_g + i reads K row c, so a full
    group puts nmax * r_g query rows on each K row; head h of group c reads
    its cluster's query row and V row c). Returns (k_row, a_row, v_row,
    K rows, V rows, R)."""
    if gqa:
        r, h, kv, vr = n_kv * r_g, n_kv * qpk, n_kv, n_kv
    else:
        kv = vr = h
    g = len(members)
    k_row = np.zeros((g, nmax * r), np.int32)
    a_row = np.zeros((g, nmax * h), np.int32)
    v_row = np.zeros((g, nmax * h), np.int32)
    for i, n in enumerate(members):
        for j in range(n):
            if gqa:
                grp = np.arange(h) // qpk
                k_row[i, j * r:(j + 1) * r] = np.repeat(np.arange(n_kv), r_g)
                a_row[i, j * h:(j + 1) * h] = (j * r + grp * r_g
                                               + rng.integers(0, r_g, h))
                v_row[i, j * h:(j + 1) * h] = grp
            else:
                k_row[i, j * r:(j + 1) * r] = rng.permutation(h)[:r]
                a_row[i, j * h:(j + 1) * h] = j * r + rng.integers(0, r - 1,
                                                                   h)
                v_row[i, j * h:(j + 1) * h] = np.arange(h)
    return k_row, a_row, v_row, kv, vr, r


def _inputs(rng, *, members=(3, 2), nmax=3, gqa=False, sp=128, hd=16,
            plen=(70, 20), **kw):
    """q, K, V (tail past plen zero, as the engine's views), the maps and
    plen."""
    k_row, a_row, v_row, kv, vr, r = _maps(rng, members, nmax, gqa=gqa,
                                           **kw)
    g = len(members)
    q = rng.normal(size=(g, nmax * r, hd)).astype(np.float32)
    k = rng.normal(size=(g, kv, sp, hd)).astype(np.float32)
    v = rng.normal(size=(g, vr, sp, hd)).astype(np.float32)
    for i, n in enumerate(plen):
        k[i, :, n:] = 0
        v[i, :, n:] = 0
    return q, k, v, k_row, a_row, v_row, np.asarray(plen, np.int32)


def _split_states(q, k, v, k_row, a_row, v_row, plen):
    """Each split's state from the plain version on the split's positions
    only (plen clamped to it). Returns [(p0, p1, state)]."""
    g, kv, sp, _ = k.shape
    out = []
    for t0, t1 in tck.split_ranges(g, kv, sp // PAGE):
        p0, p1 = t0 * PAGE, t1 * PAGE
        out.append((p0, p1, tref.relay_prefix_decode_ref(
            q, k[:, :, p0:p1], v[:, :, p0:p1], k_row, a_row, v_row,
            torch.clamp(plen - p0, 0, p1 - p0))))
    return out


def _merged(states, a_row):
    state = states[0]
    for st in states[1:]:
        state = tops.merge_decode_states(state, st, a_row)
    return state


def _routed_split(q, k, v, k_row, a_row, v_row, plen, p0, p1):
    """One split's state computed as the kernel routes it
    (``relay_units``): each score unit's queries dotted with its K row,
    each query's max and sum over the split; each sum unit's acc rows
    weighting its V row by exp(score - max) of their queries."""
    g, nr, hd = q.shape
    m = torch.full((g, nr), -1e30)      # an empty split, clamped
    l = torch.zeros((g, nr))
    acc = torch.zeros((g, a_row.shape[1], hd))
    for i, unit in enumerate(tck.relay_units(k_row, a_row, v_row)):
        hi = min(p1, int(plen[i]))
        if hi <= p0:
            continue
        sc = {}
        for su in unit["scores"]:
            rows = torch.tensor(su["queries"])
            s = q[i, rows] @ k[i, su["kv"], p0:hi].T / np.sqrt(hd)
            for j, row in enumerate(su["queries"]):
                sc[row] = s[j]
                m[i, row] = torch.clamp(s[j].max(), min=-1e30)
                l[i, row] = torch.exp(s[j] - m[i, row]).sum()
        for vu in unit["sums"]:
            for a, row in vu["members"]:
                acc[i, a] = torch.exp(sc[row] - m[i, row]) @ v[i, vu["vr"],
                                                               p0:hi]
    return m, l, acc


CASES = {
    "mha_padded_member": dict(),
    "plen_inside_a_split": dict(plen=(45, 128)),
    "split_past_plen": dict(plen=(70, 0, 128), members=(3, 2, 1)),
    "gqa_over_8_per_k_row": dict(gqa=True, members=(3, 2), plen=(90, 33)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_split_merge_matches_reference_kernel(name):
    kw = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 40)
    args = _inputs(rng, **kw)
    q, k, v, k_row, a_row, v_row, plen = (_t(a) for a in args)
    if kw.get("gqa"):
        # more than 8 query rows on one K row (3 slots x 5 reps, and the
        # padded slot's 10 rows on K row 0 in group 1)
        assert max(np.bincount(r).max() for r in args[3]) > 8
    states = _split_states(q, k, v, k_row, a_row, v_row, plen)
    assert len(states) > 1
    state = _merged([st for _, _, st in states], a_row)
    want = jck.relay_prefix_decode(*(_j(a) for a in args), ts=PAGE)
    for got, w in zip(state, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    # the kernel's routing gives the same splits
    for p0, p1, st in states:
        routed = _routed_split(q, k, v, k_row, a_row, v_row, plen, p0, p1)
        for got, w in zip(routed, st):
            np.testing.assert_allclose(got.numpy(), w.numpy(), **TOL)


def test_split_wholly_past_plen_is_the_merge_identity_exactly():
    """A split with no valid position is (m = -1e30, l = 0, acc = 0), and
    merging it changes no bit of the other splits' state."""
    rng = np.random.default_rng(47)
    args = _inputs(rng, plen=(40, 0))
    q, k, v, k_row, a_row, v_row, plen = (_t(a) for a in args)
    states = _split_states(q, k, v, k_row, a_row, v_row, plen)
    past = [st for p0, _, st in states if p0 >= 40]
    assert past
    for m, l, acc in past:
        assert (m == -1e30).all() and (l[0] == 0).all()
        assert (acc[0] == 0).all()
    live = _merged([st for p0, _, st in states if p0 < 40], a_row)
    full = _merged([st for _, _, st in states], a_row)
    for a, b in zip(full, live):
        assert torch.equal(a[0], b[0])
    # group 1 (plen 0) is the identity in every split
    assert (full[0][1] == -1e30).all() and (full[1][1] == 0).all()
    assert (full[2][1] == 0).all()


# ----------------------------------------------------------- the routing ---
ROUTES = {
    "mha_padded": dict(members=(4, 3), nmax=4, gqa=False, h=32, r=25),
    "gqa_nemotron_like": dict(members=(4, 3), nmax=4, gqa=True, n_kv=8,
                              r_g=5, qpk=6),
    "random": dict(random=True),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_routing_covers_every_row_once(name):
    kw = dict(ROUTES[name])
    rng = np.random.default_rng(sorted(ROUTES).index(name) + 50)
    if kw.pop("random", False):
        g, nr, a, kv, vr = 3, 37, 61, 7, 5
        k_row = rng.integers(0, kv, (g, nr)).astype(np.int32)
        a_row = rng.integers(0, nr, (g, a)).astype(np.int32)
        v_row = rng.integers(0, vr, (g, a)).astype(np.int32)
    else:
        k_row, a_row, v_row, kv, vr, _ = _maps(rng, **kw)
        g, nr = k_row.shape
        a = a_row.shape[1]
    units = tck.relay_units(_t(k_row), _t(a_row), _t(v_row))
    cfg = tck.relay_launch_config(g, nr, a, kv, vr, 16)
    for i, unit in enumerate(units):
        seen_q = [row for su in unit["scores"] for row in su["queries"]]
        assert sorted(seen_q) == list(range(nr))
        seen_a = [m[0] for vu in unit["sums"] for m in vu["members"]]
        assert sorted(seen_a) == list(range(a))
        for su in unit["scores"]:
            assert 0 < len(su["queries"]) <= 8
            assert all(k_row[i, row] == su["kv"] for row in su["queries"])
            assert su["queries"] == sorted(su["queries"])
        for vu in unit["sums"]:
            assert 0 < len(vu["members"]) <= 8
            for acc_row, row in vu["members"]:
                assert v_row[i, acc_row] == vu["vr"]
                assert a_row[i, acc_row] == row
        for key, rows, cap in (("scores", k_row[i], 8),
                               ("sums", v_row[i], 8)):
            for r in set(rows.tolist()):
                sizes = [len(u["queries" if key == "scores" else "members"])
                         for u in unit[key]
                         if u["kv" if key == "scores" else "vr"] == r]
                assert len(sizes) == -(-int((rows == r).sum()) // cap)
                assert max(sizes) - min(sizes) <= 1
        assert len(unit["scores"]) <= cfg.q_slots
        assert len(unit["sums"]) <= cfg.v_slots


# --------------------------------------------------- the bound's bytes ----
@pytest.mark.parametrize("k_rows,v_rows,plen,hd,cache_bytes,int8", [
    (32, 32, 256, 128, 2, False), (8, 8, 65536, 128, 2, False),
    (25, 32, 1000, 64, 4, False), (8, 8, 256, 128, 1, True)])
def test_relay_bytes_estimate_matches_reference(k_rows, v_rows, plen, hd,
                                                cache_bytes, int8):
    got = tops.relay_prefix_hbm_bytes_estimate(
        k_rows, v_rows, plen, hd, cache_bytes=cache_bytes, int8_scales=int8)
    want = jops.relay_prefix_hbm_bytes_estimate(
        k_rows, v_rows, plen, hd, cache_bytes=cache_bytes, int8_scales=int8)
    assert got == want
    assert isinstance(got, float)
