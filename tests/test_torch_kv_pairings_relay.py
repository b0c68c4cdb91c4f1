"""The relay kernel and the prefix pass on every K/V pairing the Pallas
wrappers take, against the JAX package's, on the CPU.

``relay_prefix_decode`` (Pallas body ``_relay_prefix_kernel``) reads K
and V each on its own, fp32, bf16 or int8, each with or without its row
scales; ``paged_prefix_attend`` (``_paged_prefix_kernel``) reads K and V
from one pool, fp32, bf16 or int8, each side with its scale pool or none.
The port's plain versions (``kernels.ref``) are held to the Pallas
kernels in interpret mode on the same numpy inputs for every pairing but
the serving paths' (float without scales; int8 with both scales; the
relay's int8 K with scales beside raw int8 V, held in
``test_torch_share_values.py``), with the sides of
``test_torch_kv_pairings.py`` (raw int8 K beside queries over 40, raw
int8 V held over 127), at atol = rtol = 2e-5.
"""
import numpy as np
import pytest

import torch

from repro.kernels import chai_attention as jck
from repro.kernels import flash_attention as jfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from test_torch_kv_pairings import (CODE_SCALE, IDS, PAGE, PAIRS, held,
                                    side, to_j, to_t)


# int8 K with scales beside raw int8 V is the share relay's own pairing
RELAY_PAIRS = [p for p in PAIRS if p != ("i8s", "i8")]


@pytest.mark.parametrize("pair", RELAY_PAIRS,
                         ids=[i for p, i in zip(PAIRS, IDS)
                              if p != ("i8s", "i8")])
def test_relay_pairing_matches_pallas(rng, pair):
    """Two groups of MHA rows (a K row a rep, a V row a head), the second
    with a padded member (index 0 in every map) and a shorter plen."""
    g, nmax, r, h, hd, sp = 2, 3, 3, 8, 16, 64
    nr, a = nmax * r, nmax * h
    q = rng.normal(size=(g, nr, hd)).astype(np.float32)
    if pair[0] == "i8":
        q = q / CODE_SCALE
    k = side(rng, (g, h, sp, hd), pair[0])
    v = side(rng, (g, h, sp, hd), pair[1])
    k_row = rng.integers(0, h, size=(g, nr)).astype(np.int32)
    a_row = (np.repeat(np.arange(nmax) * r, h)[None]
             + rng.integers(0, r, size=(g, a))).astype(np.int32)
    v_row = np.tile(np.arange(h), (g, nmax)).astype(np.int32)
    for m in (k_row, a_row, v_row):         # group 1: member 2 is padding
        m[1, -(m.shape[1] // nmax):] = 0
    plen = np.array([48, 20], np.int32)
    maps = (k_row, a_row, v_row, plen)
    want = jck.relay_prefix_decode(
        to_j(q), to_j(k[0], k[3]), to_j(v[0], v[3]),
        *(to_j(x) for x in maps),
        k_scale=None if k[1] is None else to_j(k[1]),
        v_scale=None if v[1] is None else to_j(v[1]), ts=PAGE)
    got = tops.relay_prefix_attention(
        to_t(q), to_t(k[0], k[2]), to_t(v[0], v[2]),
        *(to_t(x) for x in maps),
        k_scale=None if k[1] is None else to_t(k[1]),
        v_scale=None if v[1] is None else to_t(v[1]), ts=PAGE)
    held(got, want, pair[1])


POOLS = [(base, k_s, v_s) for base in ("f32", "bf16", "i8")
         for k_s in (False, True) for v_s in (False, True)
         if not (base != "i8" and not k_s and not v_s)
         and not (base == "i8" and k_s and v_s)]


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize(
    "pool_kind", POOLS,
    ids=[f"{b}{'s' * k}-{b}{'s' * v}" for b, k, v in POOLS])
def test_paged_prefix_pairing_matches_pallas(rng, pool_kind, kv):
    """Row 0 at plen 0 (the exact merge identity), row 1 over 40 cached
    positions of shuffled pages; the null page poisoned."""
    base, k_s, v_s = pool_kind
    b, t, h, hd, n_pages = 2, 16, 4, 16, 4
    n_pool = 2 * b * n_pages + 1
    pool = side(rng, (n_pool, kv, PAGE, hd),
                base + ("s" if k_s or v_s else ""))
    codes, scales = np.array(pool[0]), pool[1]
    codes[0] = 99
    if scales is not None:
        scales = np.array(scales)
        scales[0] = 1e3
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    if base == "i8" and not k_s:
        q = q / CODE_SCALE
    q_t = to_t(q, pool[2] if base != "i8" else torch.float32)
    q_j = to_j(q, pool[3] if base != "i8" else np.float32)
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    bt_k = perm[:b * n_pages].reshape(b, n_pages)
    bt_v = perm[b * n_pages:2 * b * n_pages].reshape(b, n_pages)
    plen = np.array([0, 40], np.int32)
    bt_k[1, 3:] = bt_v[1, 3:] = 0           # past the prefix: null page
    tabs = (bt_k, bt_v, plen)
    want = jfk.paged_prefix_attend(
        q_j, to_j(codes, pool[3]), *(to_j(x) for x in tabs),
        k_scale_pool=to_j(scales) if k_s else None,
        v_scale_pool=to_j(scales) if v_s else None)
    got = tops.paged_prefix_attention(
        q_t, to_t(codes, pool[2]), *(to_t(x) for x in tabs),
        k_scale_pool=to_t(scales) if k_s else None,
        v_scale_pool=to_t(scales) if v_s else None)
    held(got, want, "i8" if base == "i8" and not v_s else base)
    m, l, acc = got
    assert torch.equal(m[0], torch.full_like(m[0], tref.NEG_INF))
    assert not l[0].any() and not acc[0].any()
