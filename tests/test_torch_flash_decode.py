"""The port's plain flash decode (the CUDA ``flash_decode`` /
``paged_decode`` kernels' plain versions) against the JAX package's
Pallas kernels in interpret mode, on the CPU.

* The reference's sweep shapes (``tests/test_kernels.py``:
  ``test_flash_decode_sweep`` and ``test_paged_decode_sweep``), fp32 and
  bf16: MHA, GQA 4:1, MQA, a single tile and a sliding window of 24. The
  same seeded numpy inputs go to ``repro.kernels.flash_attention.
  flash_decode`` / ``paged_decode`` (``interpret=True``) and to
  ``repro_torch.kernels.ops.flash_decode_attention`` /
  ``paged_decode_attention`` (CPU tensors: the plain versions). The
  tolerances are the reference's own: ``TOL`` (atol = rtol = 2e-3) for
  fp32 and ``TOL_BF16`` (atol = rtol = 2e-2) for bf16 inputs, whose
  values the oracles read in fp32.
* Dense == paged bitwise in the plain versions (the pool holds the dense
  cache's pages; the kernels' invariant at ts == page).
* The null page 0 is masked: poisoning it with 999 changes nothing; so
  are positions past ``pos``.
* The CUDA wrappers raise on CPU tensors: no fallback to the plain path.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as jfk
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# The reference's tolerances (tests/test_kernels.py: TOL, TOL_BF16).
TOL = dict(rtol=2e-3, atol=2e-3)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"fp32": (jnp.float32, torch.float32, TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}


def _both(x, dtype):
    """One numpy array as (jax, torch) arrays of the same values."""
    jdt, tdt, _ = DTYPES[dtype]
    return (jnp.asarray(x, jdt),
            torch.from_numpy(np.asarray(x, np.float32)).to(tdt))


def _tables(rng, b, n_pages, n_pool, n):
    """n block tables of distinct physical pages, never page 0."""
    perm = rng.permutation(np.arange(1, n_pool))[:n * b * n_pages]
    return perm.reshape(n, b, n_pages).astype(np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,hd,ts,window", [
    (1, 4, 4, 32, 16, 8, 0),
    (2, 8, 2, 64, 32, 16, 0),       # GQA 4:1
    (3, 6, 1, 48, 8, 16, 0),        # MQA
    (2, 4, 4, 64, 32, 64, 0),       # single tile
    (2, 8, 4, 64, 16, 16, 24),      # sliding window
], ids=["mha", "gqa4", "mqa", "single_tile", "window24"])
def test_flash_decode_plain_matches_pallas(dtype, b, h, kv, s, hd, ts,
                                           window):
    rng = np.random.default_rng(0)
    jq, tq = _both(rng.normal(size=(b, h, hd)), dtype)
    jk, tk = _both(rng.normal(size=(b, kv, s, hd)), dtype)
    jv, tv = _both(rng.normal(size=(b, kv, s, hd)), dtype)
    pos = rng.integers(1, s, size=b).astype(np.int32)
    want = jfk.flash_decode(jq, jk, jv, jnp.asarray(pos), window=window,
                            ts=ts, interpret=True)
    got = tops.flash_decode_attention(tq, tk, tv, torch.from_numpy(pos),
                                      window=window, ts=ts)
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,n_pages,page,hd,window", [
    (1, 4, 4, 4, 8, 16, 0),
    (2, 8, 2, 4, 16, 32, 0),        # GQA 4:1
    (3, 6, 1, 6, 8, 8, 0),          # MQA
    (2, 4, 4, 1, 64, 32, 0),        # single page
    (2, 8, 4, 4, 16, 16, 24),       # sliding window
], ids=["mha", "gqa4", "mqa", "single_page", "window24"])
def test_paged_decode_plain_matches_pallas(dtype, b, h, kv, n_pages, page,
                                           hd, window):
    rng = np.random.default_rng(1)
    n_pool = 2 * b * n_pages + 1
    jpool, tpool = _both(rng.normal(size=(n_pool, kv, page, hd)), dtype)
    bt_k, bt_v = _tables(rng, b, n_pages, n_pool, 2)
    jq, tq = _both(rng.normal(size=(b, h, hd)), dtype)
    pos = rng.integers(1, n_pages * page, size=b).astype(np.int32)
    want = jfk.paged_decode(jq, jpool, jnp.asarray(bt_k), jnp.asarray(bt_v),
                            jnp.asarray(pos), window=window, interpret=True)
    got = tops.paged_decode_attention(tq, tpool, torch.from_numpy(bt_k),
                                      torch.from_numpy(bt_v),
                                      torch.from_numpy(pos), window=window)
    assert got.dtype == torch.float32 and got.shape == (b, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


def _paged_copy(rng, kc, vc, page):
    """A pool holding the dense caches' pages at shuffled ids (random
    values elsewhere, page 0 included) and the two block tables."""
    b, kv, s, hd = kc.shape
    n_pages = s // page
    n_pool = 2 * b * n_pages + 3
    pool = torch.from_numpy(
        rng.normal(size=(n_pool, kv, page, hd)).astype(np.float32))
    bt_k, bt_v = (torch.from_numpy(t)
                  for t in _tables(rng, b, n_pages, n_pool, 2))
    pool[bt_k.long()] = kc.reshape(b, kv, n_pages, page, hd).movedim(2, 1)
    pool[bt_v.long()] = vc.reshape(b, kv, n_pages, page, hd).movedim(2, 1)
    return pool, bt_k, bt_v


@pytest.mark.parametrize("window", [0, 24])
def test_paged_plain_bitwise_equals_dense(window):
    """The pool holds the dense cache's pages: the paged plain version is
    bitwise the dense one (the reference's
    ``test_paged_decode_matches_dense_flash_decode`` at ts == page)."""
    rng = np.random.default_rng(2)
    b, h, kv, s, hd, page = 3, 8, 2, 64, 16, 16
    kc = torch.from_numpy(rng.normal(size=(b, kv, s, hd)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(b, kv, s, hd)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(b, h, hd)).astype(np.float32))
    pos = torch.tensor([s - 1, 13, 40], dtype=torch.int32)
    pool, bt_k, bt_v = _paged_copy(rng, kc, vc, page)
    dense = tops.flash_decode_attention(q, kc, vc, pos, window=window,
                                        ts=page)
    paged = tops.paged_decode_attention(q, pool, bt_k, bt_v, pos,
                                        window=window)
    assert torch.equal(dense, paged)


def test_null_page_and_future_positions_are_masked():
    """Only the first 2 logical pages are allocated (the rest name the
    null page 0) and pos stays inside them: poisoning page 0, or every
    dense position past pos, with 999 changes nothing; the result equals
    the Pallas kernel's."""
    rng = np.random.default_rng(3)
    b, h, n_pages, page, hd = 1, 4, 4, 8, 16
    n_pool = 2 * n_pages + 1
    pool = torch.from_numpy(
        rng.normal(size=(n_pool, h, page, hd)).astype(np.float32))
    bt = torch.from_numpy(_tables(rng, b, n_pages, n_pool, 1)[0])
    bt[:, 2:] = 0
    pos = torch.tensor([2 * page - 1], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(size=(b, h, hd)).astype(np.float32))
    out = tops.paged_decode_attention(q, pool, bt, bt, pos)
    poisoned = pool.clone()
    poisoned[0] = 999.0
    assert torch.equal(
        tops.paged_decode_attention(q, poisoned, bt, bt, pos), out)
    want = jfk.paged_decode(jnp.asarray(q.numpy()), jnp.asarray(pool.numpy()),
                            jnp.asarray(bt.numpy()), jnp.asarray(bt.numpy()),
                            jnp.asarray(pos.numpy()), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    kc = tref.gather_pages_ref(pool, bt)
    vc = kc.clone()
    dense = tops.flash_decode_attention(q, kc, vc, pos, ts=page)
    kc[:, :, int(pos[0]) + 1:] = 999.0
    vc[:, :, int(pos[0]) + 1:] = 999.0
    assert torch.equal(tops.flash_decode_attention(q, kc, vc, pos, ts=page),
                       dense)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_step_and_masked_row(window):
    """The fused CHAI kernels' online-softmax step is the tile up to 128
    positions, else its largest divisor under that (the flash decode
    kernels step by their 64-position chunk); a row whose every position
    is masked (pos < 0) gives zeros, as the Pallas kernel's clamped max
    does."""
    assert [tck.decode_step_size(t) for t in (8, 16, 48, 128, 512, 1000,
                                              1009)] == [8, 16, 48, 128,
                                                         128, 125, 1]
    q = torch.randn(2, 4, 8)
    k = torch.randn(2, 2, 32, 8)
    pos = torch.tensor([-1, 20], dtype=torch.int32)
    out = tops.flash_decode_attention(q, k, k, pos, window=window, ts=8)
    assert torch.equal(out[0], torch.zeros(4, 8))
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("op", ["flash_decode", "paged_decode"])
def test_cuda_wrappers_refuse_cpu_tensors(op):
    """The kernel wrappers launch or raise: a CPU tensor is refused, and
    the count of launches does not move."""
    q = torch.zeros(1, 4, 16)
    before = dict(tfk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        if op == "flash_decode":
            k = torch.zeros(1, 4, 32, 16)
            tfk.flash_decode(q, k, k, torch.zeros(1, dtype=torch.int32))
        else:
            pool = torch.zeros(5, 4, 16, 16)
            bt = torch.ones(1, 2, dtype=torch.int32)
            tfk.paged_decode(q, pool, bt, bt,
                             torch.zeros(1, dtype=torch.int32))
    assert tfk.LAUNCHES == before
