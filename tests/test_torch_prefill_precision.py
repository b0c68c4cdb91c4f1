"""The prefill kernels' precision scheme against the JAX package, on the
CPU.

``csrc/flash_tiles.cuh`` runs both products of ``flash_prefill`` /
``paged_prefix_attend`` on the tensor cores and splits the operands so
that the state holds the card check's 2e-5 against the fp32 reference:

* bf16 inputs: Q.K^T from bf16 operands (their products are exact in
  fp32); p.V as p1.V + p2.V + p3.V with p1 = bf16(p), p2 = bf16(p - p1),
  p3 = bf16(p - p1 - p2) (bf16 V is exact);
* fp32 inputs: 3xTF32 on both products, a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
  with tf32(x) x rounded to nearest at 10 mantissa bits (the low 13 bits
  cleared) and lo = tf32(x - hi).

The emulation below repeats the kernel's tile loop (online softmax over
key tiles of the kernel's size, each tile's p.V summed apart and added to
acc; two key groups over the even and the odd tiles, merged at the end)
with exactly those operand roundings, in fp32 torch. It is held
against the reference's Pallas ``flash_prefill`` (interpret mode) at
atol = rtol = 2e-5 on a chunk-shaped reduced case (T = 64 queries, GQA
4 over 2, head dim 32, offset 0 and 32), as the state and finalized (a
finalized bf16 output rounds once to bf16, so it is held at one bf16 step,
as ``chip_smoke.py`` holds it). The tf32 split of p (two pieces), which
the kernel's first version used for bf16 inputs, holds too. p rounded to
bf16 once, as a bf16 attention kernel rounds it, does not hold 2e-5: the
reason for the split.
"""
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import flash_attention as jfk

TOL = dict(atol=2e-5, rtol=2e-5)
BF16_OUT_TOL = dict(atol=2e-5, rtol=2 ** -7)
NEG_INF = -2.0e38
B, T, H, KV, HD = 1, 64, 4, 2, 32


def tf32(x):
    """x rounded to nearest at 10 mantissa bits, ties away from zero, its
    low 13 bits cleared (what a tensor core reads of an fp32 operand), as
    the kernel's ``tf32_rn``."""
    bits = x.contiguous().view(torch.int32) + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def _scores(q, k, dtype):
    """q (B, H, T, hd) . k (B, H, ts, hd)^T as the kernel forms it."""
    if dtype == "bf16":
        return q @ k.transpose(-1, -2)
    (qh, ql), (kh, kl) = _hi_lo(q), _hi_lo(k)
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    return ql @ t(kh) + qh @ t(kl) + qh @ t(kh)


def _pv(p, v, split):
    """p (B, H, T, ts) . v (B, H, ts, hd) with the given operand split."""
    if split == "bf16x3":                 # the kernel, bf16 inputs
        p1 = bf16(p)
        p2 = bf16(p - p1)
        p3 = bf16(p - p1 - p2)
        return p3 @ v + p2 @ v + p1 @ v
    if split == "tf32x2":                 # two tf32 pieces of p
        ph, pl = _hi_lo(p)
        return pl @ v + ph @ v
    if split == "3xtf32":                 # the kernel, fp32 inputs
        (ph, pl), (vh, vl) = _hi_lo(p), _hi_lo(v)
        return pl @ vh + ph @ vl + ph @ vh
    assert split == "bf16"                # p rounded once, as a bf16 kernel
    return bf16(p) @ v


def emulated_state(q, k, v, offset, dtype, split):
    """The kernel's tile loop in torch fp32: q (B, T, H, hd), k/v
    (B, S, KV, hd) as fp32 tensors (bf16-valued for bf16 inputs); two key
    groups take the even and the odd key tiles, and their states merge at
    the end. Returns the head-major (m, l, acc)."""
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(H // KV, 1)
    vh = v.transpose(1, 2).repeat_interleave(H // KV, 1)
    s, hd = k.shape[1], q.shape[-1]
    ts = 64 if (2 if dtype == "bf16" else 4) * hd <= 256 else 32
    qpos = offset + torch.arange(T)
    states = []
    for group in (0, 1):
        m = torch.full((B, H, T), NEG_INF)
        l = torch.zeros((B, H, T))
        acc = torch.zeros((B, H, T, hd))
        for k0 in range(group * ts, s, 2 * ts):
            sc = _scores(qh, kh[:, :, k0:k0 + ts], dtype) * (
                1.0 / math.sqrt(hd))
            kpos = k0 + torch.arange(sc.shape[-1])
            sc = torch.where(kpos[None, :] <= qpos[:, None], sc, NEG_INF)
            m_new = torch.clamp(torch.maximum(m, sc.amax(-1)), min=-1e30)
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _pv(p, vh[:, :, k0:k0 + ts],
                                                split)
            m = m_new
        states.append((m, l, acc))
    (m0, l0, a0), (m1, l1, a1) = states
    m = torch.maximum(m0, m1)
    c0, c1 = torch.exp(m0 - m), torch.exp(m1 - m)
    return m, l0 * c0 + l1 * c1, a0 * c0[..., None] + a1 * c1[..., None]


def _inputs(rng, offset, dtype):
    s = offset + T
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, T, H, HD), (B, s, KV, HD), (B, s, KV, HD))]
    if dtype == "bf16":
        arrs = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                for a in arrs]
    return arrs


def _reference(arrs, offset, dtype, emit_state):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    out = jfk.flash_prefill(*(jnp.asarray(a, jdt) for a in arrs),
                            offset=offset, emit_state=emit_state,
                            interpret=True)
    if emit_state:
        return [np.asarray(x, np.float32) for x in out]
    return np.asarray(out.astype(jnp.float32))


KERNEL_SPLIT = {"bf16": "bf16x3", "fp32": "3xtf32"}


@pytest.mark.parametrize("emit_state", [True, False],
                         ids=["state", "finalized"])
@pytest.mark.parametrize("offset", [0, 32])
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_kernel_rounding_holds_the_reference(dtype, offset, emit_state):
    rng = np.random.default_rng(offset + (dtype == "bf16"))
    arrs = _inputs(rng, offset, dtype)
    m, l, acc = emulated_state(*(torch.from_numpy(a) for a in arrs), offset,
                               dtype, KERNEL_SPLIT[dtype])
    want = _reference(arrs, offset, dtype, emit_state)
    if emit_state:
        for got, w in zip((m, l, acc), want):
            np.testing.assert_allclose(got.numpy(), w, **TOL)
        return
    out = (acc / torch.clamp(l, min=1e-37)[..., None]).transpose(1, 2)
    if dtype == "bf16":
        np.testing.assert_allclose(bf16(out).numpy(), want, **BF16_OUT_TOL)
    else:
        np.testing.assert_allclose(out.numpy(), want, **TOL)


@pytest.mark.parametrize("offset", [0, 32])
def test_two_tf32_pieces_of_p_hold_too(offset):
    rng = np.random.default_rng(10 + offset)
    arrs = _inputs(rng, offset, "bf16")
    got = emulated_state(*(torch.from_numpy(a) for a in arrs), offset,
                         "bf16", "tf32x2")
    for g, w in zip(got, _reference(arrs, offset, "bf16", True)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("offset", [0, 32])
def test_p_rounded_to_bf16_does_not_hold(offset):
    """The split is needed: one bf16 rounding of p misses 2e-5 by far."""
    rng = np.random.default_rng(20 + offset)
    arrs = _inputs(rng, offset, "bf16")
    _, _, acc = emulated_state(*(torch.from_numpy(a) for a in arrs), offset,
                               "bf16", "bf16")
    want = _reference(arrs, offset, "bf16", True)[2]
    err = np.abs(acc.numpy() - want)
    assert not np.all(err <= TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert err.max() > 1e-3
