"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``), on the CPU.

One RG-LRU layer of reduced recurrentgemma-9b (d 64, rnn 64, conv width
4): seeded numpy weights of the port's ``param_table`` shapes at their
init scales (the zero-init norm and conv bias at 0.1, so they act),
cast to the model dtype in jax and carried to torch by
``params_from_numpy``; seeded numpy inputs.

* ``rglru_fullseq`` at T 1, 7, 32 and 64, from zeros and from a state
  (``h0``, ``conv_tail``), and ``rglru_decode``: outputs and state at
  ``TOL`` in fp32.
* The doubling scan against ``lax.associative_scan`` over the same
  (a, b) and against a float64 loop: its sums are ordered otherwise than
  XLA's, so the two agree at ``SCAN_TOL``, not bit for bit.
* Inside the port: N chained ``rglru_decode`` steps equal one
  ``rglru_fullseq`` over the same N tokens from the same state.
* bf16: the state comes back in the model dtype, and the outputs and the
  state are held against the reference's bf16 ones at ``BF16_TOL``.
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import rglru as jrg
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as ttfm
from repro_torch.weights import params_from_numpy

ARCH = "recurrentgemma-9b"
TOL = dict(atol=1e-5, rtol=1e-5)
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16 rounds every stored activation to 8 bits of mantissa: one bf16 step
# of an O(1) value is 2^-8, and the two packages' fp32 products may round
# to neighbouring bf16 values, a step or two at the outputs.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@functools.lru_cache(maxsize=None)
def _layer(dtype):
    jcfg = jreduced(jget_config(ARCH), dtype=dtype)
    tcfg = reduced(get_config(ARCH), dtype=dtype)
    assert (tcfg.rnn_width, tcfg.conv_width, tcfg.d_model) == (64, 4, 64)
    rng = np.random.default_rng(1)
    jp = {n: jnp.asarray((rng.normal(size=shape[1:]) * (scale or 0.1))
                         .astype(np.float32)).astype(dtype)
          for n, (shape, _, scale) in ttfm.param_table(tcfg)["rglru"].items()}
    tp = params_from_numpy({"l": jax.tree.map(np.asarray, jp)},
                           device="cpu")["l"]
    return jcfg, tcfg, jp, tp


def _inputs(cfg, t, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.rnn_width)).astype(np.float32)
    tail = rng.normal(size=(2, cfg.conv_width - 1, cfg.rnn_width)).astype(
        np.float32)
    return x, h0, tail


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x):
    return (x.float() if torch.is_tensor(x) else
            jnp.asarray(x).astype(jnp.float32)).__array__()


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("t", [1, 7, 32, 64])
def test_fullseq_matches_reference(t, state):
    jcfg, tcfg, jp, tp = _layer("float32")
    x, h0, tail = _inputs(tcfg, t, seed=t)
    kw_j, kw_t = {}, {}
    if state:
        kw_j = dict(h0=jnp.asarray(h0), conv_tail=jnp.asarray(tail))
        kw_t = dict(h0=torch.from_numpy(h0), conv_tail=torch.from_numpy(tail))
    jy, (jh, jtail) = jax.jit(functools.partial(
        jrg.rglru_fullseq, cfg=jcfg))(jnp.asarray(x), jp, **kw_j)
    ty, (th, ttail) = trg.rglru_fullseq(torch.from_numpy(x), tp, tcfg, **kw_t)
    assert ty.shape == (2, t, tcfg.d_model)
    assert th.shape == (2, tcfg.rnn_width)
    assert ttail.shape == tuple(jtail.shape)
    for got, want in ((ty, jy), (th, jh), (ttail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_reference():
    jcfg, tcfg, jp, tp = _layer("float32")
    x, h, tail = _inputs(tcfg, 1, seed=11)
    jy, (jh, jtail) = jrg.rglru_decode(jnp.asarray(x[:, 0]), jp, jcfg,
                                       jnp.asarray(h), jnp.asarray(tail))
    ty, (th, ttail) = trg.rglru_decode(torch.from_numpy(x[:, 0]), tp, tcfg,
                                       torch.from_numpy(h),
                                       torch.from_numpy(tail))
    for got, want in ((ty, jy), (th, jh), (ttail, jtail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t", [1, 5, 64, 100])
def test_doubling_scan_matches_associative_scan(t):
    """a in (0, 1) and b ~ N(0, 1), as the layer makes them: the doubling
    scan against ``lax.associative_scan`` with the reference's combine,
    and both against a float64 loop."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.0, 1.0, size=(3, t, 16)).astype(np.float32)
    b = rng.normal(size=(3, t, 16)).astype(np.float32)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]
    _, want = jax.jit(lambda a_, b_: jax.lax.associative_scan(
        combine, (a_, b_), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = trg.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    exact = np.zeros((3, t, 16))
    h = np.zeros((3, 16))
    for i in range(t):
        h = a[:, i].astype(np.float64) * h + b[:, i]
        exact[:, i] = h
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    np.testing.assert_allclose(got.numpy(), exact, **SCAN_TOL)


@pytest.mark.parametrize("n", [1, 6])
def test_chained_decode_equals_fullseq(n):
    """N decode steps from (h0, conv_tail) give the outputs, h and tail of
    one full-sequence pass over the N tokens from the same state."""
    _, tcfg, _, tp = _layer("float32")
    x, h0, tail = (torch.from_numpy(a) for a in _inputs(tcfg, n, seed=5))
    y_full, (h_full, tail_full) = trg.rglru_fullseq(x, tp, tcfg, h0=h0,
                                                    conv_tail=tail)
    h, tl, ys = h0, tail, []
    for i in range(n):
        y, (h, tl) = trg.rglru_decode(x[:, i], tp, tcfg, h, tl)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_full, **TOL)
    torch.testing.assert_close(h, h_full, **TOL)
    torch.testing.assert_close(tl, tail_full, **TOL)


def test_bf16_state_dtype_and_values():
    """bf16 weights and inputs: a 32-token pass from a state, then a
    decode step from its state. The state is bf16 after both, as the
    reference's; outputs and state at ``BF16_TOL`` of the reference's."""
    jcfg, tcfg, jp, tp = _layer("bfloat16")
    assert tp["w_x"].dtype == torch.bfloat16
    x, h0, tail = _inputs(tcfg, 33, seed=7)
    (jx, tx), (jh0, th0), (jtail, ttail) = (
        _pair(a, "bfloat16") for a in (x, h0, tail))
    jy, (jh, jtl) = jax.jit(functools.partial(jrg.rglru_fullseq, cfg=jcfg))(
        jx[:, :32], jp, h0=jh0, conv_tail=jtail)
    ty, (th, ttl) = trg.rglru_fullseq(tx[:, :32], tp, tcfg, h0=th0,
                                      conv_tail=ttail)
    assert ty.dtype == th.dtype == ttl.dtype == torch.bfloat16
    jy2, (jh2, jtl2) = jrg.rglru_decode(jx[:, 32], jp, jcfg, jh, jtl)
    ty2, (th2, ttl2) = trg.rglru_decode(tx[:, 32], tp, tcfg, th, ttl)
    assert ty2.dtype == th2.dtype == ttl2.dtype == torch.bfloat16
    for got, want in ((ty, jy), (th, jh), (ttl, jtl), (ty2, jy2),
                      (th2, jh2), (ttl2, jtl2)):
        np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)
