"""The port's RWKV-6 block (``repro_torch.models.rwkv``) against the JAX
package's (``repro.models.rwkv``), on the CPU.

One RWKV layer of reduced rwkv6-1.6b (d 64, 4 heads of 16, d_ff 128):
seeded numpy weights of the port's ``param_table`` shapes at their init
scales (the zero-init norms at 0.1, so they act), cast to the model dtype
in jax and carried to torch by ``params_from_numpy``; seeded numpy
inputs and state.

* The time mix over the full sequence at T 8, 32 and 64 (one chunk of 8,
  one full chunk, two chunks) from zeros and from a state, and its
  decode step; the channel mix over the full sequence and its decode
  step; ``_group_norm`` (the population variance): outputs and state at
  ``TOL`` in fp32.
* Inside the port: N chained time-mix decode steps equal one
  full-sequence pass over the same N tokens from the same state.
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
from repro.models import rwkv as jrwkv
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttfm
from repro_torch.weights import params_from_numpy

ARCH = "rwkv6-1.6b"
# The state sums products whose factored decays reach exp(+-48) inside a
# chunk: its fp32 rounding differs between the packages by ~1e-6 of its
# largest entries.
TOL = dict(atol=2e-5, rtol=2e-5)
# bf16 rounds every stored activation to 8 bits of mantissa; the state of
# order 10 is stored in bf16 after the pass, one step there is 2^-4.
BF16_TOL = dict(atol=6e-2, rtol=2e-2)


@functools.lru_cache(maxsize=None)
def _layer(dtype):
    jcfg = jreduced(jget_config(ARCH), dtype=dtype)
    tcfg = reduced(get_config(ARCH), dtype=dtype)
    assert (tcfg.d_model, tcfg.n_rwkv_heads, tcfg.rwkv_head_dim) == (64, 4,
                                                                     16)
    rng = np.random.default_rng(2)
    jp = {n: jnp.asarray((rng.normal(size=shape[1:]) * (scale or 0.1))
                         .astype(np.float32)).astype(dtype)
          for n, (shape, _, scale) in ttfm.param_table(tcfg)["rwkv"].items()}
    tp = params_from_numpy({"l": jax.tree.map(np.asarray, jp)},
                           device="cpu")["l"]
    return jcfg, tcfg, jp, tp


def _inputs(cfg, t, seed, dtype="float32"):
    """x (2, T, d), a state {shift (2, d), wkv (2, H, hd, hd)} and a
    channel-mix ``last`` (2, d), as jax arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    hd = cfg.rwkv_head_dim
    arrays = dict(
        x=rng.normal(size=(2, t, cfg.d_model)),
        shift=rng.normal(size=(2, cfg.d_model)),
        wkv=rng.normal(size=(2, cfg.n_rwkv_heads, hd, hd)),
        last=rng.normal(size=(2, cfg.d_model)))
    j = {k: jnp.asarray(v.astype(np.float32)).astype(dtype)
         for k, v in arrays.items()}
    t_ = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        getattr(torch, dtype)) for k, v in j.items()}
    return j, t_


def _np(x):
    return np.array(x.float() if torch.is_tensor(x)
                    else jnp.asarray(x).astype(jnp.float32))


def _hold(pairs, tol):
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("t", [8, 32, 64])
def test_time_mix_fullseq_matches_reference(t, state):
    jcfg, tcfg, jp, tp = _layer("float32")
    j, tt = _inputs(tcfg, t, seed=t)
    if not state:
        for d in (j, tt):
            d["shift"], d["wkv"] = d["shift"] * 0, d["wkv"] * 0
    jy, jst = jax.jit(functools.partial(jrwkv.rwkv_time_mix_fullseq,
                                        cfg=jcfg))(
        j["x"], jp, state={"shift": j["shift"], "wkv": j["wkv"]})
    ty, tst = trwkv.rwkv_time_mix_fullseq(
        tt["x"], tp, tcfg, {"shift": tt["shift"], "wkv": tt["wkv"]})
    _hold([(ty, jy), (tst["shift"], jst["shift"]),
           (tst["wkv"], jst["wkv"])], TOL)


def test_time_mix_decode_matches_reference():
    jcfg, tcfg, jp, tp = _layer("float32")
    j, tt = _inputs(tcfg, 1, seed=9)
    jy, jst = jrwkv.rwkv_time_mix_decode(
        j["x"][:, 0], jp, jcfg, {"shift": j["shift"], "wkv": j["wkv"]})
    ty, tst = trwkv.rwkv_time_mix_decode(
        tt["x"][:, 0], tp, tcfg, {"shift": tt["shift"], "wkv": tt["wkv"]})
    _hold([(ty, jy), (tst["shift"], jst["shift"]),
           (tst["wkv"], jst["wkv"])], TOL)


@pytest.mark.parametrize("t", [1, 32])
def test_channel_mix_matches_reference(t):
    """The channel mix over the full sequence, and its decode step."""
    _, tcfg, jp, tp = _layer("float32")
    j, tt = _inputs(tcfg, t, seed=20 + t)
    jy, jlast = jrwkv.rwkv_channel_mix_fullseq(j["x"], jp, j["last"])
    ty, tlast = trwkv.rwkv_channel_mix_fullseq(tt["x"], tp, tt["last"])
    jy1, jlast1 = jrwkv.rwkv_channel_mix_decode(j["x"][:, -1], jp, j["last"])
    ty1, tlast1 = trwkv.rwkv_channel_mix_decode(tt["x"][:, -1], tp,
                                                tt["last"])
    _hold([(ty, jy), (tlast, jlast), (ty1, jy1), (tlast1, jlast1)], TOL)


def test_group_norm_is_the_population_variance():
    """``_group_norm`` against the reference's on (B, T, H, hd) values of
    varied scale per head, and against numpy's population variance."""
    rng = np.random.default_rng(6)
    o = (rng.normal(size=(2, 5, 4, 16))
         * rng.uniform(0.1, 10.0, size=(1, 1, 4, 1))).astype(np.float32)
    scale = rng.normal(size=(4, 16)).astype(np.float32)
    want = jrwkv._group_norm(jnp.asarray(o), jnp.asarray(scale), 1e-6)
    got = trwkv._group_norm(torch.from_numpy(o), torch.from_numpy(scale),
                            1e-6)
    by_numpy = ((o - o.mean(-1, keepdims=True))
                / np.sqrt(o.var(-1, keepdims=True) + 1e-6) * (1 + scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), by_numpy, **TOL)


@pytest.mark.parametrize("n", [1, 8])
def test_chained_decode_equals_fullseq(n):
    """N time-mix decode steps from a state give the outputs and the state
    of one full-sequence pass over the N tokens from the same state."""
    _, tcfg, _, tp = _layer("float32")
    _, tt = _inputs(tcfg, n, seed=12)
    st0 = {"shift": tt["shift"], "wkv": tt["wkv"]}
    y_full, st_full = trwkv.rwkv_time_mix_fullseq(tt["x"], tp, tcfg, st0)
    st, ys = st0, []
    for i in range(n):
        y, st = trwkv.rwkv_time_mix_decode(tt["x"][:, i], tp, tcfg, st)
        ys.append(y)
    torch.testing.assert_close(torch.stack(ys, 1), y_full, **TOL)
    for key in st:
        torch.testing.assert_close(st[key], st_full[key], **TOL)


def test_bf16_state_dtype_and_values():
    """bf16 weights, inputs and state: a 32-token time-mix pass and a
    channel-mix pass, then a decode step of each from their state. The
    state is bf16 after both, as the reference's; outputs and state at
    ``BF16_TOL`` of the reference's."""
    jcfg, tcfg, jp, tp = _layer("bfloat16")
    assert tp["w_r"].dtype == torch.bfloat16
    j, tt = _inputs(tcfg, 33, seed=13, dtype="bfloat16")
    jy, jst = jax.jit(functools.partial(jrwkv.rwkv_time_mix_fullseq,
                                        cfg=jcfg))(
        j["x"][:, :32], jp, state={"shift": j["shift"], "wkv": j["wkv"]})
    ty, tst = trwkv.rwkv_time_mix_fullseq(
        tt["x"][:, :32], tp, tcfg, {"shift": tt["shift"], "wkv": tt["wkv"]})
    jy2, jst2 = jrwkv.rwkv_time_mix_decode(j["x"][:, 32], jp, jcfg, jst)
    ty2, tst2 = trwkv.rwkv_time_mix_decode(tt["x"][:, 32], tp, tcfg, tst)
    jc, jlast = jrwkv.rwkv_channel_mix_fullseq(j["x"][:, :32], jp, j["last"])
    tc, tlast = trwkv.rwkv_channel_mix_fullseq(tt["x"][:, :32], tp,
                                               tt["last"])
    jc2, jlast2 = jrwkv.rwkv_channel_mix_decode(j["x"][:, 32], jp, jlast)
    tc2, tlast2 = trwkv.rwkv_channel_mix_decode(tt["x"][:, 32], tp, tlast)
    for x in (ty, tst["wkv"], tst["shift"], ty2, tst2["wkv"], tc, tlast,
              tc2, tlast2):
        assert x.dtype == torch.bfloat16
    _hold([(ty, jy), (tst["wkv"], jst["wkv"]), (tst["shift"], jst["shift"]),
           (ty2, jy2), (tst2["wkv"], jst2["wkv"]), (tc, jc), (tlast, jlast),
           (tc2, jc2), (tlast2, jlast2)], BF16_TOL)
