"""The port's ``chai_fused_decode`` plain version against the JAX package.

On the CPU the port's decode op takes the plain version
(``repro_torch.kernels.ref.chai_fused_decode_ref``); it is held against
the reference's Pallas kernel (interpret mode, the CPU default) and the
reference's own oracle, at atol = rtol = 1e-5 (fp32; the tiled online
softmax and the whole-row softmax round differently in the last bits).
The CUDA kernel itself is built and held against the plain version on
the card by ``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import chai_attention as jck
from repro.kernels import ref as jref
from repro_torch.kernels import build
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(rng, *, b=2, r=5, h=8, kv_k=None, kv_v=None, rpg=1, s=64, hd=16,
          pos=(5, 50)):
    kv_k = kv_k or r
    kv_v = kv_v or h
    q = rng.normal(size=(b, r, hd)).astype(np.float32)
    k = rng.normal(size=(b, kv_k, s, hd)).astype(np.float32)
    v = rng.normal(size=(b, kv_v, s, hd)).astype(np.float32)
    if rpg == 1:
        # every rep but the last-but-one has members: one empty rep
        h2c = rng.choice([j for j in range(r) if j != r - 2], size=(b, h))
    else:
        # head h (KV group h // qpk) picks a rep of its own group
        qpk = h // kv_k
        grp = np.arange(h) // qpk
        h2c = grp[None, :] * rpg + rng.integers(0, rpg, size=(b, h))
    return (q, k, v, h2c.astype(np.int32), np.asarray(pos, np.int32))


CASES = {
    "mha": dict(),
    "mha_pos_below_tile": dict(pos=(3, 9)),
    "gqa_rpg2_vrep2": dict(r=8, h=8, kv_k=4, kv_v=4, rpg=2, pos=(17, 63)),
}


@pytest.mark.parametrize("ts", [64, 16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_decode_plain_matches_reference(rng, name, ts):
    kw = CASES[name]
    rpg = kw.get("rpg", 1)
    q, k, v, h2c, pos = _case(rng, **kw)
    if rpg == 1:
        assert len(set(h2c.ravel())) < q.shape[1]      # an empty rep
    j_args = [jnp.asarray(a) for a in (q, k, v, h2c, pos)]
    j_kernel = jck.chai_fused_decode(*j_args, reps_per_group=rpg, ts=ts)
    j_oracle = jref.chai_fused_decode_ref(*j_args, reps_per_group=rpg)
    before = dict(tck.LAUNCHES)
    t_out = tops.chai_decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, h2c, pos)),
        reps_per_group=rpg, ts=ts)
    assert tck.LAUNCHES == before         # the CPU path launches nothing
    assert t_out.dtype == torch.float32 and t_out.shape == j_kernel.shape
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_kernel), **TOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_oracle), **TOL)


def test_fused_decode_plain_bf16_kv(rng):
    """bf16 K/V: both sides upcast the same bf16 values."""
    q, k, v, h2c, pos = _case(rng)
    jk = jnp.asarray(k, jnp.bfloat16)
    jv = jnp.asarray(v, jnp.bfloat16)
    j_out = jref.chai_fused_decode_ref(jnp.asarray(q), jk, jv,
                                       jnp.asarray(h2c), jnp.asarray(pos))
    tk = torch.from_numpy(k).to(torch.bfloat16)
    tv = torch.from_numpy(v).to(torch.bfloat16)
    t_out = tref.chai_fused_decode_ref(torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(h2c),
                                       torch.from_numpy(pos))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_tile_size_rule_matches_reference():
    from repro.core.chai_attention import _dense_ts
    for decode_ts, s in ((16, 64), (16, 40), (0, 64), (128, 64), (64, 64)):
        want = _dense_ts(decode_ts, s)
        want = min(want, s) if s % min(want, s) == 0 else s
        assert tck.fused_tile_size(decode_ts, s) == want, (decode_ts, s)


@pytest.mark.parametrize("flag", [
    dict(softcap=30.0), dict(emit_state=True), dict(share_values=True),
    dict(k_scale="scale"), dict(v_scale="scale")])
def test_kernel_path_refuses_unported_flags(flag):
    """A non-CPU tensor goes to the kernel, which raises on what it does
    not carry — never to the plain version."""
    meta = dict(device="meta")
    args = (torch.empty(2, 5, 16, **meta), torch.empty(2, 5, 64, 16, **meta),
            torch.empty(2, 8, 64, 16, **meta),
            torch.empty(2, 8, dtype=torch.int32, **meta),
            torch.empty(2, dtype=torch.int32, **meta))
    flag = {n: (torch.empty(2, 5, 64, **meta) if v == "scale" else v)
            for n, v in flag.items()}
    before = dict(tck.LAUNCHES)
    with pytest.raises(NotImplementedError):
        tops.chai_decode_attention(*args, **flag)
    with pytest.raises(ValueError, match="CUDA"):
        tops.chai_decode_attention(*args)
    assert tck.LAUNCHES == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("chai_fused_decode")
