"""repro_torch's model layers against the JAX package's, on the CPU.

Same inputs (numpy, from a seed) through both; fp32; atol = rtol = 1e-5
(the two frameworks sum in different orders, nothing else differs).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as ttfm

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def _cfgs(n_layers=1):
    return (jreduced(jget_config("chai-llama-7b"), n_layers=n_layers),
            reduced(get_config("chai-llama-7b"), n_layers=n_layers))


def _attn_params(rng, cfg):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": rng.normal(0, d ** -0.5, (d, h, hd)),
            "wk": rng.normal(0, d ** -0.5, (d, kv, hd)),
            "wv": rng.normal(0, d ** -0.5, (d, kv, hd)),
            "wo": rng.normal(0, (h * hd) ** -0.5, (h, hd, d))}


def _both(tree):
    f32 = {k: np.asarray(v, np.float32) for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in f32.items()},
            {k: torch.from_numpy(v) for k, v in f32.items()})


def test_config_copy_matches_reference():
    jc, tc = _cfgs(n_layers=4)
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab_size", "layer_types", "ffn_types", "dtype"):
        assert getattr(jc, name) == getattr(tc, name), name
    full_j, full_t = jget_config("chai-llama-7b"), get_config("chai-llama-7b")
    assert full_j.chai_cluster_counts() == full_t.chai_cluster_counts()
    assert full_t.k_max == 25 and full_t.head_dim == 128
    assert full_j.param_count() == full_t.param_count()


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rms_norm(rng, dtype):
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    s = rng.normal(0, 0.1, size=(64,)).astype(np.float32)
    if dtype == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
        jo = jlayers.rms_norm(jx, jnp.asarray(s), 1e-6).astype(jnp.float32)
        to = tlayers.rms_norm(tx, torch.from_numpy(s), 1e-6)
        assert to.dtype == torch.bfloat16
        # one bf16 ulp: the fp32 values agree within 1e-5 before the cast
        _close(to.float(), jo, atol=1e-2, rtol=8e-3)
    else:
        _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
               jlayers.rms_norm(jnp.asarray(x), jnp.asarray(s)))


def test_apply_rope_per_example_positions(rng):
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           atol=2e-5, rtol=1e-5)


def test_project_qkv(rng):
    jc, tc = _cfgs()
    jp, tp = _both(_attn_params(rng, jc))
    x = rng.normal(size=(2, 7, jc.d_model)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    jq = jattn.project_qkv(jnp.asarray(x), jp, jc, jnp.asarray(pos))
    tq = tattn.project_qkv(torch.from_numpy(x), tp, tc, torch.from_numpy(pos))
    for a, b in zip(tq, jq):
        _close(a, b)


@pytest.mark.parametrize("chunk,window", [(1024, 0), (8, 0), (8, 5)])
def test_attention_fullseq(rng, chunk, window):
    q = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    jo = jattn.attention_fullseq(*(jnp.asarray(a) for a in (q, k, v)),
                                 jnp.asarray(pos), jnp.asarray(pos),
                                 window=window, chunk=chunk)
    to = tattn.attention_fullseq(*(torch.from_numpy(a) for a in (q, k, v)),
                                 torch.from_numpy(pos), torch.from_numpy(pos),
                                 window=window, chunk=chunk)
    _close(to, jo)


def test_dense_ffn(rng):
    jc, tc = _cfgs()
    d, f = jc.d_model, jc.d_ff
    jp, tp = _both({"w_up": rng.normal(0, d ** -0.5, (d, f)),
                    "w_gate": rng.normal(0, d ** -0.5, (d, f)),
                    "w_down": rng.normal(0, f ** -0.5, (f, d))})
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    _close(tmlp.dense_ffn(torch.from_numpy(x), tp, tc),
           jmlp.dense_ffn(jnp.asarray(x), jp, jc))


def test_forward_fullseq_ragged_valid_len(rng):
    """Bucketed prefill with per-example ``valid_len``: last-real logits,
    ``pos`` and the written cache rows agree with the reference."""
    import jax
    from repro_torch.weights import params_from_numpy
    jc, tc = _cfgs(n_layers=2)
    jparams = jtfm.init_params(jc, jax.random.PRNGKey(3))
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    toks = rng.integers(0, jc.vocab_size, size=(3, 16)).astype(np.int32)
    vl = np.array([16, 9, 3], np.int32)
    jstate = jtfm.init_decode_state(jc, 3, 32)
    jl, jst, _ = jtfm.forward_fullseq(jparams, jc, jnp.asarray(toks),
                                      state=jstate, logits_slice="last",
                                      valid_len=jnp.asarray(vl))
    tstate = ttfm.init_decode_state(tc, 3, 32, "cpu")
    tl, tst = ttfm.forward_fullseq(tparams, tc, torch.from_numpy(toks),
                                   state=tstate, logits_slice="last",
                                   valid_len=torch.from_numpy(vl))
    _close(tl, jl, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))
    _close(tst["kg"], jst["kg"])
    _close(tst["vg"], jst["vg"])
