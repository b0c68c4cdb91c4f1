"""Per-arch smoke tests of the port, in the shape of the JAX package's
``tests/test_arch_smoke.py``, on the CPU.

* Every arch the port registers, reduced, fp32, the port's seeded
  ``init_params``: a forward pass (float embeddings on a frontend arch)
  and one decode step, shapes and finite values; one train step, its
  loss and grad norm finite and some leaf moved.
* Every full config constructs: ``param_count`` equals the reference's
  and lies within the reference test's +-50% of the nominal size, the
  CHAI cluster counts fall with depth, and a MoE config reads fewer
  parameters a token than it holds.
* The recurrent archs, recurrentgemma-9b (RG-LRU and local layers) and
  rwkv6-1.6b (RWKV layers): their decode state has the reference's
  leaves, shapes and dtypes at full width, and a prefill followed by a
  decode step continues the sequence (the step's logits are those of one
  forward over the longer prompt).
* ``params_from_numpy`` carries the new groups (``attn.q_norm`` /
  ``k_norm``, the ``moe`` group with its shared experts, the dense
  ``ffn`` group over the dense-FFN layers only, ``frontend.adapter``,
  ``rglru``, ``rwkv``) leaf by leaf, bf16 bits included.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.optim import adamw as tadamw
from repro_torch.weights import params_from_numpy

PORTED = list_configs()
NEW = ("gemma3-4b", "deepseek-moe-16b", "qwen3-moe-30b-a3b", "internvl2-76b",
       "musicgen-large", "recurrentgemma-9b", "rwkv6-1.6b")
RECURRENT = ("recurrentgemma-9b", "rwkv6-1.6b")
# the reference test's nominal sizes (tests/test_arch_smoke.py)
NOMINAL = {"nemotron-4-15b": 15e9, "gemma2-9b": 9e9, "gemma3-4b": 4e9,
           "h2o-danube-1.8b": 1.8e9, "qwen3-moe-30b-a3b": 30e9,
           "deepseek-moe-16b": 16e9, "musicgen-large": 3.3e9,
           "internvl2-76b": 76e9, "chai-llama-7b": 7e9,
           "recurrentgemma-9b": 9e9, "rwkv6-1.6b": 1.6e9}


def _reduced(arch):
    return reduced(get_config(arch)).replace(dtype="float32")


def test_port_registers_the_attention_archs():
    assert set(PORTED) == set(NEW) | {"chai-llama-7b", "nemotron-4-15b",
                                      "gemma2-9b", "h2o-danube-1.8b"}


@pytest.mark.parametrize("arch", PORTED)
def test_forward_shapes_and_finite(arch):
    cfg = _reduced(arch)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    b, t = 2, 16
    if cfg.frontend != "none":
        x = torch.from_numpy(rng.normal(size=(b, t, cfg.d_model)).astype(
            np.float32))
    else:
        x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)))
    logits, _ = ttfm.forward_fullseq(params, cfg, x)
    assert logits.shape == (b, t, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch


@pytest.mark.parametrize("arch", PORTED)
def test_train_step_no_nans(arch):
    """One train step (the fused ``make_train_step``, no remat) of the
    reduced fp32 arch from the port's seeded weights: the loss and the
    grad norm finite, the optimizer at step 1, some leaf moved."""
    cfg = _reduced(arch)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    b, t = 2, 16
    batch = {"labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, t)))}
    if cfg.frontend != "none":
        batch["embeddings"] = torch.from_numpy(
            rng.normal(size=(b, t, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                        (b, t)))
    step = tsteps.make_train_step(cfg, remat=False)
    params2, opt2, metrics = step(params, tadamw.init(params), batch)
    assert np.isfinite(float(metrics["loss"])), arch
    assert np.isfinite(float(metrics["grad_norm"])), arch
    assert int(opt2.step) == 1
    assert any(not torch.allclose(a, b_) for a, b_ in zip(
        tadamw.tree_leaves(params), tadamw.tree_leaves(params2))), arch


@pytest.mark.parametrize("arch", PORTED)
def test_decode_step_runs(arch):
    cfg = _reduced(arch)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    b, s = 2, 32
    state = ttfm.init_decode_state(cfg, b, s, "cpu")
    if cfg.frontend != "none":
        emb = torch.from_numpy(rng.normal(size=(b, cfg.d_model)).astype(
            np.float32))
        logits, st = ttfm.decode_step(params, cfg, None, state,
                                      embeddings=emb)
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b,)))
        logits, st = ttfm.decode_step(params, cfg, toks, state)
    assert logits.shape == (b, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), arch
    assert int(st["pos"][0]) == 1


def test_all_full_configs_construct():
    for name in PORTED:
        cfg, jcfg = get_config(name), jget_config(name)
        n = cfg.param_count()
        assert n == jcfg.param_count(), name
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        assert 0.5 * NOMINAL[name] < n < 1.5 * NOMINAL[name], (name, n)
        counts = cfg.chai_cluster_counts()
        assert counts == jcfg.chai_cluster_counts()
        assert len(counts) == cfg.n_attn_layers
        assert all(1 <= k <= cfg.n_heads for k in counts)
        if cfg.n_attn_layers:
            assert counts[-1] <= counts[0]
        if cfg.family == "moe":
            assert cfg.active_param_count() < cfg.param_count()
            assert cfg.n_moe_ffn + cfg.n_dense_ffn == cfg.n_layers
    assert get_config("gemma3-4b").head_dim == 320
    assert get_config("deepseek-moe-16b").n_dense_ffn == 1
    assert get_config("qwen3-moe-30b-a3b").n_dense_ffn == 0
    rg, rw = get_config("recurrentgemma-9b"), get_config("rwkv6-1.6b")
    assert (rg.n_attn_layers, rg.n_rec_layers, rg.n_global_layers) == (12, 26,
                                                                       0)
    assert (rw.n_attn_layers, rw.n_rwkv_layers, rw.chai.enabled) == (0, 24,
                                                                     False)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_state_matches_reference(arch):
    """The decode state at full width, bf16: the reference's leaves,
    shapes and dtypes (the recurrent state in the model dtype), nothing
    allocated."""
    want = jtfm.decode_state_structs(jget_config(arch), 4, 1024)[0]
    got = ttfm.decode_state_shapes(get_config(arch), 4, 1024)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
        k: (tuple(shape), str(dt).replace("torch.", ""))
        for k, (shape, dt) in got.items()}
    assert any(k.startswith(("rg_", "rwkv_")) for k in got)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_prefill_then_decode_continues(arch):
    """A prefill of 15 tokens into a decode state, then a decode step on
    the 16th: the step's logits equal the last position's of one forward
    over all 16, and ``pos`` is 16."""
    cfg = _reduced(arch)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    whole, _ = ttfm.forward_fullseq(params, cfg, toks)
    state = ttfm.init_decode_state(cfg, 2, 32, "cpu")
    _, state = ttfm.forward_fullseq(params, cfg, toks[:, :15], state=state,
                                    logits_slice="last")
    logits, state = ttfm.decode_step(params, cfg, toks[:, 15], state)
    torch.testing.assert_close(logits, whole[:, -1], atol=1e-4, rtol=1e-4)
    assert state["pos"].tolist() == [16, 16]


@pytest.mark.parametrize("arch", NEW)
def test_weights_carry_leaf_by_leaf(arch):
    """The reference's bf16 tree crosses leaf by leaf, bits unchanged: the
    port's ``param_table`` names the same groups and leaves with the same
    shapes."""
    jcfg = jreduced(jget_config(arch), n_layers=3, dtype="bfloat16")
    tcfg = reduced(get_config(arch), n_layers=3, dtype="bfloat16")
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(tree, device="cpu")
    table = ttfm.param_table(tcfg)
    assert {g: set(grp) for g, grp in table.items()} == {
        g: set(grp) for g, grp in jparams.items()}
    for g, grp in table.items():
        for n, (shape, _) in grp.items():
            got = tparams[g][n]
            assert got.dtype == torch.bfloat16
            assert tuple(got.shape) == shape == jparams[g][n].shape
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          tree[g][n].view(np.int16))
    if tcfg.qk_norm:
        assert table["attn"]["q_norm"][0] == (tcfg.n_attn_layers,
                                              tcfg.head_dim)
    if tcfg.n_moe_ffn:
        assert table["moe"]["router"][0][0] == tcfg.n_moe_ffn
        assert ("ffn" in table) == (tcfg.n_dense_ffn > 0)
    if tcfg.frontend != "none":
        assert table["frontend"]["adapter"][0] == (tcfg.d_model,) * 2
