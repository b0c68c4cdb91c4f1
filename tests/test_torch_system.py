"""System-level test of the port (the reference's ``tests/test_system.py``
on ``repro_torch``): train a tiny LM with the port's trainer on the
synthetic Markov corpus, run the offline elbow on its activations, then
serve it through the port's engine. On a trained model CHAI decode must
track MHA decode closely (greedy tokens mostly equal), and round-robin
head clustering with the same k must not track it better.

Also: ``clustering.shared_ctx`` (the round-robin membership) equals the
reference's.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import clustering as jclust
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import clustering
from repro_torch.data.pipeline import DataConfig, calibration_batches
from repro_torch.launch.offline_clustering import offline_phase
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.mark.parametrize("arch", ["chai-llama-7b", "nemotron-4-15b"])
def test_shared_ctx_matches_reference(arch):
    cfg = reduced(get_config(arch), n_heads=8).with_chai(enabled=True)
    jcfg = jreduced(jget_config(arch), n_heads=8).with_chai(enabled=True)
    want = jax.tree.map(np.asarray, jclust.shared_ctx(jcfg))
    got = clustering.shared_ctx(cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = reduced(get_config("chai-llama-7b"), n_layers=2, d_model=64,
                  n_heads=8, d_ff=128, vocab=128).replace(dtype="float32")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    tr = Trainer(cfg, data, TrainerConfig(
        total_steps=60, ckpt_every=1000, log_every=1000,
        ckpt_dir=str(tmp_path_factory.mktemp("ck")),
        lr_kw=dict(peak=3e-3, warmup=6, total=60)), device="cpu")
    state, metrics = tr.run()
    assert float(metrics["loss"]) < 4.0   # well under ln(128) = 4.85
    return cfg, state["params"], tr.pipe


def _served(cfg, params, pipe, *, use_chai, identify=None, n_req=4,
            max_new=16):
    eng = ServingEngine(cfg, params, EngineConfig(
        batch_slots=2, max_seq=128, use_chai=use_chai), device="cpu")
    if identify is not None:
        eng._identify = identify
    for i in range(n_req):
        prompt = pipe.batch(100 + i)["tokens"][0, :24]
        eng.submit(prompt, max_new_tokens=max_new, uid=i)
    return {r.uid: r.generated for r in eng.run()}


def _agreement(ref, gen):
    return float(np.mean([np.mean(np.asarray(ref[u]) == np.asarray(gen[u]))
                          for u in ref]))


@pytest.mark.slow
def test_offline_elbow_on_trained_activations(trained):
    """The offline phase end to end on the trained model: per-head WARMUP
    scores on the calibration corpus, an elbow-selected k per layer."""
    cfg, params, _ = trained
    out = offline_phase(params, cfg, calibration_batches(
        cfg.vocab_size, 32, n_samples=8), device="cpu")
    assert out["features"].shape[:2] == (cfg.n_attn_layers, cfg.n_heads)
    assert len(out["counts"]) == cfg.n_attn_layers
    assert all(1 <= k <= cfg.n_heads for k in out["counts"])
    assert np.isfinite(out["curves"]).all()


@pytest.mark.slow
def test_chai_tracks_mha_generations(trained):
    cfg, params, pipe = trained
    mha = _served(cfg, params, pipe, use_chai=False)
    chai = _served(cfg.with_chai(enabled=True, cluster_counts=(6, 6)),
                   params, pipe, use_chai=True)
    # paper: <= 3.2% accuracy deviation; tiny-model greedy-token proxy
    assert _agreement(mha, chai) > 0.7


@pytest.mark.slow
def test_chai_beats_random_clustering(trained):
    """CHAI's correlation clustering tracks MHA at least as well as a
    round-robin membership with the same k (paper Fig 1's baseline)."""
    cfg, params, pipe = trained
    mha = _served(cfg, params, pipe, use_chai=False)
    cfg_chai = cfg.with_chai(enabled=True, cluster_counts=(4, 4))
    chai = _served(cfg_chai, params, pipe, use_chai=True)
    rand = clustering.shared_ctx(cfg_chai)
    rr = _served(cfg_chai, params, pipe, use_chai=True,
                 identify=lambda sc: {k: v[:, None] for k, v in
                                      rand.items()})
    assert _agreement(mha, chai) >= _agreement(mha, rr) - 0.05
