"""Nemotron-4 15B [arXiv:2402.16819]: dense GQA, squared-ReLU MLP.

48 query heads over 8 KV heads (6 per group): CHAI clusters within each
KV group (block-diagonal membership) and keeps the per-group K cache, so
the saving is compute only.
"""
from repro_torch.configs.base import CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    activation="relu2",          # squared ReLU
    gated_mlp=False,             # nemotron MLP: up + down only
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
