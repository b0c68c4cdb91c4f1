"""MusicGen-Large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

True MHA (kv == heads == 32): the paper's exact regime, CHAI drops the
K-cache rows of non-representative heads. The EnCodec frontend is a
stub: precomputed frame embeddings enter through the linear adapter
(``models.frontends.adapt``); tokens take the embedding table.
"""
from repro_torch.configs.base import CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    frontend="audio",
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
