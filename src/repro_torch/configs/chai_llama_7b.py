"""LLaMA-7B — the paper's primary evaluation model (Tables 2, Figs 1-13).

True MHA (32 Q = 32 KV heads): CHAI's full regime, including the clustered
K cache.
"""
from repro_torch.configs.base import CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="chai-llama-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    activation="silu",
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
