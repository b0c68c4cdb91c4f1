"""InternVL2-76B [arXiv:2404.16821]: InternViT + InternLM2 backbone.

The LM transformer backbone only; the InternViT frontend is a stub whose
precomputed patch embeddings (B, T, d) enter through the linear adapter
(``models.frontends.adapt``). GQA 64/8.
"""
from repro_torch.configs.base import CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    activation="silu",
    frontend="vision",
    rope_theta=1000000.0,
    chai=CHAIConfig(enabled=True),
))
