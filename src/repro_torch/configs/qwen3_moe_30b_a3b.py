"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8.

Every layer is MoE, so the dense-FFN group is empty; GQA 32/4 (CHAI
clusters within each KV group) with q and k RMS-normed per head.
"""
from repro_torch.configs.base import CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    chai=CHAIConfig(enabled=True),
))
