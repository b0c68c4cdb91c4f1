"""DeepSeekMoE 16B [arXiv:2401.06066]: 2 shared + 64 routed top-6, fine-grained.

Layer 0 uses a dense FFN (as in the released model); the other 27 layers
are MoE. n_kv_heads == n_heads == 16, so MHA: CHAI's K-cache saving
applies fully.
"""
from repro_torch.configs.base import (FFN_DENSE, FFN_MOE, CHAIConfig,
                                      ModelConfig, register)

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                      # dense layer-0 FFN width
    vocab_size=102400,
    ffn_types=(FFN_DENSE,) + (FFN_MOE,) * 27,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    activation="silu",
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
