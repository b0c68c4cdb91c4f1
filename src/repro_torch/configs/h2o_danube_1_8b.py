"""H2O-Danube 1.8B [arXiv:2401.16818]: llama+mistral mix, sliding-window.

Every layer is local (mistral-style sliding-window attention over a ring
of the last 4096 positions); 32 query heads over 8 KV heads, head_dim 80.
"""
from repro_torch.configs.base import (ATTN_LOCAL, CHAIConfig, ModelConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    layer_types=(ATTN_LOCAL,) * 24,   # mistral-style SWA
    window_size=4096,
    activation="silu",
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
