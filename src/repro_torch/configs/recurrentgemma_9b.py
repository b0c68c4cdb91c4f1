"""RecurrentGemma 9B [arXiv:2402.19427]: RG-LRU + local attention, 1:2.

The reference's configuration, field for field. Pattern: (recurrent,
recurrent, local attention) repeated; 38 layers = 12 full patterns + 2
recurrent, so the attention layers are 2, 5, ..., 35. MQA (1 KV head),
a ring of the last 2048 positions, no global layer.
"""
from repro_torch.configs.base import (ATTN_LOCAL, RGLRU, CHAIConfig,
                                      ModelConfig, register)

_LAYERS = tuple(ATTN_LOCAL if (i % 3) == 2 else RGLRU for i in range(38))

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    layer_types=_LAYERS,
    window_size=2048,
    rnn_width=4096,
    conv_width=4,
    activation="gelu",
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
