"""Gemma-3 4B [hf:google/gemma-3]: 5:1 local:global, qk_norm, 128k context.

The reference's configuration, field for field: head_dim is derived as
d_model // n_heads = 320 (the published model's is 256; the port is held
to the reference's model), so the decode kernels run their wide-head
instances on the global layers. 34 layers: five full patterns of five
local (a ring of the last 1024 positions) and one global layer, then
four local ones; q and k are RMS-normed per head before RoPE.
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, CHAIConfig,
                                      ModelConfig, register)

_LAYERS = tuple(ATTN_GLOBAL if (i % 6) == 5 else ATTN_LOCAL for i in range(34))

CONFIG = register(ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab_size=262144,
    layer_types=_LAYERS,
    window_size=1024,
    activation="gelu",
    qk_norm=True,
    rope_theta=1000000.0,        # long-context rope base
    chai=CHAIConfig(enabled=True),
))
