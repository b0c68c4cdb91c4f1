"""Gemma-2 9B [arXiv:2408.00118]: local+global alternating, logit softcaps.

The reference's configuration, field for field: head_dim is derived as
d_model // n_heads = 224 (the published model's is 256; the port is held
to the reference's model). Even layers are local (a ring of the last
4096 positions), odd layers global; attention scores are capped at 50
and the final logits at 30 (tanh softcaps).
"""
from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, CHAIConfig,
                                      ModelConfig, register)

_LAYERS = tuple(ATTN_LOCAL if i % 2 == 0 else ATTN_GLOBAL for i in range(42))

CONFIG = register(ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    layer_types=_LAYERS,
    window_size=4096,
    activation="gelu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
    chai=CHAIConfig(enabled=True),
))
