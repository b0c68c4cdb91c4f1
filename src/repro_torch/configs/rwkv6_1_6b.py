"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay.

The reference's configuration, field for field. CHAI does not apply (no
attention heads, no KV cache): the config leaves it off, and the engines
serve it with ``use_chai=False``.
"""
from repro_torch.configs.base import RWKV, CHAIConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=7168,
    vocab_size=65536,
    layer_types=(RWKV,) * 24,
    rwkv_head_dim=64,
    chai=CHAIConfig(enabled=False),
))
