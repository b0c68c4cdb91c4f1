"""Shared low-level layers: norms, rotary embeddings, softcap, activations."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, scale, eps=1e-6):
    """``(1 + scale)`` RMSNorm in fp32, cast back to the input dtype."""
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def softcap(x, cap):
    """Gemma-2 style tanh softcap; identity when cap <= 0."""
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


def activation_fn(name):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":  # squared ReLU (nemotron)
        return lambda x: F.relu(x).square()
    raise ValueError(name)


# ---------------------------------------------------------------- rotary ----
def rope_freqs(head_dim, theta, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # (head_dim/2,)


def apply_rope(x, positions, theta):
    """LLaMA-style half-rotation RoPE in fp32, cast back to x's dtype.

    x: (..., T, n_heads, head_dim); positions: broadcastable to (..., T).
    """
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., T, hd/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table, tokens):
    return table[tokens]


def unembed(x, w, softcap_value=0.0):
    """Logits are fp32 whatever the model dtype."""
    logits = (x @ w).float()
    return softcap(logits, softcap_value)
