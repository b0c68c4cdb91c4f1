"""Dense gated MLP (silu/gelu/relu2)."""
from __future__ import annotations

import torch

from repro_torch.models.layers import activation_fn


def dense_ffn(x, p, cfg):
    """x: (B, T, d); gated (w_gate/w_up/w_down) or 2-matrix (w_up/w_down)."""
    act = activation_fn(cfg.activation)
    u = torch.einsum("btd,df->btf", x, p["w_up"])
    if cfg.gated_mlp:
        g = torch.einsum("btd,df->btf", x, p["w_gate"])
        h = act(g) * u
    else:
        h = act(u)
    return torch.einsum("btf,fd->btd", h, p["w_down"])
