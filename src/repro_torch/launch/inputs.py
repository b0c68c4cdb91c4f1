"""Input structs for every (arch x shape) dry-run cell: (tree of
``Struct``, tree of ``Ax``), no allocation. Frontend-stub archs
(musicgen, internvl2) take precomputed frame / patch embeddings."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.sharding.rules import Ax, Struct


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend != "none":
        return ({"embeddings": Struct((b, t, cfg.d_model), torch.bfloat16),
                 "labels": Struct((b, t), torch.int32)},
                {"embeddings": Ax("batch", None, "embed"),
                 "labels": Ax("batch", None)})
    return ({"tokens": Struct((b, t), torch.int32),
             "labels": Struct((b, t), torch.int32)},
            {"tokens": Ax("batch", None), "labels": Ax("batch", None)})


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig):
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend != "none":
        return ({"embeddings": Struct((b, t, cfg.d_model), torch.bfloat16)},
                {"embeddings": Ax("batch", None, "embed")})
    return ({"tokens": Struct((b, t), torch.int32)},
            {"tokens": Ax("batch", None)})


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig):
    b = shape.global_batch
    if cfg.frontend != "none":
        return ({"embeddings": Struct((b, cfg.d_model), torch.bfloat16)},
                {"embeddings": Ax("batch", "embed")})
    return ({"tokens": Struct((b,), torch.int32)}, {"tokens": Ax("batch")})
