"""Modality frontend stubs: the audio and vision frontends hand over
precomputed frame / patch embeddings, and only the linear adapter into
the model width is real (the reference's ``models/frontends.py``)."""
from __future__ import annotations

import torch


def adapt(embeddings, p):
    """embeddings: (B, T, d_in) precomputed frontend outputs -> (B, T, d),
    through ``p["adapter"]`` (d_in, d)."""
    return torch.einsum("btd,de->bte", embeddings, p["adapter"])
