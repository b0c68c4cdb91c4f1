"""Model/arch configuration for the PyTorch port.

A copy of the reference package's ``configs/base.py`` (the port imports
nothing of it): ``CHAIConfig``, ``ModelConfig`` with the derived
properties the serving path reads, ``reduced`` for CPU-sized tests and
the ``register``/``get_config`` registry. Field names and defaults match
the reference so one configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

# Layer mixer kinds.
ATTN_GLOBAL = "attn_global"
ATTN_LOCAL = "attn_local"   # sliding-window / local attention
RGLRU = "rglru"             # RecurrentGemma recurrent block
RWKV = "rwkv"               # RWKV-6 time-mix

# FFN kinds.
FFN_DENSE = "dense"
FFN_MOE = "moe"


@dataclass(frozen=True)
class CHAIConfig:
    """CHAI (Clustered Head Attention) configuration.

    ``cluster_counts`` is the offline elbow-selected number of clusters per
    attention layer. ``k_max`` is the static width. ``warmup_tokens`` is the
    number of MHA decode steps observed before cluster-membership
    identification (paper: 5).
    """
    enabled: bool = False
    cluster_counts: tuple = ()
    cluster_fraction: float = 0.57
    warmup_tokens: int = 5
    kmeans_iters: int = 12
    feature_window: int = 256
    recluster_interval: int = 0
    share_values: bool = False


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | audio | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int                # query heads (0 => attention-free arch)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 => d_model // n_heads
    layer_types: tuple = ()     # per-layer mixer kind; default all ATTN_GLOBAL
    ffn_types: tuple = ()       # per-layer FFN kind; default all FFN_DENSE
    window_size: int = 4096
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    activation: str = "silu"    # silu | gelu | relu2
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qk_norm: bool = False
    rnn_width: int = 0
    conv_width: int = 4
    rwkv_head_dim: int = 64
    frontend: str = "none"
    tie_embeddings: bool = False
    kv_cache_dtype: str = ""    # "" = model dtype; "int8": codes + fp32 row scales
    chai: CHAIConfig = field(default_factory=CHAIConfig)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.layer_types:
            kind = RWKV if self.family == "ssm" else ATTN_GLOBAL
            object.__setattr__(self, "layer_types", (kind,) * self.n_layers)
        if not self.ffn_types:
            kind = FFN_MOE if self.n_experts > 0 else FFN_DENSE
            object.__setattr__(self, "ffn_types", (kind,) * self.n_layers)
        assert len(self.layer_types) == self.n_layers, self.name
        assert len(self.ffn_types) == self.n_layers, self.name
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ---- derived -----------------------------------------------------
    @property
    def attn_layer_ids(self):
        return tuple(i for i, t in enumerate(self.layer_types)
                     if t in (ATTN_GLOBAL, ATTN_LOCAL))

    @property
    def n_attn_layers(self):
        return len(self.attn_layer_ids)

    @property
    def n_global_layers(self):
        return sum(1 for t in self.layer_types if t == ATTN_GLOBAL)

    @property
    def n_local_layers(self):
        return sum(1 for t in self.layer_types if t == ATTN_LOCAL)

    @property
    def n_rec_layers(self):
        return sum(1 for t in self.layer_types if t == RGLRU)

    @property
    def n_rwkv_layers(self):
        return sum(1 for t in self.layer_types if t == RWKV)

    @property
    def n_rwkv_heads(self):
        return self.d_model // self.rwkv_head_dim

    @property
    def n_dense_ffn(self):
        return sum(1 for t in self.ffn_types if t == FFN_DENSE)

    @property
    def n_moe_ffn(self):
        return sum(1 for t in self.ffn_types if t == FFN_MOE)

    @property
    def q_per_kv(self):
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_mha(self):
        """True when every query head has its own K/V (paper's setting)."""
        return self.n_heads > 0 and self.n_heads == self.n_kv_heads

    def chai_cluster_counts(self):
        """Per-attention-layer cluster counts (static)."""
        n = self.n_attn_layers
        if n == 0:
            return ()
        if self.chai.cluster_counts:
            assert len(self.chai.cluster_counts) == n
            return tuple(self.chai.cluster_counts)
        # Fraction fallback with the paper's depth profile: early layers
        # keep more clusters; never below n_kv_heads for GQA.
        out = []
        for j in range(n):
            depth = j / max(n - 1, 1)
            f = min(1.0, self.chai.cluster_fraction * (1.35 - 0.7 * depth))
            k = max(1, math.ceil(f * self.n_heads))
            if self.n_kv_heads > 1 and self.n_heads != self.n_kv_heads:
                k = max(k, self.n_kv_heads)
            out.append(min(k, self.n_heads))
        return tuple(out)

    @property
    def k_max(self):
        counts = self.chai_cluster_counts()
        return max(counts) if counts else 0

    def with_chai(self, **kw):
        return dataclasses.replace(
            self, chai=dataclasses.replace(self.chai, **kw))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def param_count(self):
        """Analytic parameter count N, the reference's: embeddings once per
        table; per layer its mixer (attention; RG-LRU or RWKV by the
        reference's formulas), its FFN (dense, or the routed experts,
        the shared experts and the router) and two norms. Like the
        reference's it leaves out the ``q_norm`` / ``k_norm`` scales and
        the frontend adapter."""
        c = self
        n = c.vocab_size * c.d_model * (1 if c.tie_embeddings else 2)
        attn = (c.d_model * c.n_heads * c.head_dim
                + 2 * c.d_model * c.n_kv_heads * c.head_dim
                + c.n_heads * c.head_dim * c.d_model)
        dense_ffn = (3 if c.gated_mlp else 2) * c.d_model * c.d_ff
        moe_ffn = ((c.n_experts + c.n_shared_experts) * 3 * c.d_model
                   * c.moe_d_ff + c.d_model * c.n_experts)
        w = c.rnn_width
        rg = (2 * c.d_model * w + w * c.d_model + c.conv_width * w + 4 * w
              if c.n_rec_layers else 0)
        rwkv = (6 * c.d_model * c.d_model + 2 * c.d_model * c.d_ff
                if self.n_rwkv_layers else 0)
        for lt, ft in zip(c.layer_types, c.ffn_types):
            n += {RGLRU: rg, RWKV: rwkv}.get(lt, attn)
            if lt != RWKV:   # rwkv counts its channel mix as its FFN
                n += dense_ffn if ft == FFN_DENSE else moe_ffn
            n += 2 * c.d_model
        return n

    def active_param_count(self):
        """Parameters a token reads (MoE: the routed top-k and the shared
        experts only), the reference's count."""
        full = self.param_count()
        if self.n_moe_ffn == 0:
            return full
        per = 3 * self.d_model * self.moe_d_ff * self.n_moe_ffn
        return full - self.n_experts * per + self.top_k * per


# ----------------------------------------------------------------------
# Shapes assigned to the LM-transformer pool (the dry-run's cells).
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, n_layers=None, d_model=64, n_heads=None,
            d_ff=128, vocab=256, window=16, n_experts=8, top_k=2,
            moe_d_ff=32, rnn_width=64, dtype="float32") -> ModelConfig:
    """Scaled-down same-family config for CPU tests (the reference's
    ``reduced``, field for field)."""
    if n_layers is None:
        n_layers = min(cfg.n_layers, 4)
    lt = list((cfg.layer_types * n_layers)[:n_layers])
    for j, kind in enumerate(dict.fromkeys(cfg.layer_types)):
        if kind not in lt and j < n_layers:
            lt[j] = kind
    ft = list((cfg.ffn_types * n_layers)[:n_layers])
    for kind in dict.fromkeys(cfg.ffn_types):
        if kind not in ft:
            ft[-1] = kind
    if n_heads is None:
        n_heads = max(4, min(8, cfg.n_heads)) if cfg.n_heads else 0
    n_kv = max(1, n_heads // max(cfg.q_per_kv, 1)) if cfg.n_heads else 0
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // max(n_heads, 1) if n_heads else 0,
        d_ff=d_ff,
        vocab_size=vocab,
        layer_types=tuple(lt),
        ffn_types=tuple(ft),
        window_size=window,
        n_experts=n_experts if cfg.n_experts else 0,
        top_k=min(top_k, n_experts) if cfg.n_experts else 0,
        moe_d_ff=moe_d_ff if cfg.n_experts else 0,
        rnn_width=rnn_width if cfg.n_rec_layers else 0,
        rwkv_head_dim=16,
        dtype=dtype,
    )


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    from repro_torch.configs import (  # noqa: F401
        chai_llama_7b, deepseek_moe_16b, gemma2_9b, gemma3_4b,
        h2o_danube_1_8b, internvl2_76b, musicgen_large, nemotron_4_15b,
        qwen3_moe_30b_a3b, recurrentgemma_9b, rwkv6_1_6b)
