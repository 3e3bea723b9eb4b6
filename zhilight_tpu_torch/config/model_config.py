"""Typed model configuration (copy of ``zhilight_tpu/config/model_config.py``
with the dtype map in torch dtypes).

Covers the full config surface of the reference engine's ``model::ModelConfig`` /
``RopeConfig`` (reference: src/model/model_config.hpp:9-132) — LLaMA-family dense
models, MoE (Mixtral / Qwen-MoE / DeepSeek), MLA (DeepSeek-V2/V3), plus the
Cohere / MiniCPM ("cpm_dragonfly") specializations — as frozen dataclasses that
are hashable.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

__all__ = ["RopeConfig", "MoEConfig", "MLAConfig", "ModelConfig"]


def _dtype_from_str(name: str):
    return {
        "bfloat16": torch.bfloat16,
        "bf16": torch.bfloat16,
        "float16": torch.float16,
        "half": torch.float16,
        "float32": torch.float32,
        "float": torch.float32,
    }[name]


@dataclass(frozen=True)
class RopeConfig:
    """Rotary-position-embedding scaling configuration.

    Mirrors the capability set of the reference ``RopeConfig``
    (src/model/model_config.hpp:9-25): default / linear / dynamic-NTK / YaRN
    (incl. DeepSeek mscale) / Llama-3 low-high-freq variants, neox vs
    interleaved rotation style, and m-rope sections for multimodal models.
    """

    type: str = "default"  # default | linear | dynamic | yarn | llama3 | mrope
    factor: float = 1.0
    attn_factor: float = 1.0
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.0
    mscale_all_dim: float = 0.0
    original_max_position: int = 0
    neox_style: bool = True
    section: Tuple[int, ...] = ()
    # Llama-3 style frequency-band scaling
    low_freq_factor: float = 0.0
    high_freq_factor: float = 0.0


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts routing configuration.

    Capability parity with reference MoE fields (src/model/model_config.hpp:52-63)
    and the FeedForward MoE impls (src/nn/feedforward/feedforward.cpp:251-267):
    greedy / group_limited_greedy / noaux_tc top-k methods, softmax or sigmoid
    scoring, shared experts, dense first-k layers, routed scaling.
    """

    num_experts: int = 0
    top_k: int = 2
    intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    # qwen2-moe style gate on the shared expert output
    shared_expert_gate: bool = False
    norm_topk_prob: bool = True
    first_k_dense_replace: int = 0
    routed_scaling_factor: float = 1.0
    n_group: int = 1
    topk_group: int = 1
    scoring_func: str = "softmax"  # softmax | sigmoid
    topk_method: str = "greedy"  # greedy | group_limited_greedy | noaux_tc
    # every-N sparse layers (Deepseek V2-lite uses moe_layer_freq == 1)
    moe_layer_freq: int = 1

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3) configuration.

    Parity: reference MLA fields (src/model/model_config.hpp:66-71) and
    src/nn/attention/multi_head_latent_attention.cpp.
    """

    q_lora_rank: int = 0  # 0 => no q compression (V2-Lite)
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Per-token compressed-KV cache width (latent + rope key)."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for every supported model family.

    The single source of truth flowing through model building, weight loading,
    sharding and the scheduler (replaces reference src/model/model_config.hpp:27-132).
    """

    model_type: str = "llama"
    num_layers: int = 32
    dim_model: int = 4096
    num_heads: int = 32
    dim_head: int = 128
    dim_ff: int = 11008
    vocab_size: int = 32000
    eps: float = 1e-6
    num_kv_heads: int = -1
    dtype: str = "bfloat16"

    pos_bias_type: str = "rotary"
    activate_fn: str = "silu"
    tie_lm_head: bool = False
    max_position_embeddings: int = 8192
    rope_theta: float = 10000.0
    rope: RopeConfig = field(default_factory=RopeConfig)

    # qkv/o biases (qwen2 uses attn bias, llama none)
    attn_bias: bool = False
    ff_bias: bool = False

    # qk-norm: per-head RMS norm of q/k after projection (qwen3) or
    # full layernorm (cohere use_qk_norm)
    qk_norm: bool = False

    # MiniCPM ("cpm_dragonfly") specialties — reference llama.cpp:11-34
    scale_emb: float = 1.0
    scale_depth: float = 1.0
    dim_model_base: int = 0

    # Cohere specialties — reference llama.cpp:36-56
    logit_scale: float = 1.0
    rms_norm: bool = True  # cohere uses non-RMS LayerNorm
    parallel_residual: bool = False  # cohere: attn & ff in parallel off one LN

    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)

    # sliding-window attention (mistral); 0 = disabled
    sliding_window: int = 0

    def __post_init__(self):
        if self.num_kv_heads < 0:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # -- derived ----------------------------------------------------------
    @property
    def torch_dtype(self) -> torch.dtype:
        return _dtype_from_str(self.dtype)

    @property
    def kv_dim(self) -> int:
        if self.mla.enabled:
            return self.mla.latent_dim
        return self.num_kv_heads * self.dim_head

    def is_moe_layer(self, layer_idx: int) -> bool:
        m = self.moe
        if not m.enabled:
            return False
        if layer_idx < m.first_k_dense_replace:
            return False
        return (layer_idx % max(m.moe_layer_freq, 1)) == 0 or m.moe_layer_freq <= 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # rough parameter-count estimate used for memory budgeting
    def approx_param_count(self) -> int:
        d, l = self.dim_model, self.num_layers
        attn = d * self.num_heads * self.dim_head + 2 * d * self.num_kv_heads * self.dim_head + self.num_heads * self.dim_head * d
        if self.mla.enabled:
            mla = self.mla
            q_in = mla.q_lora_rank if mla.q_lora_rank else d
            attn = d * (mla.q_lora_rank or 0) + q_in * self.num_heads * mla.qk_head_dim
            attn += d * mla.latent_dim + mla.kv_lora_rank * self.num_heads * (mla.qk_nope_head_dim + mla.v_head_dim)
            attn += self.num_heads * mla.v_head_dim * d
        if self.moe.enabled:
            ff_dense = 3 * d * self.dim_ff
            ff_moe = self.moe.num_experts * 3 * d * self.moe.intermediate_size
            ff_moe += 3 * d * self.moe.shared_expert_intermediate_size
            n_dense = min(self.moe.first_k_dense_replace, l)
            ff_total = n_dense * ff_dense + (l - n_dense) * ff_moe
        else:
            ff_total = l * 3 * d * self.dim_ff
        emb = self.vocab_size * d * (1 if self.tie_lm_head else 2)
        return l * attn + ff_total + emb
