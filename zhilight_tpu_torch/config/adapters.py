"""HF ``config.json`` → :class:`ModelConfig` adaptation for every supported family.

Parity target: zhilight/config/adapter.py + per-arch adapters
(llama_adapter.py, qwen2_adapter.py, qwen3_adapter.py, deepseek_adapter.py,
cohere_adapter.py) and ``LLaMALoader.load_llama_config``. The reference
adapters mostly toggle CUDA perf env-flags (DUAL_STREAM, HOST_REDUCE, ...)
that have no TPU analogue — XLA handles collective overlap — so here the
adapter's job is purely declarative config normalization.

Supported model_type values:
  llama, mistral, qwen2, qwen2_moe, qwen3, qwen3_moe, mixtral,
  deepseek_v2, deepseek_v3, cohere, cpm_dragonfly (MiniCPM), deepseek_vl_v2.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .model_config import MLAConfig, ModelConfig, MoEConfig, RopeConfig
from .quant_config import QuantConfig

__all__ = ["adapt_hf_config", "load_model_config", "ADAPTERS"]


def _rope_from_hf(cfg: dict) -> RopeConfig:
    rs = cfg.get("rope_scaling") or {}
    if not rs:
        return RopeConfig()
    rtype = rs.get("rope_type", rs.get("type", "default"))
    return RopeConfig(
        type=rtype,
        factor=float(rs.get("factor", 1.0)),
        attn_factor=float(rs.get("attn_factor", 1.0)),
        beta_fast=float(rs.get("beta_fast", 32.0)),
        beta_slow=float(rs.get("beta_slow", 1.0)),
        mscale=float(rs.get("mscale", 0.0)),
        mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
        original_max_position=int(
            rs.get("original_max_position_embeddings", cfg.get("max_position_embeddings", 0))
        ),
        neox_style=True,
        section=tuple(rs.get("mrope_section", ())),
        low_freq_factor=float(rs.get("low_freq_factor", 0.0)),
        high_freq_factor=float(rs.get("high_freq_factor", 0.0)),
    )


def _base_fields(cfg: dict) -> dict:
    num_heads = cfg["num_attention_heads"]
    dim_model = cfg["hidden_size"]
    return dict(
        model_type=cfg.get("model_type", "llama"),
        num_layers=cfg["num_hidden_layers"],
        dim_model=dim_model,
        num_heads=num_heads,
        dim_head=cfg.get("head_dim") or dim_model // num_heads,
        dim_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        eps=cfg.get("rms_norm_eps", cfg.get("layer_norm_eps", 1e-6)),
        num_kv_heads=cfg.get("num_key_value_heads", num_heads),
        dtype="bfloat16" if cfg.get("torch_dtype", "bfloat16") != "float16" else "float16",
        activate_fn=cfg.get("hidden_act", "silu"),
        tie_lm_head=cfg.get("tie_word_embeddings", False),
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rope_theta=float(cfg.get("rope_theta", 10000.0)),
        rope=_rope_from_hf(cfg),
    )


def _adapt_llama(cfg: dict) -> ModelConfig:
    return ModelConfig(**_base_fields(cfg))


def _adapt_mistral(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    return ModelConfig(**f, sliding_window=cfg.get("sliding_window") or 0)


def _adapt_qwen2(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    return ModelConfig(**f, attn_bias=True)


def _adapt_qwen2_moe(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    moe = MoEConfig(
        num_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"],
        intermediate_size=cfg["moe_intermediate_size"],
        shared_expert_intermediate_size=cfg.get("shared_expert_intermediate_size", 0),
        shared_expert_gate=True,
        norm_topk_prob=cfg.get("norm_topk_prob", False),
        moe_layer_freq=cfg.get("decoder_sparse_step", 1),
    )
    return ModelConfig(**f, attn_bias=True, moe=moe)


def _adapt_qwen3(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    return ModelConfig(**f, qk_norm=True)


def _adapt_qwen3_moe(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    moe = MoEConfig(
        num_experts=cfg["num_experts"],
        top_k=cfg["num_experts_per_tok"],
        intermediate_size=cfg["moe_intermediate_size"],
        norm_topk_prob=cfg.get("norm_topk_prob", True),
        moe_layer_freq=cfg.get("decoder_sparse_step", 1),
    )
    return ModelConfig(**f, qk_norm=True, moe=moe)


def _adapt_mixtral(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    moe = MoEConfig(
        num_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        intermediate_size=cfg["intermediate_size"],
        norm_topk_prob=True,
    )
    return ModelConfig(**f, moe=moe, sliding_window=cfg.get("sliding_window") or 0)


def _adapt_deepseek(cfg: dict) -> ModelConfig:
    """DeepSeek-V2/V3 (+R1): MLA attention, fine-grained MoE with shared experts.

    Parity: zhilight/config/deepseek_adapter.py:16-70 (minus CUDA env toggles:
    LATENT_CACHE/FlashMLA/ATTN_DATA_PARALLEL map to native engine options here).
    """
    f = _base_fields(cfg)
    mla = MLAConfig(
        q_lora_rank=cfg.get("q_lora_rank") or 0,
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"],
    )
    n_shared = cfg.get("n_shared_experts") or 0
    moe = MoEConfig(
        num_experts=cfg.get("n_routed_experts") or 0,
        top_k=cfg.get("num_experts_per_tok", 1),
        intermediate_size=cfg.get("moe_intermediate_size", 0),
        shared_expert_intermediate_size=n_shared * cfg.get("moe_intermediate_size", 0),
        norm_topk_prob=cfg.get("norm_topk_prob", False),
        first_k_dense_replace=cfg.get("first_k_dense_replace", 0),
        routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
        n_group=cfg.get("n_group", 1),
        topk_group=cfg.get("topk_group", 1),
        scoring_func=cfg.get("scoring_func", "softmax"),
        topk_method=cfg.get("topk_method", "greedy"),
        moe_layer_freq=cfg.get("moe_layer_freq", 1),
    )
    # MLA ignores GQA head grouping: kv is the shared latent
    f["dim_head"] = mla.qk_head_dim
    return ModelConfig(**f, mla=mla, moe=moe)


def _adapt_cohere(cfg: dict) -> ModelConfig:
    f = _base_fields(cfg)
    f["eps"] = cfg.get("layer_norm_eps", 1e-5)
    f["tie_lm_head"] = True  # cohere always ties lm_head (reference llama.cpp:44)
    return ModelConfig(
        **f,
        rms_norm=False,
        parallel_residual=True,
        logit_scale=float(cfg.get("logit_scale", 1.0)),
        qk_norm=cfg.get("use_qk_norm", False),
    )


def _adapt_minicpm(cfg: dict) -> ModelConfig:
    """MiniCPM ("cpm_dragonfly"): depth/width residual+embedding scaling.

    Parity: reference llama.cpp:11-34 (scale_emb, scale_depth/sqrt(num_layers),
    logits scaled by dim_model/dim_model_base).
    """
    f = _base_fields(cfg)
    # MiniCPM checkpoints omit tie_word_embeddings but always tie
    f["tie_lm_head"] = cfg.get("tie_word_embeddings", True)
    return ModelConfig(
        **f,
        scale_emb=float(cfg.get("scale_emb", 1.0)),
        scale_depth=float(cfg.get("scale_depth", 1.0)),
        dim_model_base=cfg.get("dim_model_base", 0),
    )


ADAPTERS = {
    "llama": _adapt_llama,
    "mistral": _adapt_mistral,
    "qwen2": _adapt_qwen2,
    "qwen2_moe": _adapt_qwen2_moe,
    "qwen3": _adapt_qwen3,
    "qwen3_moe": _adapt_qwen3_moe,
    "mixtral": _adapt_mixtral,
    "deepseek_v2": _adapt_deepseek,
    "deepseek_v3": _adapt_deepseek,
    "cohere": _adapt_cohere,
    "cpm_dragonfly": _adapt_minicpm,
    "minicpm": _adapt_minicpm,
}


def adapt_hf_config(cfg: dict) -> ModelConfig:
    model_type = cfg.get("model_type", "")
    if not model_type:
        archs = cfg.get("architectures") or [""]
        if "minicpm" in archs[0].lower():
            model_type = "cpm_dragonfly"
        else:
            model_type = "llama"
    if model_type == "deepseek_vl_v2":
        # multimodal wrapper: language config is nested (reference
        # zhilight/models/deepseek_vl_v2.py builds LLaMA from language_config)
        return _adapt_deepseek({**cfg["language_config"], "model_type": "deepseek_v2"})
    if model_type not in ADAPTERS:
        raise ValueError(f"unsupported model_type: {model_type!r}")
    return ADAPTERS[model_type](cfg)


def load_model_config(model_path: str):
    """Read ``config.json`` from a model directory.

    Returns (ModelConfig, QuantConfig, raw_hf_dict).
    """
    with open(os.path.join(model_path, "config.json")) as fh:
        cfg = json.load(fh)
    return adapt_hf_config(cfg), QuantConfig.from_hf_config(cfg), cfg
