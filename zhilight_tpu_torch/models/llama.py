"""LLaMA-family dense transformer (counterpart of ``zhilight_tpu/models/llama.py``).

Covers the dense architectures of the reference: llama / mistral / qwen2
(attention bias) / qwen3 (qk-norm) / cohere (parallel residual, LayerNorm,
logit_scale) / MiniCPM "cpm_dragonfly" (scale_emb, depth-scaled residual,
dim_model_base logit scaling, tied head). Parameters are the reference's
nested dict layout holding torch tensors; forward functions run eagerly and
write the paged KV pool in place.

Attention goes through the head-major packed pool: every layer writes its
new K|V rows (``ops.cuda.kv_write``), then prefill chunks (single or packed)
run ``ops.cuda.prefill_attention`` and decode steps
``ops.cuda.attn_headmajor``. Those wrappers launch the CUDA kernels for CUDA
tensors and run their plain PyTorch versions for CPU tensors. MoE, MLA,
window side-KV and fused write+attend are later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..config.model_config import ModelConfig
from ..kvcache.paged import KVCache, write_kv
from ..ops.activations import gated_act
from ..ops.cuda import attn_headmajor, prefill_attention
from ..ops.linear import linear
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import RopeTable, apply_rope_rot, build_rope_table
from .base import DecodeMeta, PackedPrefillMeta, PrefillMeta

__all__ = [
    "build_rope",
    "init_params",
    "param_count",
    "backbone",
    "forward_prefill",
    "forward_prefill_packed",
    "forward_decode",
    "get_logits",
]

Params = Dict[str, Any]


def build_rope(cfg: ModelConfig, max_model_len: int = 0) -> RopeTable:
    if cfg.mla.enabled:
        raise NotImplementedError("MLA models are not ported yet")
    return build_rope_table(
        cfg.dim_head, cfg.rope_theta, cfg.rope, cfg.max_position_embeddings, max_model_len
    )


def _norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.rms_norm:
        return rms_norm(x, p["w"], cfg.eps)
    return layer_norm(x, p["w"], cfg.eps)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project to q/k/v, from split or fused qkv weights."""
    T = x.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.dim_head
    if "qkv_proj" in p:
        q, k, v = torch.split(linear(p["qkv_proj"], x), [hq * d, hkv * d, hkv * d], dim=-1)
    else:
        q, k, v = linear(p["q_proj"], x), linear(p["k_proj"], x), linear(p["v_proj"], x)
    return q.reshape(T, hq, d), k.reshape(T, hkv, d), v.reshape(T, hkv, d)


def _maybe_qk_norm(p: Params, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor):
    if not cfg.qk_norm:
        return q, k
    norm = rms_norm if cfg.rms_norm else layer_norm  # qwen3 RMS / cohere LayerNorm
    return norm(q, p["q_norm"]["w"], cfg.eps), norm(k, p["k_norm"]["w"], cfg.eps)


def attention_layer(
    p: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    layer_idx: int,
    meta,
    mode: str,
    rot=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Standard / GQA attention over the paged pool: write this step's K|V
    rows, then attend (prefill chunk, packed chunks or decode step)."""
    n = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    q, k = _maybe_qk_norm(p, cfg, q, k)
    cos_f, sin_f = rot if rot is not None else rope.rot_values(positions)
    q = apply_rope_rot(q, cos_f, sin_f, rope.neox_style)
    k = apply_rope_rot(k, cos_f, sin_f, rope.neox_style)
    scale = 1.0 / math.sqrt(cfg.dim_head)

    cache = write_kv(cache, layer_idx, k, v, meta.slot_mapping)
    pool, S, sw = cache.k[layer_idx], cache.page_size, cfg.sliding_window
    if mode == "prefill" and isinstance(meta, PackedPrefillMeta):
        out = prefill_attention.paged_prefill_attention_hm_packed(
            q, pool, meta.page_tables, meta.cache_lens, meta.q_lens, S, scale, sw
        )
    elif mode == "prefill":
        out = prefill_attention.paged_prefill_attention_hm(
            q, pool, meta.page_table, meta.cache_len, meta.q_len, S, scale, sw
        )
    else:
        out = attn_headmajor.paged_decode_attention_hm(
            q, pool, meta.page_tables, meta.context_lens, S, scale, sw
        )
    return linear(p["o_proj"], out.reshape(n, cfg.num_heads * cfg.dim_head)), cache


# ---------------------------------------------------------------------------
# feed-forward and block
# ---------------------------------------------------------------------------

def dense_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated MLP, from split or fused gate+up weights."""
    if "gate_up_proj" in p:
        g, u = linear(p["gate_up_proj"], x).chunk(2, dim=-1)
    else:
        g, u = linear(p["gate_proj"], x), linear(p["up_proj"], x)
    return linear(p["down_proj"], gated_act(g, u, cfg.activate_fn))


def decoder_layer(
    p: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    layer_idx: int,
    meta,
    mode: str,
    rot=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Pre-norm block: sequential residual by default, Cohere's parallel
    variant, MiniCPM's depth-scaled residual (scale_depth / sqrt(L))."""
    if cfg.is_moe_layer(layer_idx):
        raise NotImplementedError("MoE layers are not ported yet")
    res_scale = cfg.scale_depth / math.sqrt(cfg.num_layers) if cfg.scale_depth != 1.0 else 1.0
    h = _norm(p["ln_attn"], cfg, x)
    attn_out, cache = attention_layer(
        p["attn"], cfg, rope, h, positions, cache, layer_idx, meta, mode, rot=rot
    )
    if cfg.parallel_residual:
        return x + attn_out + dense_mlp(p["mlp"], cfg, h), cache
    x = x + attn_out * res_scale
    h = _norm(p["ln_ff"], cfg, x)
    return x + dense_mlp(p["mlp"], cfg, h) * res_scale, cache


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embedding"]["w"].index_select(0, tokens)
    if cfg.scale_emb != 1.0:
        x = x * cfg.scale_emb
    return x.to(cfg.torch_dtype)


def backbone(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    meta,
    mode: str,
) -> Tuple[torch.Tensor, KVCache]:
    """Embedding -> N blocks -> final norm; rope's cos/sin are computed once
    and shared by every layer."""
    x = embed(params, cfg, tokens)
    rot = rope.rot_values(positions)
    for i in range(cfg.num_layers):
        x, cache = decoder_layer(
            params["layers"][str(i)], cfg, rope, x, positions, cache, i, meta, mode, rot=rot
        )
    return _norm(params["final_norm"], cfg, x), cache


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result. On the GPU a bf16/fp16 product goes to
    cuBLAS with an fp32 output (fp32 accumulation, no rounding of the result
    to bf16, which would create argmax ties); the weight is never upcast."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def get_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Project hidden states [..., d] to fp32 vocab logits [..., V], with the
    MiniCPM (dim_model_base) and Cohere (logit_scale) scalings."""
    if cfg.dim_model_base:
        hidden = hidden / (cfg.dim_model / cfg.dim_model_base)
    w = params["embedding"]["w"].t() if cfg.tie_lm_head else params["lm_head"]["w"]
    lead = hidden.shape[:-1]
    logits = _matmul_f32(hidden.reshape(-1, hidden.shape[-1]), w).reshape(*lead, -1)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def forward_prefill(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [T]
    meta: PrefillMeta,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One prefill chunk; returns the fp32 logits [V] of its last valid token."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill")
    last = (meta.q_len - 1).clamp_min(0).reshape(1).long()
    return get_logits(params, cfg, hidden.index_select(0, last))[0], cache


def forward_prefill_packed(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [NS * TC]
    meta: PackedPrefillMeta,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """Packed chunks of NS sequences; returns each segment's last-valid-token
    logits [NS, V] (rows of empty segments are garbage the host discards)."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill")
    NS = meta.num_segments
    TC = tokens.shape[0] // NS
    rows = torch.arange(NS, device=tokens.device) * TC + (meta.q_lens - 1).clamp_min(0)
    return get_logits(params, cfg, hidden.index_select(0, rows.long())), cache


def forward_decode(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [B]
    meta: DecodeMeta,
    cache: KVCache,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for all slots; returns fp32 logits [B, V]."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "decode")
    return get_logits(params, cfg, hidden), cache


# ---------------------------------------------------------------------------
# random init (tests and measurements without checkpoints)
# ---------------------------------------------------------------------------

def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    device=None,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Random weights in the reference's layout and scales (normal /
    sqrt(fan_in), embeddings 0.02, norms 1), drawn on ``device`` from a
    generator seeded with ``seed``."""
    if cfg.mla.enabled or cfg.moe.enabled:
        raise NotImplementedError("MLA and MoE models are not ported yet")
    dtype = dtype or cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    d, hq, hkv, dh = cfg.dim_model, cfg.num_heads, cfg.num_kv_heads, cfg.dim_head

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def lin(in_dim, out_dim, bias=False):
        p = {"w": dense((in_dim, out_dim))}
        if bias:
            p["b"] = torch.zeros(out_dim, dtype=dtype, device=device)
        return p

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def layer() -> Params:
        attn = {
            "q_proj": lin(d, hq * dh, cfg.attn_bias),
            "k_proj": lin(d, hkv * dh, cfg.attn_bias),
            "v_proj": lin(d, hkv * dh, cfg.attn_bias),
            "o_proj": lin(hq * dh, d),
        }
        if cfg.qk_norm:
            attn["q_norm"] = {"w": ones(dh)}
            attn["k_norm"] = {"w": ones(dh)}
        mlp = {"gate_proj": lin(d, cfg.dim_ff), "up_proj": lin(d, cfg.dim_ff),
               "down_proj": lin(cfg.dim_ff, d)}
        p = {"ln_attn": {"w": ones(d)}, "attn": attn, "mlp": mlp}
        if not cfg.parallel_residual:
            p["ln_ff"] = {"w": ones(d)}
        return p

    params: Params = {
        "embedding": {"w": dense((cfg.vocab_size, d), scale=0.02)},
        "layers": {str(i): layer() for i in range(cfg.num_layers)},
        "final_norm": {"w": ones(d)},
    }
    if not cfg.tie_lm_head:
        params["lm_head"] = {"w": dense((d, cfg.vocab_size), scale=0.02)}
    return params


def param_count(params: Params) -> int:
    """Number of parameters in a nested parameter dict."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
