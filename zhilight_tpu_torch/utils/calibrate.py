"""SmoothQuant activation-scale calibration (counterpart of
``zhilight_tpu/utils/calibrate.py``).

Calibration token sequences run through the model while the per-channel
absolute maxima of every quantized linear's INPUT are collected; the maxima
then migrate activation outliers into the weights
(``utils.quant_convert.smooth_quant_weights``), so that W8A8 int8 serving
works from a raw fp16/bf16 checkpoint.

One plain forward under ``torch.no_grad()`` returns the statistics of one
sequence; they accumulate over the sequences with a running maximum.
Attention is the plain dense causal path with no KV cache: calibration is
offline, and the statistics do not depend on cache mechanics.

Scope: the seven dense-layer linears (q/k/v or fused qkv, o, gate/up or fused
gate_up, down). MoE expert weights keep their checkpoint's quantization.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

__all__ = ["calc_act_scales", "calib_forward"]


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax(0)


def calib_forward(params, cfg, rope, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One calibration pass over a single sequence [T]; returns
    {parameter path: per-channel |input| max} for every quantized-linear site."""
    from ..models.llama import _maybe_qk_norm, _norm, _qkv, embed, mlp_layer
    from ..ops.activations import gated_act
    from ..ops.attention import prefill_attention
    from ..ops.linear import linear
    from ..ops.rope import apply_rope_rot

    T = tokens.shape[0]
    positions = torch.arange(T, dtype=torch.int32, device=tokens.device)
    x = embed(params, cfg, tokens)
    cos_f, sin_f = rope.rot_values(positions)
    scale = 1.0 / math.sqrt(cfg.dim_head)
    res_scale = cfg.scale_depth / math.sqrt(cfg.num_layers) if cfg.scale_depth != 1.0 else 1.0
    stats: Dict[str, torch.Tensor] = {}

    for i in range(cfg.num_layers):
        p = params["layers"][str(i)]
        pre = f"layers.{i}"
        h = _norm(p["ln_attn"], cfg, x)
        for name in ("qkv_proj", "q_proj", "k_proj", "v_proj"):
            if name in p["attn"]:
                stats[f"{pre}.attn.{name}"] = _amax(h)
        q, k, v = _qkv(p["attn"], cfg, h)
        q, k = _maybe_qk_norm(p["attn"], cfg, q, k)
        q = apply_rope_rot(q, cos_f, sin_f, rope.neox_style)
        k = apply_rope_rot(k, cos_f, sin_f, rope.neox_style)
        attn = prefill_attention(q, k, v, 0, T, scale, cfg.sliding_window)
        attn = attn.reshape(T, cfg.num_heads * cfg.dim_head)
        stats[f"{pre}.attn.o_proj"] = _amax(attn)
        attn_out = linear(p["attn"]["o_proj"], attn)

        if cfg.parallel_residual:
            ff_in = h
        else:
            x = x + attn_out * res_scale
            ff_in = _norm(p["ln_ff"], cfg, x)

        mp = p["mlp"]
        if cfg.is_moe_layer(i):
            # MoE experts keep their checkpoint's quantization: no statistics
            ff_out = mlp_layer(mp, cfg, ff_in, i)
        else:
            for name in ("gate_up_proj", "gate_proj", "up_proj"):
                if name in mp:
                    stats[f"{pre}.mlp.{name}"] = _amax(ff_in)
            if "gate_up_proj" in mp:
                g, u = linear(mp["gate_up_proj"], ff_in).chunk(2, dim=-1)
            else:
                g, u = linear(mp["gate_proj"], ff_in), linear(mp["up_proj"], ff_in)
            hact = gated_act(g, u, cfg.activate_fn)
            stats[f"{pre}.mlp.down_proj"] = _amax(hact)
            ff_out = linear(mp["down_proj"], hact)

        if cfg.parallel_residual:
            x = x + attn_out + ff_out
        else:
            x = x + ff_out * res_scale
    return stats


def calc_act_scales(params, cfg, rope, token_batches: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-channel activation |max| over the calibration sequences (a running
    maximum), fp32 numpy by parameter path."""
    device = params["embedding"]["w"].device
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for toks in token_batches:
            tokens = torch.as_tensor(np.asarray(toks, np.int32), device=device)
            for k, v in calib_forward(params, cfg, rope, tokens).items():
                prev = out.get(k)
                out[k] = v if prev is None else torch.maximum(prev, v)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in out.items()}
