"""Rotary position embeddings (counterpart of ``zhilight_tpu/ops/rope.py``).

The frequency table is built once on the host with numpy, by the reference's
own code for every scaling family (default, linear, dynamic-NTK, YaRN with
DeepSeek mscale, Llama-3 low/high-frequency bands, m-rope). cos/sin are
formed from integer positions on the device, once per forward, and shared by
every layer. The rotation is ``x*cos + rotate(x)*sin`` in fp32, with the
neox (half split) or interleaved (even/odd pairs) style; the reference's
signed-permutation matmul computes the same values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..config.model_config import RopeConfig

__all__ = ["RopeTable", "build_rope_table", "apply_rope_rot"]


def _yarn_find_correction_dim(num_rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (2 * math.log(base))


def _yarn_find_correction_range(low_rot, high_rot, dim, base, max_pos):
    low = math.floor(_yarn_find_correction_dim(low_rot, dim, base, max_pos))
    high = math.ceil(_yarn_find_correction_dim(high_rot, dim, base, max_pos))
    return max(low, 0), min(high, dim - 1)


def _yarn_linear_ramp(low, high, dim):
    if low == high:
        high += 0.001
    ramp = (np.arange(dim, dtype=np.float64) - low) / (high - low)
    return np.clip(ramp, 0, 1)


def _yarn_get_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


@dataclass(frozen=True)
class RopeTable:
    """Static rope state: inverse frequencies + attention magnitude scale."""

    inv_freq: np.ndarray  # [dim/2] float64
    mscale: float
    neox_style: bool

    def cos_sin(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """positions [*shape] int -> fp32 cos/sin [*shape, dim/2]."""
        inv_freq = torch.as_tensor(self.inv_freq, dtype=torch.float32, device=positions.device)
        freqs = positions.float()[..., None] * inv_freq
        return torch.cos(freqs) * self.mscale, torch.sin(freqs) * self.mscale

    def rot_values(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-width fp32 cos/sin [*shape, dim] laid out for the rotation
        style; computed once per forward and shared across layers."""
        cos, sin = self.cos_sin(positions)
        if self.neox_style:
            return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
        return cos.repeat_interleave(2, dim=-1), sin.repeat_interleave(2, dim=-1)


def build_rope_table(
    dim: int,
    theta: float,
    cfg: RopeConfig,
    max_position_embeddings: int = 8192,
    max_model_len: int = 0,
) -> RopeTable:
    base = float(theta)
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    mscale = 1.0
    rtype = cfg.type or "default"

    if rtype in ("default", ""):
        pass
    elif rtype == "linear":
        inv_freq = inv_freq / cfg.factor
    elif rtype == "dynamic":
        # dynamic NTK evaluated at serving max length (static-shape policy:
        # the reference recomputes per step when seq_len exceeds trained length,
        # rotary_embedding.cu dynamic path; on TPU we fix the worst case)
        seq_len = max(max_model_len or max_position_embeddings, max_position_embeddings)
        if seq_len > max_position_embeddings and cfg.factor > 1.0:
            adj_base = base * (
                (cfg.factor * seq_len / max_position_embeddings) - (cfg.factor - 1)
            ) ** (dim / (dim - 2))
            inv_freq = 1.0 / (adj_base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    elif rtype == "yarn":
        orig_max = cfg.original_max_position or max_position_embeddings
        extrapolation = inv_freq
        interpolation = inv_freq / cfg.factor
        low, high = _yarn_find_correction_range(
            cfg.beta_fast, cfg.beta_slow, dim, base, orig_max
        )
        ramp = 1.0 - _yarn_linear_ramp(low, high, dim // 2)
        inv_freq = interpolation * (1.0 - ramp) + extrapolation * ramp
        if cfg.mscale_all_dim:
            # DeepSeek variant (rotary_embedding.cu:518-612 / HF deepseek_v2)
            mscale = cfg.attn_factor * (
                _yarn_get_mscale(cfg.factor, cfg.mscale)
                / _yarn_get_mscale(cfg.factor, cfg.mscale_all_dim)
            )
        else:
            mscale = cfg.attn_factor * _yarn_get_mscale(cfg.factor, 1.0)
    elif rtype == "llama3":
        low_freq_wavelen = (cfg.original_max_position or max_position_embeddings) / cfg.low_freq_factor
        high_freq_wavelen = (cfg.original_max_position or max_position_embeddings) / cfg.high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = np.where(wavelen > low_freq_wavelen, inv_freq / cfg.factor, inv_freq)
        smooth = (
            (cfg.original_max_position or max_position_embeddings) / wavelen - cfg.low_freq_factor
        ) / (cfg.high_freq_factor - cfg.low_freq_factor)
        mid = (1 - smooth) * inv_freq / cfg.factor + smooth * inv_freq
        is_mid = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
        inv_freq = np.where(is_mid, mid, scaled)
    elif rtype == "mrope":
        # m-rope uses the default table; the section split applies at position
        # construction time (multimodal models pass 3-row position ids)
        pass
    else:
        raise ValueError(f"unsupported rope type: {rtype!r}")

    return RopeTable(inv_freq=inv_freq, mscale=mscale, neox_style=cfg.neox_style)


def apply_rope_rot(
    x: torch.Tensor,         # [..., num_heads, head_dim]
    cos_full: torch.Tensor,  # [..., head_dim] (from RopeTable.rot_values)
    sin_full: torch.Tensor,
    neox_style: bool = True,
) -> torch.Tensor:
    """Rotate q or k: x*cos + rotate(x)*sin, where rotate maps the halves
    (x1, x2) to (-x2, x1) in neox style and each pair (x_even, x_odd) to
    (-x_odd, x_even) in interleaved style."""
    xf = x.float()
    if neox_style:
        x1, x2 = xf.chunk(2, dim=-1)
        rot = torch.cat([-x2, x1], dim=-1)
    else:
        rot = torch.stack([-xf[..., 1::2], xf[..., 0::2]], dim=-1).reshape(xf.shape)
    out = xf * cos_full[..., None, :] + rot * sin_full[..., None, :]
    return out.to(x.dtype)
