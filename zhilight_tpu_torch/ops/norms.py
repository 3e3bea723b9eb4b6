"""Normalization ops (counterpart of ``zhilight_tpu/ops/norms.py``).

RMSNorm, bias-free LayerNorm (Cohere) and per-head QK-norm. Reductions run in fp32 and the result is cast back to the
input dtype, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["rms_norm", "layer_norm", "qk_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-RMS LayerNorm without bias (Cohere style)."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def qk_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over head_dim (Qwen3 q_norm/k_norm).

    x: [..., num_heads, head_dim]; weight: [head_dim]."""
    return rms_norm(x, weight, eps)
