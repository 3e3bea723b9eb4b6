"""Activation functions and the gated activation of SwiGLU-style MLPs
(counterpart of ``zhilight_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get_activation", "gated_act"]

_ACTS = {
    "silu": F.silu,
    "swish": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def get_activation(name: str):
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"unsupported activation: {name!r}") from None


def gated_act(gate: torch.Tensor, up: torch.Tensor, act: str = "silu") -> torch.Tensor:
    return get_activation(act)(gate) * up
