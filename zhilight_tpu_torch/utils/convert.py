"""Carry weights across from the JAX package's layout.

The reference keeps parameters as a nested dict (``embedding``, ``layers`` /
``"<i>"`` / ``attn`` / ``q_proj`` / ``w`` ...) of arrays, with linear weights
stored ``[in, out]``. The port uses the same nesting and layout, so a
conversion is a leaf-by-leaf copy into torch tensors: with the same weights,
both packages compute the same function.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = ["params_to_torch", "to_tensor"]

# leaves of a quantized linear or expert stack that keep their own dtypes
# (a bias "b" beside them is still cast):
#   int4 {"w_p", "scales", "zeros", "perm"?}: uint8/int8 weights, f32 scales
#        and zeros, int32 perm
#   int8 {"w_q", "scale", "smooth"?}: int8 weights, f32 scale and smooth
#   fp8  {"w_f8", "block_scale" | "scale"}: float8_e4m3fn weights, f32 scales
_QUANT_LEAVES = {
    "w_p": ("w_p", "scales", "zeros", "perm"),
    "w_q": ("w_q", "scale", "smooth"),
    "w_f8": ("w_f8", "block_scale", "scale"),
}


def to_tensor(x: Any) -> torch.Tensor:
    """A torch tensor as it is, or a CPU tensor copied from an array (numpy,
    ml_dtypes bfloat16 and float8_e4m3fn included, or any object numpy can
    read)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.array(x, order="C")  # a writable copy (device_get arrays are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: no numpy-native type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn" and a.dtype.itemsize == 1:  # ml_dtypes, by its bits
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def params_to_torch(params: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of arrays (numpy, or any object numpy can read) -> the
    same nesting of torch tensors on ``device``; ``dtype`` casts the dense
    floating-point leaves, MLA projections and dense expert stacks included.
    The leaves of an int4, int8 or FP8 linear or expert stack keep their
    dtypes (payloads, f32 scales, zeros and smooth vectors, int32 perm), and
    so do a MoE router's weight and correction bias (routing runs in fp32)."""
    if isinstance(params, dict):
        kept = next((leaves for w, leaves in _QUANT_LEAVES.items() if w in params), ())
        return {
            k: params_to_torch(v, device, None if k in kept or k == "router" else dtype)
            for k, v in params.items()
        }
    t = to_tensor(params)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
