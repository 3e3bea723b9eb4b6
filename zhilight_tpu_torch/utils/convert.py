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

__all__ = ["params_to_torch"]


def _leaf(x: Any) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.array(x, order="C")  # a writable copy (device_get arrays are read-only)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: no numpy-native type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to_torch(params: Any, device=None, dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dict of arrays (numpy, or any object numpy can read) -> the
    same nesting of torch tensors on ``device``; ``dtype`` casts the
    floating-point leaves."""
    if isinstance(params, dict):
        return {k: params_to_torch(v, device, dtype) for k, v in params.items()}
    t = _leaf(params)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
