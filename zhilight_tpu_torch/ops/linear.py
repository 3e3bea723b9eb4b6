"""Linear layer (counterpart of ``zhilight_tpu/ops/linear.py``).

The port carries the dense format ``{"w": [in, out], "b"?: [out]}`` only.
The product is a plain ``torch.matmul`` (XLA's in the reference; on the GPU
cuBLAS accumulates bf16 products in fp32). The quantized formats of the
reference (int8, W8A8, GPTQ/AWQ int4, FP8 block) belong to later slices and
raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["linear"]

_QUANT_KEYS = ("w_q", "w_p", "w_f8")


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w" in p:
        y = torch.matmul(x, p["w"])
    elif any(k in p for k in _QUANT_KEYS):
        raise NotImplementedError(f"quantized linear formats are not ported yet: {sorted(p)}")
    else:
        raise ValueError(f"unknown linear param format: {sorted(p)}")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
