"""Linear layer (counterpart of ``zhilight_tpu/ops/linear.py``).

The weight format is told by the keys of a parameter dict:

  {"w": [in, out], "b"?: [out]}                        dense
  {"w_p": int4, "scales", "zeros", "perm"?, "b"?}      GPTQ/AWQ W4A16 (``ops/quant.py``)
  {"w_q": int8, "scale", "smooth"?, "b"?}              W8A8 int8, SmoothQuant
  {"w_f8": e4m3, "block_scale" | "scale", "b"?}        FP8

The dense product is a plain ``torch.matmul`` (XLA's in the reference; on the
GPU cuBLAS accumulates bf16 products in fp32). On the GPU the int4 product is
the hand-written ``w4a16_matmul`` kernel and the block-scaled FP8 product the
hand-written ``fp8_block_matmul`` kernel; the int8 product is the library's
int8 x int8 GEMM with int32 accumulation (``torch._int_mm``).
"""

from __future__ import annotations

from typing import Dict

import torch

from .quant import fp8_linear, int4_linear, int8_linear

__all__ = ["linear"]


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w" in p:
        y = torch.matmul(x, p["w"])
    elif "w_p" in p:
        y = int4_linear(p, x)
    elif "w_q" in p:
        y = int8_linear(p, x)
    elif "w_f8" in p:
        y = fp8_linear(p, x)
    else:
        raise ValueError(f"unknown linear param format: {sorted(p)}")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y
