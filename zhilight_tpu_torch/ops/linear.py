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

__all__ = ["linear", "linear_f32", "matmul_f32", "in_rows"]


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


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result. On the GPU a bf16/fp16 product goes to
    cuBLAS with an fp32 output (fp32 accumulation, no rounding of the result
    to bf16, which would create argmax ties); the weight is never upcast."""
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32).reshape(
            *a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


def linear_f32(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The product of :func:`linear` without its bias, unrounded in fp32: a
    row-parallel rank's partial sum, all-reduced before it is rounded once.
    Dense, int4 (the ``w4a16_matmul`` kernel's fp32-output mode) and FP8 (the
    ``fp8_block_matmul`` kernel's, or the dequantized weight through
    :func:`matmul_f32`); a W8A8 shard reduces inside ``int8_linear``."""
    if "w" in p:
        return matmul_f32(x, p["w"])
    if "w_p" in p:
        return int4_linear(p, x, out_dtype=torch.float32)
    if "w_f8" in p:
        return fp8_linear(p, x, out_dtype=torch.float32)
    raise ValueError(f"no fp32 partial product for linear param format {sorted(p)}")


def in_rows(p: Dict[str, torch.Tensor]) -> int:
    """The input rows a linear entry holds: its weight's, an int4 planar
    weight's unpacked (a padded one's padding included)."""
    if "w_p" in p:
        w = p["w_p"]
        return w.shape[-2] * (2 if w.dtype == torch.uint8 else 1)
    return p[next(k for k in ("w", "w_q", "w_f8") if k in p)].shape[-2]
