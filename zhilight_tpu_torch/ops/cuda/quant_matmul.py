"""W4A16 fused dequantize + matmul for GPTQ/AWQ int4 weights.

Counterpart of ``zhilight_tpu/ops/pallas/quant_matmul.py`` ``w4a16_matmul``
(:242). The CUDA kernel is ``csrc/quant_matmul.cu``; the plain PyTorch version
is :func:`w4a16_matmul_plain` (unpack, ``dequant_int4``, fp32 matmul).
:func:`w4a16_matmul` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. The kernel takes every shape the
loader produces (ragged M and N edges are masked in the kernel), so the
reference's dequant + dot fallback for shapes that do not tile has no
counterpart here.

Weights: uint8 ``[K/2, N]`` in the global-planar layout (``ops/quant.pack_int4``)
or int8 nibbles ``[K, N]``; f32 scales and zeros ``[G, N]``, group size K/G.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import dequant_int4
from . import _build

__all__ = ["w4a16_matmul", "w4a16_matmul_plain"]


def w4a16_matmul_plain(
    x: torch.Tensor,       # [..., K]
    w_p: torch.Tensor,     # uint8 [K/2, N] planar or int8 [K, N] nibbles
    scales: torch.Tensor,  # f32 [G, N]
    zeros: torch.Tensor,   # f32 [G, N]
) -> torch.Tensor:
    """Dequantize to x's dtype, multiply in fp32, round to x's dtype."""
    w = dequant_int4(w_p, scales, zeros, x.dtype)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _entry():
    fn = _build.library("quant_matmul").zt_w4a16_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def w4a16_matmul(
    x: torch.Tensor,
    w_p: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
) -> torch.Tensor:
    """``x · ((w - zero_g) · scale_g)`` with fp32 accumulation; [..., N] in x's dtype."""
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_p, scales, zeros)
    if not x.is_cuda:
        raise NotImplementedError(f"w4a16_matmul: no kernel for device {x.device}")
    planar = w_p.dtype == torch.uint8
    if not planar and w_p.dtype != torch.int8:
        raise ValueError(f"w4a16_matmul: weights must be uint8 planar or int8 nibbles, got {w_p.dtype}")
    rows, N = w_p.shape
    K = 2 * rows if planar else rows
    G = scales.shape[0]
    if x.shape[-1] != K or scales.shape != (G, N) or zeros.shape != (G, N) or G == 0 or K % G:
        raise ValueError(
            f"w4a16_matmul: x {tuple(x.shape)}, w_p {tuple(w_p.shape)} {w_p.dtype}, "
            f"scales {tuple(scales.shape)}, zeros {tuple(zeros.shape)}"
        )
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"w4a16_matmul kernel takes bf16 activations, got {x.dtype}")
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise ValueError("w4a16_matmul: scales and zeros must be float32")
    if N % 8 or rows % 8:
        raise NotImplementedError(f"w4a16_matmul kernel: N {N} and weight rows {rows} must be multiples of 8")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    for t, align in ((x2, 16), (w_p, 8), (scales, 16), (zeros, 16), (out, 16)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("w4a16_matmul: tensors must be contiguous, aligned and on one device")
    err = _entry()(
        out.data_ptr(), x2.data_ptr(), w_p.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        M, N, K, G, int(planar), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "w4a16_matmul")
    w4a16_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


w4a16_matmul.launches = 0
