"""Fused dequantize + matmul for FP8 (e4m3) weights with 128 x 128 block scales.

Counterpart of ``zhilight_tpu/ops/pallas/fp8_matmul.py`` ``fp8_block_matmul``
(:85). The CUDA kernel is ``csrc/fp8_matmul.cu``; the plain PyTorch version is
:func:`fp8_block_matmul_plain`. :func:`fp8_block_matmul` takes the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises. The wrapper picks the kernel and its split-K count on the host
(:func:`plan`, cached by shape) and owns the split-K scratch.

What both compute: the activations stay bf16 (they are not quantized), every
e4m3 weight is converted to bf16 (exactly), the product over one 128-row K
block accumulates in fp32, that partial sum is multiplied by the block's fp32
scale, and the scaled partials are added in fp32; the result is rounded to
bf16 once. This is not ``ops.quant.fp8_linear``'s dequantize-and-multiply
(which rounds ``w * scale`` to the activation dtype first): the two differ in
the last bf16 bits.

Weights: ``float8_e4m3fn`` ``[K, N]`` with K and N multiples of 128, none of
them a NaN encoding (bytes 0x7f, 0xff); f32 scales ``[K/128, N/128]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quant_matmul import SplitScratch

__all__ = ["fp8_block_matmul", "fp8_block_matmul_plain"]

_B = 128  # block edge


def fp8_block_matmul_plain(
    x: torch.Tensor,            # [..., K]
    w_f8: torch.Tensor,         # float8_e4m3fn [K, N]
    block_scale: torch.Tensor,  # f32 [K/128, N/128]
) -> torch.Tensor:
    """Per 128-row K block: bf16 x times the block's weights in fp32, times
    the block's scales; summed in fp32, rounded to bf16, cast to x's dtype."""
    K, N = w_f8.shape
    x2 = x.reshape(-1, K).to(torch.bfloat16).float()
    wf = w_f8.float()
    s = block_scale.float().repeat_interleave(_B, dim=1)  # [K/128, N]
    acc = torch.zeros((x2.shape[0], N), dtype=torch.float32, device=x.device)
    for kb in range(K // _B):
        blk = slice(kb * _B, (kb + 1) * _B)
        acc += torch.matmul(x2[:, blk], wf[blk]) * s[kb]
    return acc.to(torch.bfloat16).to(x.dtype).reshape(*x.shape[:-1], N)


# the kernels (csrc/fp8_matmul.cu): 0 decode (M <= 16), 1 wgmma prefill;
# rows and columns of an output tile; the most 128-row K blocks a decode
# split takes
CONFIGS = ((16, 256), (128, 128))
DECODE_M = 16
DECODE_KBLOCKS = 8
MAX_SPLITS = 32


def plan(M: int, N: int, K: int, sms: int) -> tuple:
    """(config, splits) of one call: the kernel by M, then its split-K count
    in whole 128-row K blocks. Decode takes about one block an SM (``sms //
    tiles`` splits, as ``quant_matmul.plan`` does), at least enough that a
    split holds at most ``DECODE_KBLOCKS`` K blocks (its x slice is staged
    whole), and at least two K blocks a split where K has them (a split's
    fixed cost and its share of the merge outweigh a single block). The wgmma
    kernel runs one block an SM: it splits only when its tiles alone would
    leave SMs idle, into ``sms // tiles`` runs."""
    cfg = 0 if M <= DECODE_M else 1
    BM, BN = CONFIGS[cfg]
    tiles = -(-M // BM) * -(-N // BN)
    kbs = K // _B

    def whole(s):  # the split count of runs of ceil(kbs / s) K blocks
        return -(-kbs // -(-kbs // s))

    fill = min(max(1, sms // tiles), MAX_SPLITS)
    if cfg == 1:
        return cfg, whole(min(fill, kbs))
    return cfg, whole(min(max(-(-kbs // DECODE_KBLOCKS), fill), max(kbs // 2, 1)))


def _entry():
    fn = _build.library("fp8_matmul").zt_fp8_block_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


_DEVICES: dict = {}


def fp8_block_matmul(
    x: torch.Tensor,
    w_f8: torch.Tensor,
    block_scale: torch.Tensor,
) -> torch.Tensor:
    """``x_bf16 · (W_e4m3 ⊙ block_scale[k/128, n/128])``, the scale applied to
    each K block's fp32 partial sum; [..., N] in x's dtype."""
    if x.device.type == "cpu":
        return fp8_block_matmul_plain(x, w_f8, block_scale)
    if not x.is_cuda:
        raise NotImplementedError(f"fp8_block_matmul: no kernel for device {x.device}")
    if w_f8.dtype != torch.float8_e4m3fn or w_f8.dim() != 2:
        raise ValueError(f"fp8_block_matmul: weights must be float8_e4m3fn [K, N], got "
                         f"{w_f8.dtype} {tuple(w_f8.shape)}")
    K, N = w_f8.shape
    if K == 0 or N == 0 or K % _B or N % _B:
        raise NotImplementedError(f"fp8_block_matmul kernel: K {K} and N {N} must be multiples of {_B}")
    if x.shape[-1] != K or block_scale.shape != (K // _B, N // _B):
        raise ValueError(f"fp8_block_matmul: x {tuple(x.shape)}, w_f8 {tuple(w_f8.shape)}, "
                         f"block_scale {tuple(block_scale.shape)}")
    if x.dtype == torch.float16:  # as the reference's kernel: x to bf16, the result back
        return fp8_block_matmul(x.to(torch.bfloat16), w_f8, block_scale).to(x.dtype)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"fp8_block_matmul kernel takes bf16 or fp16 activations, got {x.dtype}")
    if block_scale.dtype != torch.float32:
        raise ValueError("fp8_block_matmul: block_scale must be float32")
    if not x.is_contiguous():
        raise ValueError("fp8_block_matmul: x must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*x.shape[:-1], N)
    for t in (x2, w_f8, block_scale, out):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("fp8_block_matmul: tensors must be contiguous, 16-byte aligned "
                             "and on one device")
    dev = _DEVICES.get(x.device)
    if dev is None:
        dev = _DEVICES[x.device] = SplitScratch(x.device)
    cfg, splits = dev.plans.get((M, N, K)) or dev.plans.setdefault((M, N, K), plan(M, N, K, dev.sms))
    part = tickets = None
    if splits > 1:
        BM, BN = CONFIGS[cfg]
        part, tickets = dev.scratch(splits, M, N, -(-M // BM) * -(-N // BN))
    err = _entry()(
        out.data_ptr(), x2.data_ptr(), w_f8.data_ptr(), block_scale.data_ptr(), part, tickets,
        M, N, K, cfg, splits, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "fp8_block_matmul")
    fp8_block_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


fp8_block_matmul.launches = 0
