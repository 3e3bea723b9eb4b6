"""W4A16 fused dequantize + matmul for GPTQ/AWQ int4 weights.

Counterpart of ``zhilight_tpu/ops/pallas/quant_matmul.py`` ``w4a16_matmul``
(:242). The CUDA kernel is ``csrc/quant_matmul.cu``; the plain PyTorch version
is :func:`w4a16_matmul_plain` (unpack, ``dequant_int4``, fp32 matmul).
:func:`w4a16_matmul` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. The kernel takes every shape the
loader produces (ragged M and N edges are masked in the kernel), so the
reference's dequant + dot fallback for shapes that do not tile has no
counterpart here. The wrapper picks the kernel's tile shape and split-K count
on the host (:func:`plan`, cached by shape) and owns the split-K scratch.

Weights: uint8 ``[K/2, N]`` in the global-planar layout (``ops/quant.pack_int4``)
or int8 nibbles ``[K, N]``; f32 scales and zeros ``[G, N]``, group size K/G.

The result is x's dtype, or with ``out_dtype=torch.float32`` the fp32
accumulators unrounded (the kernel's fp32-output mode: its epilogue stores
fp32): a row-parallel rank's partial product, all-reduced in fp32 and
rounded once (``models/llama.py`` ``_reduce_linear``).
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
    out_dtype=None,
) -> torch.Tensor:
    """Dequantize to x's dtype, multiply in fp32, round to x's dtype (or to
    ``out_dtype``: fp32 keeps the product unrounded)."""
    w = dequant_int4(w_p, scales, zeros, x.dtype)
    return torch.matmul(x.float(), w.float()).to(out_dtype or x.dtype)


# the kernels (csrc/quant_matmul.cu): 0 decode (M <= 16), 1 prefill with
# 64 x 128 output tiles, 2 prefill with 128 x 256; rows and columns of an
# output tile; weight rows of a stage (the split unit); the most weight rows
# a decode split takes
CONFIGS = ((16, 256), (64, 128), (128, 256))
STAGE_ROWS = (64, 32, 32)
DECODE_ROWS = 640
MAX_SPLITS = 32


def plan(M: int, N: int, K: int, planar: bool, sms: int) -> tuple:
    """(config, splits) of one call: the kernel by M, then its split-K count.

    Decode takes about one block an SM (``sms // tiles`` splits, which
    ``chip_smoke.py``'s sweep favoured on the H100 over enough splits for
    the two blocks an SM holds: more partial tiles to write and merge), and
    at least enough that a split holds at most ``DECODE_ROWS`` weight rows
    (its x slice is staged whole). Prefill is a simple model in units of one
    stage's copies and products: the blocks of an SM share its throughput,
    so the call takes about the most blocks any SM gets (``ceil(blocks /
    sms)``) times a block's run, its ``ceil(stages / splits)`` stages plus a
    pipeline fill of two and, when split, the write of its fp32 partial tile
    (``w`` stages' worth of bytes); the last block of a tile then reads
    ``splits`` partials. ``splits`` always cuts the stages into that many
    non-empty runs."""
    cfg = 0 if M <= 16 else 1 if M <= 64 else 2
    BM, BN = CONFIGS[cfg]
    tiles = -(-M // BM) * -(-N // BN)
    stages = -(-(K // 2 if planar else K) // STAGE_ROWS[cfg])

    def whole(s):  # the split count of runs of ceil(stages / s) stages
        return -(-stages // -(-stages // s))

    if cfg == 0:
        least = -(-stages // (DECODE_ROWS // STAGE_ROWS[0]))
        fill = max(1, sms // tiles)  # about one block an SM
        return cfg, whole(min(max(least, min(fill, MAX_SPLITS)), stages))
    rows = min(M, BM)
    stage_bytes = STAGE_ROWS[cfg] * BN + rows * 2 * STAGE_ROWS[cfg] * 2
    w = 2 * rows * BN * 4 / stage_bytes
    best = None
    for s in range(1, min(stages, MAX_SPLITS) + 1):
        s = whole(s)
        per = -(-stages // s)
        cost = -(-tiles * s // sms) * (per + 2 + (w if s > 1 else 0.0)) + (0.5 * w * s if s > 1 else 0.0)
        if best is None or cost < best[0]:
            best = (cost, s)
    return cfg, best[1]


def _entry():
    fn = _build.library("quant_matmul").zt_w4a16_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


class SplitScratch:
    """What a split-K matmul wrapper keeps per device (this module's and
    ``fp8_matmul``'s, each its own): the SM count (asked once), the plans by
    shape, and the split-K scratch: fp32 partials and int32
    tickets, zero between launches (the kernel's last block of each tile
    resets its own), grown to the largest call's need and never shrunk. One
    stream at a time uses them, as the engine runs its steps."""

    def __init__(self, device):
        self.sms = torch.cuda.get_device_properties(device).multi_processor_count
        self.plans: dict = {}
        self.part = torch.empty(0, dtype=torch.float32, device=device)
        self.tickets = torch.zeros(0, dtype=torch.int32, device=device)

    def scratch(self, splits: int, M: int, N: int, tiles: int):
        if self.part.numel() < splits * M * N:
            self.part = torch.empty(splits * M * N, dtype=torch.float32, device=self.part.device)
        if self.tickets.numel() < tiles:
            self.tickets = torch.zeros(tiles, dtype=torch.int32, device=self.tickets.device)
        return self.part.data_ptr(), self.tickets.data_ptr()


_DEVICES: dict = {}


def _run(x2, w_p, scales, zeros, out, planar: bool, cfg_splits=None) -> None:
    """Launch the kernel on checked 2-D operands; ``cfg_splits`` overrides
    the plan (chip_smoke.py's sweep)."""
    M, K = x2.shape
    N, G = out.shape[1], scales.shape[0]
    dev = _DEVICES.get(x2.device)
    if dev is None:
        dev = _DEVICES[x2.device] = SplitScratch(x2.device)
    key = (M, N, K, planar)
    cfg, splits = cfg_splits or dev.plans.get(key) or dev.plans.setdefault(
        key, plan(M, N, K, planar, dev.sms))
    part = tickets = None
    if splits > 1:
        BM, BN = CONFIGS[cfg]
        part, tickets = dev.scratch(splits, M, N, -(-M // BM) * -(-N // BN))
    vec16 = int(N % 16 == 0 and w_p.data_ptr() % 16 == 0)
    err = _entry()(
        out.data_ptr(), x2.data_ptr(), w_p.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        part, tickets, M, N, K, G, int(planar), cfg, splits, vec16,
        int(out.dtype == torch.float32), torch.cuda.current_stream(x2.device).cuda_stream,
    )
    _build.check(err, "w4a16_matmul")


def w4a16_matmul(
    x: torch.Tensor,
    w_p: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    out_dtype=None,
) -> torch.Tensor:
    """``x · ((w - zero_g) · scale_g)`` with fp32 accumulation; [..., N] in x's
    dtype, or unrounded with ``out_dtype=torch.float32``."""
    if out_dtype not in (None, x.dtype, torch.float32):
        raise NotImplementedError(f"w4a16_matmul: out_dtype {out_dtype}: x's dtype or float32")
    if x.device.type == "cpu":
        return w4a16_matmul_plain(x, w_p, scales, zeros, out_dtype)
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
    if x.dtype == torch.float16:  # as the reference's kernel: x to bf16, the result back
        y = w4a16_matmul(x.to(torch.bfloat16), w_p, scales, zeros, out_dtype=out_dtype)
        return y if out_dtype == torch.float32 else y.to(x.dtype)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"w4a16_matmul kernel takes bf16 or fp16 activations, got {x.dtype}")
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise ValueError("w4a16_matmul: scales and zeros must be float32")
    if N % 8 or rows % 8:
        raise NotImplementedError(f"w4a16_matmul kernel: N {N} and weight rows {rows} must be multiples of 8")
    x2 = x.reshape(-1, K).contiguous()
    out = torch.empty((x2.shape[0], N), dtype=out_dtype or x.dtype, device=x.device)
    for t, align in ((x2, 16), (w_p, 8), (scales, 16), (zeros, 16), (out, 16)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("w4a16_matmul: tensors must be contiguous, aligned and on one device")
    _run(x2, w_p, scales, zeros, out, planar)
    w4a16_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


w4a16_matmul.launches = 0
