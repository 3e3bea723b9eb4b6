"""W4A16 fused dequantize + grouped (ragged) matmul for MoE expert stacks.

Counterpart of ``zhilight_tpu/ops/pallas/quant_ragged.py``
``w4a16_ragged_matmul`` (:142). The CUDA kernel is ``csrc/quant_ragged.cu``;
the plain PyTorch version is :func:`w4a16_ragged_matmul_plain`.
:func:`w4a16_ragged_matmul` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.

Rows are expert-aligned (``ops/quant.ragged_layout``): ``x`` is ``[Mp, K]`` cut
into ``Mp / len(tile_expert)`` -row m-tiles, m-tile ``i`` belongs to expert
``tile_expert[i]``, and only the first ``num_occ[0]`` tiles are computed. Both
stay on the device; the grid is the static worst case and nothing is read
back. Output rows of tiles past ``num_occ`` are unwritten (the kernel) or zero
(the plain version); the layout's ``dest`` indices never point there.

Weights: uint8 ``[E, K/2, N]``, each expert in the global-planar layout
(``ops/quant.pack_expert_int4``); f32 scales and zeros ``[E, G, N]``.

The kernel multiplies bf16 activations, as the TPU kernel casts them; the plain
version keeps the activations' own precision (fp32 in the CPU parity tests),
like the reference's dequantize-and-dot fallback (``models/moe.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import dequant_expert_int4
from . import _build

__all__ = ["w4a16_ragged_matmul", "w4a16_ragged_matmul_plain"]


def w4a16_ragged_matmul_plain(
    x: torch.Tensor,            # [Mp, K] expert-aligned rows
    w_p: torch.Tensor,          # uint8 [E, K/2, N] per-expert planar
    scales: torch.Tensor,       # f32 [E, G, N]
    zeros: torch.Tensor,        # f32 [E, G, N]
    tile_expert: torch.Tensor,  # int32 [Mp / TM]
    num_occ: torch.Tensor,      # int32 [1]
) -> torch.Tensor:
    """Each m-tile times its expert's weights dequantized to x's dtype, fp32
    products, rounded to x's dtype; tiles past ``num_occ`` give zeros."""
    Mp, K = x.shape
    tiles = tile_expert.shape[0]
    TM = Mp // tiles
    w = dequant_expert_int4(w_p, scales, zeros, x.dtype)  # [E, K, N]
    out = torch.bmm(x.reshape(tiles, TM, K).float(), w[tile_expert.long()].float())
    live = torch.arange(tiles, device=x.device) < num_occ
    return (out * live[:, None, None]).reshape(Mp, -1).to(x.dtype)


def _entry():
    fn = _build.library("quant_ragged").zt_w4a16_ragged_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def w4a16_ragged_matmul(
    x: torch.Tensor,
    w_p: torch.Tensor,
    scales: torch.Tensor,
    zeros: torch.Tensor,
    tile_expert: torch.Tensor,
    num_occ: torch.Tensor,
) -> torch.Tensor:
    """Grouped W4A16 matmul over expert-aligned rows; [Mp, N] in x's dtype."""
    if x.device.type == "cpu":
        return w4a16_ragged_matmul_plain(x, w_p, scales, zeros, tile_expert, num_occ)
    if not x.is_cuda:
        raise NotImplementedError(f"w4a16_ragged_matmul: no kernel for device {x.device}")
    if w_p.dtype != torch.uint8 or w_p.dim() != 3:
        raise ValueError(f"w4a16_ragged_matmul: weights must be uint8 [E, K/2, N], got "
                         f"{w_p.dtype} {tuple(w_p.shape)}")
    E, Kh, N = w_p.shape
    K = 2 * Kh
    G = scales.shape[1]
    tiles = tile_expert.shape[0]
    Mp = x.shape[0]
    if (x.shape != (Mp, K) or scales.shape != (E, G, N) or zeros.shape != (E, G, N) or G == 0
            or tiles == 0 or Mp % tiles):
        raise ValueError(
            f"w4a16_ragged_matmul: x {tuple(x.shape)}, w_p {tuple(w_p.shape)}, scales "
            f"{tuple(scales.shape)}, zeros {tuple(zeros.shape)}, {tiles} tiles")
    TM = Mp // tiles
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"w4a16_ragged_matmul kernel takes bf16 activations, got {x.dtype}")
    if scales.dtype != torch.float32 or zeros.dtype != torch.float32:
        raise ValueError("w4a16_ragged_matmul: scales and zeros must be float32")
    if tile_expert.dtype != torch.int32 or num_occ.dtype != torch.int32 or num_occ.numel() != 1:
        raise ValueError("w4a16_ragged_matmul: tile_expert int32 [tiles], num_occ int32 [1]")
    gs = K // G
    # the shapes the reference routes to its kernel (models/moe.py): whole
    # groups of a multiple of 32 rows, each inside one nibble plane
    if K % G or gs % 32 or N % 128 or Kh % gs:
        raise NotImplementedError(
            f"w4a16_ragged_matmul kernel: K {K}, group size {gs}, N {N} "
            "(needs K % gs == 0, gs % 32 == 0, N % 128 == 0, (K/2) % gs == 0)")
    if TM > 64 or tiles > 65535:
        raise NotImplementedError(f"w4a16_ragged_matmul kernel: m-tile of {TM} rows, {tiles} tiles")
    out = torch.empty((Mp, N), dtype=x.dtype, device=x.device)
    for t, align in ((x, 16), (w_p, 8), (scales, 16), (zeros, 16), (out, 16), (tile_expert, 4),
                     (num_occ, 4)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError("w4a16_ragged_matmul: tensors must be contiguous, aligned and on one device")
    err = _entry()(
        out.data_ptr(), x.data_ptr(), w_p.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        tile_expert.data_ptr(), num_occ.data_ptr(), tiles, TM, E, N, K, G,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "w4a16_ragged_matmul")
    w4a16_ragged_matmul.launches += 1
    return out


w4a16_ragged_matmul.launches = 0
