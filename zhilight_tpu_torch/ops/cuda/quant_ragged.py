"""W4A16 fused dequantize + grouped (ragged) matmul for MoE expert stacks.

Counterpart of ``zhilight_tpu/ops/pallas/quant_ragged.py``
``w4a16_ragged_matmul`` (:142). The CUDA kernel is ``csrc/quant_ragged.cu``;
the plain PyTorch version is :func:`w4a16_ragged_matmul_plain`.
:func:`w4a16_ragged_matmul` takes the plain version only for CPU tensors; for
CUDA tensors it launches the kernel or raises.

The kernel is ``w4a16_matmul``'s (``csrc/w4a16.cuh``, row 4's design) with
each block offset to its m-tile's expert: m-tiles of at most 16 rows (decode)
take the decode kernel, which dequantizes in registers straight into the
tensor-core fragments and splits K into runs of at most 640 weight rows;
larger m-tiles take the 64 x 128 prefill kernel. The wrapper picks the kernel
and the split count from the shapes (:func:`plan`) and keeps the split-K
scratch per device. Bound on the H100: bytes (each routed expert's packed
weights, scales and zeros read once); what holds the kernel back is instruction
issue and a block's fixed cost, as in ``w4a16_matmul`` (``PERF.md``).

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
from .quant_matmul import DECODE_ROWS, MAX_SPLITS, STAGE_ROWS, SplitScratch

__all__ = ["w4a16_ragged_matmul", "w4a16_ragged_matmul_plain", "plan"]


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


# the kernels (csrc/quant_ragged.cu): 0 decode (m-tiles of at most 16
# rows, 256 columns a block), 1 prefill (64 x 128 output tiles)
BLOCK_COLS = (256, 128)


def plan(tiles: int, TM: int, N: int, K: int, E: int, sms: int) -> tuple:
    """(config, splits) of a call over ``tiles`` m-tiles of ``TM`` rows.

    Prefill m-tiles (TM > 16) take one split: a chunk's m-tiles times the
    column blocks already fill the card several times. Decode takes the
    fewest splits whose runs fit the staged x slice (``DECODE_ROWS``), more
    when the m-tiles that can be live would leave SMs idle (about one block
    an SM, as ``quant_matmul.plan``). The live m-tiles are not read back: at
    most one an expert, ``tiles``, or the routed rows that ``Mp`` can hold
    beside the alignment padding of ``E + 1`` row groups (``ragged_layout``
    with an overflow bucket, as ``models/moe.py`` calls it)."""
    if TM > 16:
        return 1, 1
    stages = -(-(K // 2) // STAGE_ROWS[0])
    least = -(-stages // (DECODE_ROWS // STAGE_ROWS[0]))
    live = max(1, min(tiles, E, tiles * TM - (E + 1) * (TM - 1)))
    fill = max(1, sms // (live * -(-N // BLOCK_COLS[0])))
    s = min(max(least, min(fill, MAX_SPLITS)), stages)
    return 0, -(-stages // -(-stages // s))  # whole runs of ceil(stages / s) stages


def _entry():
    fn = _build.library("quant_ragged").zt_w4a16_ragged_matmul
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


_DEVICES: dict = {}


def _run(x, w_p, scales, zeros, tile_expert, num_occ, out, cfg_splits=None) -> None:
    """Launch the kernel on checked operands; ``cfg_splits`` overrides the
    plan (chip_smoke.py's sweep)."""
    Mp, K = x.shape
    E, N, G = w_p.shape[0], out.shape[1], scales.shape[1]
    tiles = tile_expert.shape[0]
    TM = Mp // tiles
    dev = _DEVICES.get(x.device)
    if dev is None:
        dev = _DEVICES[x.device] = SplitScratch(x.device)
    key = (tiles, TM, N, K, E)
    cfg, splits = cfg_splits or dev.plans.get(key) or dev.plans.setdefault(
        key, plan(tiles, TM, N, K, E, dev.sms))
    part = tickets = None
    if splits > 1:
        part, tickets = dev.scratch(splits, Mp, N, tiles * -(-N // BLOCK_COLS[cfg]))
    vec16 = int(N % 16 == 0 and w_p.data_ptr() % 16 == 0)
    err = _entry()(
        out.data_ptr(), x.data_ptr(), w_p.data_ptr(), scales.data_ptr(), zeros.data_ptr(),
        tile_expert.data_ptr(), num_occ.data_ptr(), part, tickets, tiles, TM, E, N, K, G, cfg,
        splits, vec16, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "w4a16_ragged_matmul")


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
    if x.dtype == torch.float16:  # as the reference's kernel: x to bf16, the result back
        return w4a16_ragged_matmul(x.to(torch.bfloat16), w_p, scales, zeros, tile_expert,
                                   num_occ).to(x.dtype)
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(f"w4a16_ragged_matmul kernel takes bf16 or fp16 activations, got {x.dtype}")
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
    _run(x, w_p, scales, zeros, tile_expert, num_occ, out)
    w4a16_ragged_matmul.launches += 1
    return out


w4a16_ragged_matmul.launches = 0
