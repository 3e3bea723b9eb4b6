"""Quantized linear paths (counterpart of ``zhilight_tpu/ops/quant.py``).

The port carries the int4 half: GPTQ/AWQ W4A16 linears in the canonical
format the loader produces (``utils/hf_loader.py``):

  int4:  {"w_p": uint8 [in/2, out] global-planar packed nibbles, or
                 int8 [in, out] nibble values 0..15,
          "scales": f32 [groups, out], "zeros": f32 [groups, out],
          "perm"?: int32 [in] (GPTQ act-order row permutation)}

:func:`int4_linear` runs ``ops.cuda.quant_matmul.w4a16_matmul``: the
hand-written CUDA kernel for CUDA tensors, its plain PyTorch version for CPU
tensors. W8A8 int8 and FP8 linears are later slices and raise.

MoE expert stacks keep the same format with a leading expert dimension
(``w_p`` uint8 ``[E, in/2, out]``, each expert planar-packed on its own:
:func:`pack_expert_int4`); :func:`ragged_layout` lays routed rows out in
expert-aligned tiles for ``ops.cuda.quant_ragged.w4a16_ragged_matmul``
(counterparts of ``zhilight_tpu/ops/pallas/quant_ragged.py``
``pack_expert_int4`` and ``ragged_layout``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = [
    "INT4_PACK_FORMAT",
    "int4_linear",
    "int8_linear",
    "fp8_linear",
    "pack_int4",
    "unpack_int4",
    "dequant_int4",
    "pack_expert_int4",
    "unpack_expert_int4",
    "dequant_expert_int4",
    "ragged_layout",
]

# On-wire packed-int4 format version of the reference (v2: global-planar,
# high plane stored XOR 8). utils/quant_convert.gptq_planar_qweight builds
# the same layout without calling pack_int4 and checks against this.
INT4_PACK_FORMAT = 2


def int4_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """W4A16 groupwise linear: ``x · ((w - zero_g) · scale_g)``."""
    from .cuda import quant_matmul

    Kw = p["w_p"].shape[-2] * (2 if p["w_p"].dtype == torch.uint8 else 1)
    if x.shape[-1] < Kw:
        # the loader padded K to a multiple of 2*group_size with zero-scale
        # groups (hf_loader._pad_canon_int4): pad the activation columns
        x = F.pad(x, (0, Kw - x.shape[-1]))
    if "perm" in p:
        # GPTQ act-order: the loader sorted the weight rows so each group is
        # contiguous; gather the activations with the same permutation
        x = x.index_select(-1, p["perm"])
    return quant_matmul.w4a16_matmul(x, p["w_p"], p["scales"], p["zeros"])


def pack_int4(w_nib: torch.Tensor) -> torch.Tensor:
    """Nibble weights [K, N] (values 0..15, int8) -> uint8 [K/2, N] in the
    global-planar layout: low nibbles hold rows [0, K/2), high nibbles rows
    [K/2, K) stored XOR 8."""
    K = w_nib.shape[0]
    lo = w_nib[: K // 2].to(torch.uint8)
    hi = w_nib[K // 2 :].to(torch.uint8) ^ 8
    return lo | (hi << 4)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 [K/2, N] -> int8 nibbles [K, N]."""
    lo = (w_packed & 0xF).to(torch.int8)
    hi = ((w_packed >> 4) ^ 8).to(torch.int8)
    return torch.cat([lo, hi], dim=0)


def dequant_int4(
    w_p: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """w_p int8 nibbles [K, N] or packed uint8 [K/2, N]; scales/zeros
    [G, N]; group = K/G consecutive rows. Returns [K, N] in ``dtype``,
    computed in fp32 and rounded once."""
    if w_p.dtype == torch.uint8:
        w_p = unpack_int4(w_p)
    K, N = w_p.shape
    G = scales.shape[0]
    wf = w_p.to(torch.float32).reshape(G, K // G, N)
    w = (wf - zeros[:, None, :]) * scales[:, None, :]
    return w.reshape(K, N).to(dtype)


def pack_expert_int4(w_nib: torch.Tensor) -> torch.Tensor:
    """Per-expert planar pack: int8 nibble stack [E, K, N] -> uint8
    [E, K/2, N]; within each expert the layout is :func:`pack_int4`'s."""
    K = w_nib.shape[1]
    lo = w_nib[:, : K // 2].to(torch.uint8)
    hi = w_nib[:, K // 2 :].to(torch.uint8) ^ 8
    return lo | (hi << 4)


def unpack_expert_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_expert_int4`: uint8 [E, K/2, N] -> int8 [E, K, N]."""
    lo = (w_packed & 0xF).to(torch.int8)
    hi = ((w_packed >> 4) ^ 8).to(torch.int8)
    return torch.cat([lo, hi], dim=1)


def dequant_expert_int4(
    w_p: torch.Tensor, scales: torch.Tensor, zeros: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """:func:`dequant_int4` over a stack: w_p uint8 [E, K/2, N] or int8
    [E, K, N]; scales/zeros [E, G, N]. Returns [E, K, N] in ``dtype``."""
    if w_p.dtype == torch.uint8:
        w_p = unpack_expert_int4(w_p)
    E, K, N = w_p.shape
    G = scales.shape[1]
    wf = w_p.to(torch.float32).reshape(E, G, K // G, N)
    w = (wf - zeros[:, :, None, :]) * scales[:, :, None, :]
    return w.reshape(E, K, N).to(dtype)


def ragged_layout(flat_experts: torch.Tensor, num_experts: int, tm: int, occ_experts: int = 0):
    """Expert-aligned padded row layout for ``w4a16_ragged_matmul``.

    flat_experts: [R] expert id of each (token, k) pair, unsorted. Returns
    (sort_idx [R], dest [R], tile_expert [Mp/tm] int32, num_occ [1] int32, Mp):
    ``dest[i]`` is the padded row of sorted row i (rows sorted by expert,
    stably), every expert's rows start at a multiple of ``tm``,
    ``tile_expert`` names each m-tile's expert and ``num_occ`` counts the
    occupied m-tiles, which are a prefix. ``Mp`` is the static worst case
    ``R + E * (tm - 1)`` rounded up to ``tm``. ``occ_experts`` (if non-zero)
    counts only the first ``occ_experts`` groups toward ``num_occ`` and caps
    ``tile_expert`` there: later groups are overflow buckets whose rows are
    never computed. Everything stays on the tensor's device: nothing here
    waits for it."""
    R = flat_experts.shape[0]
    E = num_experts
    dev = flat_experts.device
    mp = ((R + E * (tm - 1)) + tm - 1) // tm * tm
    flat = flat_experts.long()
    # a count by comparison: torch.bincount reads its maximum back to the host
    sizes = (flat[:, None] == torch.arange(E, device=dev)[None, :]).sum(0)
    padded = (sizes + tm - 1) // tm * tm
    p_ends = torch.cumsum(padded, 0)
    p_starts = p_ends - padded
    starts = torch.cumsum(sizes, 0) - sizes
    sort_idx = torch.argsort(flat, stable=True)
    es = flat[sort_idx]
    rank = torch.arange(R, device=dev) - starts[es]
    dest = p_starts[es] + rank
    tile_starts = torch.arange(mp // tm, device=dev) * tm
    cap = (occ_experts or E) - 1
    tile_expert = torch.searchsorted(p_ends, tile_starts, right=True).clamp(0, cap)
    occ_end = p_ends[occ_experts - 1] if occ_experts else p_ends[-1]
    num_occ = (occ_end // tm).to(torch.int32).reshape(1)
    return sort_idx, dest, tile_expert.to(torch.int32), num_occ, mp


def int8_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError("W8A8 int8 linears are not ported yet")


def fp8_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError("FP8 linears are not ported yet")
