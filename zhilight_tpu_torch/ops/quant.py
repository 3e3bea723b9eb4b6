"""Quantized linear paths (counterpart of ``zhilight_tpu/ops/quant.py``).

Canonical formats, as the loader (``utils/hf_loader.py``) and the converters
(``utils/quant_convert.py``) produce them:

  int8:  {"w_q": int8 [in, out], "scale": f32 [out], "smooth"?: f32 [in]}
  int4:  {"w_p": uint8 [in/2, out] global-planar packed nibbles, or
                 int8 [in, out] nibble values 0..15,
          "scales": f32 [groups, out], "zeros": f32 [groups, out],
          "perm"?: int32 [in] (GPTQ act-order row permutation)}
  fp8:   {"w_f8": float8_e4m3fn [in, out],
          "scale": f32 [] | [out]  or  "block_scale": f32 [in/B, out/B]}

:func:`int4_linear` runs ``ops.cuda.quant_matmul.w4a16_matmul``: the
hand-written CUDA kernel for CUDA tensors, its plain PyTorch version for CPU
tensors. :func:`fp8_linear` sends a CUDA tensor over 128 x 128 block scales to
the hand-written ``ops.cuda.fp8_matmul.fp8_block_matmul`` and dequantizes in
every other case. :func:`int8_linear` (W8A8, SmoothQuant) is an int8 x int8
product with int32 accumulation through ``torch._int_mm``, as the reference
leaves it to ``lax.dot_general``.

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
    "quantize_int8_weight",
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


# ---------------------------------------------------------------------------
# INT8 (W8A8, SmoothQuant)
# ---------------------------------------------------------------------------

def quantize_int8_weight(w: torch.Tensor):
    """Per-output-channel absmax int8 quantization: w [in, out] ->
    (w_q int8, scale f32 [out])."""
    wf = w.float()
    scale = (wf.abs().amax(0) / 127.0).clamp_min(1e-8)
    w_q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return w_q, scale


def _quantize_act_per_token(x: torch.Tensor):
    """Dynamic per-token absmax int8 activation quantization: x [..., in] ->
    (q int8, scale f32 [..., 1]); round half to even, as the reference."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


# torch._int_mm on CUDA takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 32


def _int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact."""
    M, K = x_q.shape
    if not x_q.is_cuda:
        return torch._int_mm(x_q, w_q)
    if K % 8 or w_q.shape[1] % 8:
        raise NotImplementedError(
            f"int8_linear on CUDA: K {K} and N {w_q.shape[1]} must be multiples of 8")
    if M >= _INT_MM_MIN_ROWS:
        return torch._int_mm(x_q, w_q)
    # a decode batch: zero rows up to the library's minimum, sliced off again
    # (the activation scales were taken before, so a pad row touches none)
    padded = torch.zeros((_INT_MM_MIN_ROWS, K), dtype=torch.int8, device=x_q.device)
    padded[:M] = x_q
    return torch._int_mm(padded, w_q)[:M]


def int8_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """W8A8: smooth-scale x, dynamic per-token int8 quantization, an int8 x
    int8 product with int32 accumulation, then the two scales."""
    if "smooth" in p:
        x = x * p["smooth"].to(x.dtype)
    x_q, x_scale = _quantize_act_per_token(x)
    K = x_q.shape[-1]
    acc = _int8_matmul(x_q.reshape(-1, K), p["w_q"]).reshape(*x_q.shape[:-1], -1)
    y = acc.float() * x_scale * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# FP8
# ---------------------------------------------------------------------------

def fp8_linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """FP8 (e4m3) weight linear with a per-tensor or per-channel ``scale`` or
    block scales. A CUDA tensor over 128 x 128 blocks goes to the
    ``fp8_block_matmul`` kernel (bf16 activations, the weight read as one
    byte each and never dequantized in device memory); every other case
    dequantizes in fp32, rounds the weight to x's dtype and multiplies."""
    w = p["w_f8"]
    if "block_scale" in p:
        bs = p["block_scale"]  # [in/B, out/B]
        K, N = w.shape
        if x.is_cuda and K % 128 == 0 and N % 128 == 0 and bs.shape == (K // 128, N // 128):
            from .cuda.fp8_matmul import fp8_block_matmul

            return fp8_block_matmul(x.to(torch.bfloat16), w, bs).to(x.dtype)
        Bk, Bn = K // bs.shape[0], N // bs.shape[1]
        wf = w.float().reshape(bs.shape[0], Bk, bs.shape[1], Bn) * bs[:, None, :, None]
        w_deq = wf.reshape(K, N).to(x.dtype)
    else:
        w_deq = (w.float() * p["scale"]).to(x.dtype)
    return torch.matmul(x, w_deq)
