"""Paged decode attention over the head-major packed K|V pool.

Counterpart of ``zhilight_tpu/ops/pallas/attn_headmajor.py``
``paged_decode_attention_hm`` (:151) in its default mode. The CUDA kernel is
``csrc/attn_headmajor.cu``; the plain PyTorch version is
:func:`paged_decode_attention_hm_plain` (page gather + ``ops.attention``).
:func:`paged_decode_attention_hm` takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises.

Like the TPU kernel, an empty slot (``context_lens[b] == 0``) yields zeros.
The flash-partial output (``emit_partial``, window side-KV) and the MLA
latent mode (``v_dim``) belong to later slices and raise.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_hm
from ..attention import decode_attention
from . import _build

__all__ = ["paged_decode_attention_hm", "paged_decode_attention_hm_plain"]


def paged_decode_attention_hm_plain(
    q: torch.Tensor,             # [B, Hq, D]
    kv_pool: torch.Tensor,       # [Hkv, N, 2D]
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    k, v = gather_hm(kv_pool, page_tables, page_size)  # [B, KV, Hkv, D]
    out = decode_attention(q, k, v, context_lens, scale, sliding_window)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0)


def _entry():
    fn = _build.library("attn_headmajor").zt_decode_attention_hm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_longlong, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_hm(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
    emit_partial: bool = False,
    v_dim: int = 0,
) -> torch.Tensor:
    """Attention output [B, Hq, D] of each slot's query over its first
    ``context_lens[b]`` pool tokens. The reference's flash-partial output
    (``emit_partial``) and MLA latent mode (``v_dim``) are not ported yet."""
    if emit_partial or v_dim:
        raise NotImplementedError("decode attention: emit_partial and v_dim are not ported yet")
    if q.device.type == "cpu":
        return paged_decode_attention_hm_plain(
            q, kv_pool, page_tables, context_lens, page_size, scale, sliding_window
        )
    if not q.is_cuda:
        raise NotImplementedError(f"decode attention: no kernel for device {q.device}")
    B, Hq, D = q.shape
    Hkv, N, D2 = kv_pool.shape
    if D2 != 2 * D or Hq % Hkv:
        raise ValueError(f"decode attention: q {tuple(q.shape)}, pool {tuple(kv_pool.shape)}")
    G = Hq // Hkv
    if q.dtype != torch.bfloat16 or kv_pool.dtype != torch.bfloat16:
        raise NotImplementedError(f"decode attention kernel takes bf16, got {q.dtype}/{kv_pool.dtype}")
    if not ((D == 64 and G <= 16) or (D == 128 and G <= 8)):
        raise NotImplementedError(f"decode attention kernel: head_dim {D} with group {G}")
    maxp = page_tables.shape[1]
    if page_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError("decode attention: page_tables and context_lens must be int32")
    if page_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("decode attention: page_tables [B, maxp], context_lens [B]")
    for t in (q, kv_pool, page_tables, context_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode attention: tensors must be contiguous and on one device")
    out = torch.empty_like(q)
    err = _entry()(
        out.data_ptr(), q.data_ptr(), kv_pool.data_ptr(), page_tables.data_ptr(),
        context_lens.data_ptr(), B, Hkv, G, D, N, maxp, page_size, float(scale),
        int(sliding_window), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_decode_attention_hm")
    paged_decode_attention_hm.launches += 1
    return out


paged_decode_attention_hm.launches = 0
