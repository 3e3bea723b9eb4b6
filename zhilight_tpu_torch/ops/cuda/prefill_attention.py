"""Chunked-prefill flash attention over the head-major packed K|V pool.

Counterpart of ``zhilight_tpu/ops/pallas/prefill_attention.py``
``paged_prefill_attention_hm_packed`` (:255) and its one-segment wrapper
``paged_prefill_attention_hm`` (:227). The CUDA kernel is
``csrc/prefill_attention.cu``; the plain PyTorch version is
:func:`paged_prefill_attention_hm_packed_plain` (per-segment page gather +
``ops.attention.prefill_attention``). The wrappers take the plain version
only for CPU tensors; for CUDA tensors they launch the kernel or raise.

The pool must already hold the chunk's K/V (the write runs first). Only rows
``i < q_lens[s]`` of each segment are meaningful; padding rows and segments
with ``q_len == 0`` come out finite, and the host discards them.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_hm
from ..attention import prefill_attention
from . import _build

__all__ = [
    "paged_prefill_attention_hm",
    "paged_prefill_attention_hm_packed",
    "paged_prefill_attention_hm_packed_plain",
]


def paged_prefill_attention_hm_packed_plain(
    q: torch.Tensor,            # [NS*TC, Hq, D]
    kv_pool: torch.Tensor,      # [Hkv, N, 2D]
    page_tables: torch.Tensor,  # [NS, maxp] int; < 0 => padding
    cache_lens: torch.Tensor,   # [NS] int
    q_lens: torch.Tensor,       # [NS] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    NS = page_tables.shape[0]
    TC = q.shape[0] // NS
    outs = []
    for s in range(NS):
        k, v = gather_hm(kv_pool, page_tables[s], page_size)  # [KV, Hkv, D]
        outs.append(
            prefill_attention(
                q[s * TC : (s + 1) * TC], k, v, cache_lens[s], q_lens[s], scale,
                sliding_window,
            )
        )
    return torch.cat(outs, dim=0)


def _entry():
    fn = _build.library("prefill_attention").zt_prefill_attention_hm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, i,
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_prefill_attention_hm_packed(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    page_tables: torch.Tensor,
    cache_lens: torch.Tensor,
    q_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """NS packed prefill segments of TC tokens each; returns [NS*TC, Hq, D]."""
    if q.device.type == "cpu":
        return paged_prefill_attention_hm_packed_plain(
            q, kv_pool, page_tables, cache_lens, q_lens, page_size, scale,
            sliding_window,
        )
    if not q.is_cuda:
        raise NotImplementedError(f"prefill attention: no kernel for device {q.device}")
    T, Hq, D = q.shape
    Hkv, N, D2 = kv_pool.shape
    NS, maxp = page_tables.shape
    if D2 != 2 * D or Hq % Hkv or T % NS:
        raise ValueError(
            f"prefill attention: q {tuple(q.shape)}, pool {tuple(kv_pool.shape)}, {NS} segments"
        )
    if q.dtype != torch.bfloat16 or kv_pool.dtype != torch.bfloat16:
        raise NotImplementedError(f"prefill attention kernel takes bf16, got {q.dtype}/{kv_pool.dtype}")
    if D not in (64, 128):
        raise NotImplementedError(f"prefill attention kernel: head_dim {D}")
    for t in (page_tables, cache_lens, q_lens):
        if t.dtype != torch.int32:
            raise ValueError("prefill attention: page tables and lengths must be int32")
    if cache_lens.shape != (NS,) or q_lens.shape != (NS,):
        raise ValueError("prefill attention: cache_lens and q_lens must be [NS]")
    for t in (q, kv_pool, page_tables, cache_lens, q_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("prefill attention: tensors must be contiguous and on one device")
    out = torch.empty_like(q)
    err = _entry()(
        out.data_ptr(), q.data_ptr(), kv_pool.data_ptr(), page_tables.data_ptr(),
        cache_lens.data_ptr(), q_lens.data_ptr(), NS, T // NS, Hq, Hkv, D, N, maxp,
        page_size, float(scale), int(sliding_window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_prefill_attention_hm_packed")
    paged_prefill_attention_hm_packed.launches += 1
    return out


paged_prefill_attention_hm_packed.launches = 0


def paged_prefill_attention_hm(
    q: torch.Tensor,           # [T, Hq, D]
    kv_pool: torch.Tensor,     # [Hkv, N, 2D]
    page_table: torch.Tensor,  # [maxp] int32
    cache_len,                 # int or 0-d int32 tensor
    q_len,                     # int or 0-d int32 tensor
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """One sequence's chunk: the packed kernel with a single segment."""
    lens = dict(dtype=torch.int32, device=q.device)
    return paged_prefill_attention_hm_packed(
        q,
        kv_pool,
        page_table.reshape(1, -1),
        torch.as_tensor(cache_len, **lens).reshape(1),
        torch.as_tensor(q_len, **lens).reshape(1),
        page_size,
        scale,
        sliding_window,
    )
