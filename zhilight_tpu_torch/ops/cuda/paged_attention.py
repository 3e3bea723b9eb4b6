"""Paged decode attention over separate slot-major K and V pools.

Counterpart of ``zhilight_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention`` (:364) and ``paged_decode_attention_q`` (:971), the
decode kernels of the pools that the reference keeps slot-major
(``[N, Hkv, D]`` per layer, whenever ``2*head_dim % 128 != 0``). The CUDA
kernels are ``csrc/paged_attention.cu`` (bf16 pools) and
``csrc/paged_attention_q.cu`` (int8 pools with fp32 scales per token and KV
head), one template in ``csrc/paged_decode.cuh``; the plain PyTorch versions
are :func:`paged_decode_attention_plain` and
:func:`paged_decode_attention_q_plain`. The wrappers take the plain versions
only for CPU tensors; for CUDA tensors they launch the kernel or raise.

The pools may carry a leading unit dimension, ``[1, N, Hkv, D]``, as
``kvcache/paged.py`` holds them. The int8 scales are head-major
``[Hkv, >= N]`` (the reference keeps them ``[N, Hkv]``).

The plain versions follow the Pallas kernels, not the XLA path: an empty slot
(``context_lens[b] == 0``) gives zeros (the XLA path gives the mean of V), int8
rows are dequantized in fp32 and never rounded, and the probabilities are not
rounded to V's dtype. The reference's ``pages_per_block``, ``use_blockspec``,
``packed``, ``fetch_pages`` and ``interpret`` arguments choose how its TPU
kernels fetch pages and are dropped.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_scales, slot_indices
from ..attention import NEG_INF
from . import _build
from .attn_headmajor import check_scales

__all__ = [
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_decode_attention_q",
    "paged_decode_attention_q_plain",
]

# the kernels' largest head dim (csrc/paged_decode.cuh DMAX)
MAX_HEAD_DIM = 256
# blocks the kernels aim to keep in flight: two per SM of an H100
_TARGET_BLOCKS = 2 * 132


def _pool3(pool: torch.Tensor) -> torch.Tensor:
    """The pool as [N, Hkv, D]: a leading unit dimension is dropped (a view)."""
    if pool.dim() == 4 and pool.shape[0] == 1:
        return pool[0]
    if pool.dim() != 3:
        raise ValueError(f"paged decode attention: pool must be [N, Hkv, D] or [1, N, Hkv, D], "
                         f"got {tuple(pool.shape)}")
    return pool


def _attend(q, k, v, context_lens, scale, sliding_window) -> torch.Tensor:
    """fp32 attention of q [B, Hq, D] over gathered k, v [B, KV, Hkv, D]
    (fp32): the Pallas kernels' softmax, probabilities unrounded, an empty
    slot zero. Returns [B, Hq, D] in q's dtype."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    ctx = context_lens[:, None]
    mask = k_pos < ctx
    if sliding_window > 0:
        mask &= k_pos > ctx - 1 - sliding_window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    out = torch.einsum("bkgs,bskd->bkgd", torch.softmax(scores, dim=-1), v)
    out = out.reshape(B, Hq, D).to(q.dtype)
    return out.masked_fill((context_lens <= 0)[:, None, None], 0)


def paged_decode_attention_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages: torch.Tensor,       # [N, Hkv, D] or [1, N, Hkv, D]
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    slots = slot_indices(page_tables, page_size)  # [B, KV]
    k = _pool3(k_pages)[slots].float()
    v = _pool3(v_pages)[slots].float()
    return _attend(q, k, v, context_lens, scale, sliding_window)


def paged_decode_attention_q_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages: torch.Tensor,       # [N, Hkv, D] int8 (or [1, N, Hkv, D])
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,      # [Hkv, >= N] f32
    v_scales: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    slots = slot_indices(page_tables, page_size)
    ks = gather_scales(k_scales, page_tables, page_size)  # [B, KV, Hkv]
    vs = gather_scales(v_scales, page_tables, page_size)
    k = _pool3(k_pages)[slots].float() * ks[..., None]
    v = _pool3(v_pages)[slots].float() * vs[..., None]
    return _attend(q, k, v, context_lens, scale, sliding_window)


def _max_splits(B: int, Hkv: int, max_ctx: int) -> int:
    """The most context ranges the partial buffers hold: at least 128 tokens
    a range, and no more than one query-row group a block needs to reach
    ``_TARGET_BLOCKS``. The kernel picks the count within it from its own
    groups (csrc/paged_decode.cuh ``dispatch``) and reads the real lengths;
    a range without tokens writes an empty partial."""
    return max(min(-(-_TARGET_BLOCKS // (B * Hkv)), -(-max_ctx // 128)), 1)


def _entry(quant: bool):
    name = "paged_attention_q" if quant else "paged_attention"
    lib = _build.library(name)
    fn = lib.zt_paged_decode_attention_q if quant else lib.zt_paged_decode_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        scales = [p, p] if quant else []
        stride = [ll] if quant else []
        fn.argtypes = ([p, p, p, p, p, p] + scales + [p, p, i, i, i, i, ll] + stride
                       + [i, i, ctypes.c_float, i, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _launch(what, q, k_pages, v_pages, scales, page_tables, context_lens, page_size, scale,
            sliding_window) -> torch.Tensor:
    """Check the inputs of a CUDA decode and launch its kernel, or raise."""
    if not q.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {q.device}")
    kp, vp = _pool3(k_pages), _pool3(v_pages)
    B, Hq, D = q.shape
    N, Hkv, Dk = kp.shape
    if vp.shape != kp.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {tuple(v_pages.shape)}")
    pool_dtype = torch.int8 if scales else torch.bfloat16
    if q.dtype != torch.bfloat16 or kp.dtype != pool_dtype or vp.dtype != pool_dtype:
        raise NotImplementedError(f"{what} kernel takes bf16 q and {pool_dtype} pools, "
                                  f"got {q.dtype}/{kp.dtype}/{vp.dtype}")
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"{what} kernel: head_dim {D} > {MAX_HEAD_DIM}")
    if scales:
        # check_scales reads (Hkv, N) from a [Hkv, N, X] pool
        check_scales(what, kp.transpose(0, 1), *scales)
    maxp = page_tables.shape[1]
    if page_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise ValueError(f"{what}: page_tables and context_lens must be int32")
    if page_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError(f"{what}: page_tables [B, maxp], context_lens [B]")
    for t in (q, kp, vp, page_tables, context_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one device")
    G = Hq // Hkv
    max_splits = _max_splits(B, Hkv, maxp * page_size)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, Hq, max_splits, D) if max_splits > 1 else (1,), **f32)
    part_ml = torch.empty((B, Hq, max_splits, 2) if max_splits > 1 else (1,), **f32)
    out = torch.empty_like(q)
    ptrs = [out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), q.data_ptr(),
            kp.data_ptr(), vp.data_ptr()]
    if scales:
        ptrs += [scales[0].data_ptr(), scales[1].data_ptr()]
    stride = [scales[0].stride(0)] if scales else []
    err = _entry(bool(scales))(
        *ptrs, page_tables.data_ptr(), context_lens.data_ptr(), B, Hkv, G, D, N, *stride,
        maxp, page_size, float(scale), int(sliding_window), _TARGET_BLOCKS, max_splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, what)
    return out


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Attention output [B, Hq, D] of each slot's query over its first
    ``context_lens[b]`` tokens of the slot-major K and V pools."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, page_tables, context_lens, page_size, scale, sliding_window
        )
    out = _launch("paged_decode_attention", q, k_pages, v_pages, (), page_tables,
                  context_lens, page_size, scale, sliding_window)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def paged_decode_attention_q(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Attention output [B, Hq, D] over the int8 slot-major pools: the K
    scale multiplies the fp32 score, the V scale the fp32 probability."""
    if q.device.type == "cpu":
        return paged_decode_attention_q_plain(
            q, k_pages, v_pages, k_scales, v_scales, page_tables, context_lens, page_size,
            scale, sliding_window,
        )
    out = _launch("paged_decode_attention_q", q, k_pages, v_pages, (k_scales, v_scales),
                  page_tables, context_lens, page_size, scale, sliding_window)
    paged_decode_attention_q.launches += 1
    return out


paged_decode_attention_q.launches = 0
