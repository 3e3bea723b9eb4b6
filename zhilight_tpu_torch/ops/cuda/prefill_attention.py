"""Chunked-prefill flash attention over the head-major packed K|V pool.

Counterpart of ``zhilight_tpu/ops/pallas/prefill_attention.py``
``paged_prefill_attention_hm_packed`` (:255) and its one-segment wrapper
``paged_prefill_attention_hm`` (:227), and of their int8-pool forms
``paged_prefill_attention_hm_packed_q`` (:503) and
``paged_prefill_attention_hm_q`` (:644). The CUDA kernels are
``csrc/prefill_attention.cu`` and ``csrc/prefill_attention_q.cu``; the plain
PyTorch versions are :func:`paged_prefill_attention_hm_packed_plain`
(per-segment page gather + ``ops.attention.prefill_attention``) and
:func:`paged_prefill_attention_hm_packed_q_plain`. The wrappers take the plain
versions only for CPU tensors; for CUDA tensors they launch the kernel or
raise.

The int8 functions fold the per-(token, KV head) K scale into the fp32 scores
and the V scale into the probabilities, which are rounded to q's dtype before
the second product, as the TPU kernel does; K and V elements are never
multiplied by a scale. The scales are head-major ``[Hkv, >= N]``
(``kvcache/paged.py``), where the reference keeps them ``[N, Hkv]``.

Both kernels take head_dim 64, 128, 192 and 256.

The plain versions round the normalized probabilities (times the V scale
over an int8 pool) before the second product, as the XLA path does; the
twins (:func:`paged_prefill_attention_hm_packed_twin`,
:func:`paged_prefill_attention_hm_packed_q_twin`) round the unnormalized p,
as the kernels do, and divide by ``l`` last.

The pool must already hold the chunk's K/V (the write runs first). Only rows
``i < q_lens[s]`` of each segment are meaningful; padding rows and segments
with ``q_len == 0`` come out finite, and the host discards them.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_hm, gather_scales
from ..attention import NEG_INF, prefill_attention
from . import _build
from .attn_headmajor import BF16_HEAD_DIMS, check_scales

__all__ = [
    "paged_prefill_attention_hm",
    "paged_prefill_attention_hm_packed",
    "paged_prefill_attention_hm_packed_plain",
    "paged_prefill_attention_hm_packed_twin",
    "paged_prefill_attention_hm_q",
    "paged_prefill_attention_hm_packed_q",
    "paged_prefill_attention_hm_packed_q_plain",
    "paged_prefill_attention_hm_packed_q_twin",
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


def _segment_twin(q, k, v, cache_len, q_len, scale, sliding_window, round_dtype, ks=None,
                  vs=None):
    """One segment in the kernels' rounding order: the unnormalized ``p =
    exp(s - m)`` (times ``vs``, an int8 pool's V scales) rounded to
    ``round_dtype`` before P.V, ``l`` summing the unscaled p, the division by
    ``max(l, 1e-20)`` last. q [TC, Hq, D]; k, v [KV, Hkv, D]; ks, vs [Hkv, KV]."""
    TC, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(TC, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
    if ks is not None:
        scores = scores * ks[:, None, None]
    q_pos = cache_len + torch.arange(TC, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[0], device=q.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos < cache_len + q_len)
    if sliding_window > 0:
        mask &= k_pos > q_pos - sliding_window
    s = torch.where(mask, scores, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1)                                        # [Hkv, G, TC]
    if vs is not None:
        p = p * vs[:, None, None]
    acc = torch.einsum("kgts,skd->tkgd", p.to(round_dtype).float(), v.float())
    out = acc / l.clamp_min(1e-20).permute(2, 0, 1)[..., None]
    return out.reshape(TC, Hq, D).to(q.dtype)


def paged_prefill_attention_hm_packed_twin(
    q: torch.Tensor,            # [NS*TC, Hq, D]
    kv_pool: torch.Tensor,      # [Hkv, N, 2D]
    page_tables: torch.Tensor,  # [NS, maxp] int; < 0 => padding
    cache_lens: torch.Tensor,   # [NS] int
    q_lens: torch.Tensor,       # [NS] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """The plain version in the kernels' rounding order (the TPU kernel's and
    the CUDA kernel's): the unnormalized p rounded to the pool's dtype before
    P.V, the division by ``max(l, 1e-20)`` last, where
    :func:`paged_prefill_attention_hm_packed_plain` rounds the normalized
    probabilities, as the XLA path does. One max a row where the kernels keep
    a running one."""
    NS = page_tables.shape[0]
    TC = q.shape[0] // NS
    outs = []
    for s in range(NS):
        k, v = gather_hm(kv_pool, page_tables[s], page_size)  # [KV, Hkv, D]
        outs.append(_segment_twin(q[s * TC : (s + 1) * TC], k, v, cache_lens[s], q_lens[s], scale,
                                  sliding_window, kv_pool.dtype))
    return torch.cat(outs, dim=0)


def _entry():
    fn = _build.library("prefill_attention").zt_prefill_attention_hm
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, ctypes.c_longlong, i, i,
                       ctypes.c_float, i, i, p]
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
    fp16 = _build.elem_flag("prefill attention (q and pool)", q, kv_pool)
    if D not in BF16_HEAD_DIMS:
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
        page_size, float(scale), int(sliding_window), fp16,
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
    return paged_prefill_attention_hm_packed(
        q, kv_pool, *_one_segment(q, page_table, cache_len, q_len), page_size, scale,
        sliding_window,
    )


def _one_segment(q, page_table, cache_len, q_len):
    """(page_tables [1, maxp], cache_lens [1], q_lens [1]) of one sequence."""
    lens = dict(dtype=torch.int32, device=q.device)
    return (
        page_table.reshape(1, -1),
        torch.as_tensor(cache_len, **lens).reshape(1),
        torch.as_tensor(q_len, **lens).reshape(1),
    )


# ---------------------------------------------------------------------------
# int8 pool
# ---------------------------------------------------------------------------

def paged_prefill_attention_hm_packed_q_plain(
    q: torch.Tensor,            # [NS*TC, Hq, D]
    kv_pool: torch.Tensor,      # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,     # [Hkv, >= N] f32
    v_scales: torch.Tensor,     # [Hkv, >= N] f32
    page_tables: torch.Tensor,  # [NS, maxp] int; < 0 => padding
    cache_lens: torch.Tensor,   # [NS] int
    q_lens: torch.Tensor,       # [NS] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    NS = page_tables.shape[0]
    T, Hq, D = q.shape
    TC, Hkv = T // NS, kv_pool.shape[0]
    outs = []
    for s in range(NS):
        k, v = gather_hm(kv_pool, page_tables[s], page_size)        # [KV, Hkv, D] int8
        ks = gather_scales(k_scales, page_tables[s], page_size).t()  # [Hkv, KV]
        vs = gather_scales(v_scales, page_tables[s], page_size).t()
        qg = q[s * TC : (s + 1) * TC].reshape(TC, Hkv, Hq // Hkv, D).float()
        scores = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
        scores = scores * ks[:, None, None]

        q_pos = cache_lens[s] + torch.arange(TC, device=q.device)[:, None]
        k_pos = torch.arange(k.shape[0], device=q.device)[None, :]
        mask = (k_pos <= q_pos) & (k_pos < cache_lens[s] + q_lens[s])
        if sliding_window > 0:
            mask &= k_pos > q_pos - sliding_window
        scores = torch.where(mask, scores, NEG_INF)

        probs = torch.softmax(scores, dim=-1) * vs[:, None, None]
        out = torch.einsum("kgts,skd->tkgd", probs.to(q.dtype).float(), v.float())
        outs.append(out.reshape(TC, Hq, D).to(q.dtype))
    return torch.cat(outs, dim=0)


def paged_prefill_attention_hm_packed_q_twin(
    q: torch.Tensor,            # [NS*TC, Hq, D]
    kv_pool: torch.Tensor,      # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,     # [Hkv, >= N] f32
    v_scales: torch.Tensor,     # [Hkv, >= N] f32
    page_tables: torch.Tensor,  # [NS, maxp] int; < 0 => padding
    cache_lens: torch.Tensor,   # [NS] int
    q_lens: torch.Tensor,       # [NS] int
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """The int8 plain version in the kernels' rounding order: ``p *
    v_scale`` of the unnormalized p rounded to q's dtype before P.V, ``l``
    summing the unscaled p, the division last
    (:func:`paged_prefill_attention_hm_packed_q_plain` rounds ``softmax *
    v_scale``)."""
    NS = page_tables.shape[0]
    TC = q.shape[0] // NS
    outs = []
    for s in range(NS):
        k, v = gather_hm(kv_pool, page_tables[s], page_size)        # [KV, Hkv, D] int8
        ks = gather_scales(k_scales, page_tables[s], page_size).t()  # [Hkv, KV]
        vs = gather_scales(v_scales, page_tables[s], page_size).t()
        outs.append(_segment_twin(q[s * TC : (s + 1) * TC], k, v, cache_lens[s], q_lens[s], scale,
                                  sliding_window, q.dtype, ks, vs))
    return torch.cat(outs, dim=0)


def _entry_q():
    fn = _build.library("prefill_attention_q").zt_prefill_attention_hm_q
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ll, ll, i, i,
                       ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_prefill_attention_hm_packed_q(
    q: torch.Tensor,
    kv_pool: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    page_tables: torch.Tensor,
    cache_lens: torch.Tensor,
    q_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """NS packed prefill segments of TC tokens each over the int8 pool;
    returns [NS*TC, Hq, D]."""
    if q.device.type == "cpu":
        return paged_prefill_attention_hm_packed_q_plain(
            q, kv_pool, k_scales, v_scales, page_tables, cache_lens, q_lens, page_size,
            scale, sliding_window,
        )
    if not q.is_cuda:
        raise NotImplementedError(f"int8 prefill attention: no kernel for device {q.device}")
    T, Hq, D = q.shape
    Hkv, N, D2 = kv_pool.shape
    NS, maxp = page_tables.shape
    if D2 != 2 * D or Hq % Hkv or T % NS:
        raise ValueError(
            f"int8 prefill attention: q {tuple(q.shape)}, pool {tuple(kv_pool.shape)}, {NS} segments"
        )
    if kv_pool.dtype != torch.int8:
        raise NotImplementedError(f"int8 prefill attention kernel takes an int8 pool, got "
                                  f"{kv_pool.dtype}")
    fp16 = _build.elem_flag("int8 prefill attention (q)", q)
    if D not in BF16_HEAD_DIMS:
        raise NotImplementedError(f"int8 prefill attention kernel: head_dim {D}")
    check_scales("int8 prefill attention", kv_pool, k_scales, v_scales)
    for t in (page_tables, cache_lens, q_lens):
        if t.dtype != torch.int32:
            raise ValueError("int8 prefill attention: page tables and lengths must be int32")
    if cache_lens.shape != (NS,) or q_lens.shape != (NS,):
        raise ValueError("int8 prefill attention: cache_lens and q_lens must be [NS]")
    for t in (q, kv_pool, page_tables, cache_lens, q_lens):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("int8 prefill attention: tensors must be contiguous and on one device")
    out = torch.empty_like(q)
    err = _entry_q()(
        out.data_ptr(), q.data_ptr(), kv_pool.data_ptr(), k_scales.data_ptr(),
        v_scales.data_ptr(), page_tables.data_ptr(), cache_lens.data_ptr(), q_lens.data_ptr(),
        NS, T // NS, Hq, Hkv, D, N, k_scales.stride(0), maxp, page_size, float(scale),
        int(sliding_window), fp16, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_prefill_attention_hm_packed_q")
    paged_prefill_attention_hm_packed_q.launches += 1
    return out


paged_prefill_attention_hm_packed_q.launches = 0


def paged_prefill_attention_hm_q(
    q: torch.Tensor,           # [T, Hq, D]
    kv_pool: torch.Tensor,     # [Hkv, N, 2D] int8
    k_scales: torch.Tensor,    # [Hkv, >= N] f32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [maxp] int32
    cache_len,                 # int or 0-d int32 tensor
    q_len,                     # int or 0-d int32 tensor
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """One sequence's chunk over the int8 pool: the packed kernel with a
    single segment."""
    return paged_prefill_attention_hm_packed_q(
        q, kv_pool, k_scales, v_scales, *_one_segment(q, page_table, cache_len, q_len),
        page_size, scale, sliding_window,
    )
