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

The template is a split-context flash decode on tensor cores (``mma.sync``),
one launch a layer, at any head_dim from 1 to 256 and any number of query
heads per KV head: 64-token tiles gathered through the page table into a
ring of ``cp.async`` stages, each row zero-padded to a multiple of 16
columns. Each call cuts every context over as many blocks as fill the card
once (``attn_headmajor.decode_splits`` with the kernel's own occupancy) and
the last block of each (sequence, head group) merges the partials, drawing
tickets from the per-device buffer that the head-major decodes share
(``attn_headmajor._tickets``); the wrapper allocates the partials per call.
Its bound is bytes: K and V rows read once. Nothing is rounded before the
output: the probabilities (times the V scales over int8) go into P.V as two
bf16 halves, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, and ``l`` sums the
fp32 ``p``. What holds it back (the header of ``csrc/paged_decode.cuh``):
every warp runs its copies, products and softmax in turn, and the split P.V
doubles the second product.

The pools may carry a leading unit dimension, ``[1, N, Hkv, D]``, as
``kvcache/paged.py`` holds them. The int8 scales are head-major
``[Hkv, >= N]`` (the reference keeps them ``[N, Hkv]``).

The plain versions follow the Pallas kernels, not the XLA path: an empty slot
(``context_lens[b] == 0``) gives zeros (the XLA path gives the mean of V), int8
rows are dequantized in fp32 and never rounded, and the probabilities are not
rounded to V's dtype. The reference's ``pages_per_block``, ``use_blockspec``,
``packed``, ``fetch_pages`` and ``interpret`` arguments choose how its TPU
kernels fetch pages and are dropped.

The fused decode (``ZT_FUSED_KV=1``) writes each sequence's new row into the
pool and attends in one launch: :func:`paged_decode_attention_fused` over the
two slot-major bf16 pools or the packed single pool (``v_pages=None``, rows
``[N, Hkv, 2D]``, K lanes ``[:D]``, V lanes ``[D:]``), the counterpart of
``paged_decode_attention_fused`` (:644), and :func:`paged_mla_decode_fused`
over the latent pool (K the whole row, V its first ``v_dim`` columns), the
counterpart of ``paged_mla_decode_fused`` (:844); one TPU kernel,
``_kernel_bs_fused`` (:445). Their CUDA kernels are
``csrc/paged_attention_fused.cu`` (the decode template's fused flag) and the
fused mode of ``csrc/mla_decode.cu``. ``context_lens`` count the current
token, whose rows come from ``k_new`` / ``v_new`` (cast to the pool's dtype
first) and never from the pool: pool tokens ``t < ctx - 1`` are attended (and
``t >= ctx - sliding_window``). The kernel never reads row ``ctx - 1``: another
block writes it during the launch. The new token's column is folded in by the
block that writes the output, the splits' merge included. A frozen slot
(``slot_mapping[b] < 0``) is not written but still attends to its new row,
and an empty one (``ctx == 0``) gives its new V row and is not written
either, as the TPU kernel does. Scores, probabilities and sums are fp32 and
unrounded in every mode (the kernels put p through P.V as two bf16 halves,
hi = bf16(p) and lo = bf16(p - hi)). The latent kernel is the split-context
decode of ``ops/cuda/attn_headmajor.paged_mla_decode`` in its fused mode, one
launch a layer; its header (``csrc/mla_decode.cu``) says what holds it back.
The pools are
written in place (at ``slot_mapping[b]``; the TPU kernel rewrites the slot's
page, row ``(ctx - 1) % page_size``, the same row for tables that agree) and
the output is returned.
"""

from __future__ import annotations

import ctypes

import torch

from ...kvcache.paged import gather_scales, slot_indices
from ..attention import NEG_INF
from . import _build
from .attn_headmajor import _ptrs, _split_scratch, check_mla, check_scales, mla_plan
from .kv_write import _pool_2d

__all__ = [
    "paged_decode_attention",
    "paged_decode_attention_plain",
    "paged_decode_attention_q",
    "paged_decode_attention_q_plain",
    "paged_decode_attention_fused",
    "paged_decode_attention_fused_plain",
    "paged_mla_decode_fused",
    "paged_mla_decode_fused_plain",
]

# the kernels' largest head dim (csrc/paged_decode.cuh DMAX)
MAX_HEAD_DIM = 256


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


def _entry(quant: bool):
    name = "paged_attention_q" if quant else "paged_attention"
    lib = _build.library(name)
    fn = lib.zt_paged_decode_attention_q if quant else lib.zt_paged_decode_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        scales = [p, p] if quant else []
        stride = [ll] if quant else []
        fn.argtypes = ([p] * 7 + scales + [p, p, i, i, i, i, ll] + stride
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
    if scales and (kp.dtype != torch.int8 or vp.dtype != torch.int8):
        raise NotImplementedError(f"{what} kernel takes int8 pools, got {kp.dtype}/{vp.dtype}")
    fp16 = _build.elem_flag(f"{what} (q{'' if scales else ' and pools'})",
                            q, *(() if scales else (kp, vp)))
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
    lib = "paged_attention_q" if scales else "paged_attention"
    splits, scratch = _split_scratch(q, B, Hkv, G, D, maxp, page_size, lib)
    out = torch.empty_like(q)
    ptrs = [out.data_ptr(), *_ptrs(scratch), q.data_ptr(), kp.data_ptr(), vp.data_ptr()]
    if scales:
        ptrs += [scales[0].data_ptr(), scales[1].data_ptr()]
    stride = [scales[0].stride(0)] if scales else []
    err = _entry(bool(scales))(
        *ptrs, page_tables.data_ptr(), context_lens.data_ptr(), B, Hkv, G, D, N, *stride,
        maxp, page_size, float(scale), int(sliding_window), splits, fp16,
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


# ---------------------------------------------------------------------------
# fused write + attend (ZT_FUSED_KV=1)
# ---------------------------------------------------------------------------

def _attend_fused(qg, k, v, k_new, v_new, context_lens, scale, sliding_window):
    """fp32 attention of qg [B, Hkv, G, Dk] over the pool tokens k [B, KV, Hkv,
    Dk], v [B, KV, Hkv, Dv] before position ctx - 1 and the new token's row
    k_new [B, Hkv, Dk], v_new [B, Hkv, Dv] (all fp32). Returns [B, Hkv, G, Dv]
    fp32; an empty context gives v_new."""
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new)[..., None] * scale
    k_pos = torch.arange(k.shape[1], device=qg.device)[None, :]
    ctx = context_lens[:, None]
    mask = k_pos < ctx - 1
    if sliding_window > 0:
        mask &= k_pos > ctx - 1 - sliding_window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    p = torch.softmax(torch.cat((scores, s_new), dim=-1), dim=-1)
    return (torch.einsum("bkgs,bskd->bkgd", p[..., :-1], v)
            + p[..., -1:] * v_new[:, :, None])


def _write_mask(slot_mapping, context_lens, n_slots):
    """Rows the fused kernels store: a slot in the pool, inside a context."""
    return (slot_mapping >= 0) & (slot_mapping < n_slots) & (context_lens >= 1)


def paged_decode_attention_fused_plain(
    q: torch.Tensor,             # [B, Hq, D]
    k_pages: torch.Tensor,       # [N, Hkv, D] or [1, N, Hkv, D]; packed: [.., N, Hkv, 2D]
    v_pages,                     # like k_pages, or None for the packed pool
    k_new: torch.Tensor,         # [B, Hkv, D] this step's rows
    v_new: torch.Tensor,         # [B, Hkv, D]
    slot_mapping: torch.Tensor,  # [B] int; < 0 => not written
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int, counting the current token
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    B, Hq, D = q.shape
    kp = _pool3(k_pages)
    Hkv = kp.shape[1]
    kn, vn = k_new.to(kp.dtype), v_new.to(kp.dtype)
    slots = slot_indices(page_tables, page_size)  # [B, KV]
    rows = kp[slots].float()
    k, v = (rows[..., :D], rows[..., D:]) if v_pages is None else (rows, _pool3(v_pages)[slots].float())
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    out = _attend_fused(qg, k, v, kn.float(), vn.float(), context_lens, scale, sliding_window)
    write = _write_mask(slot_mapping, context_lens, kp.shape[0])
    dst = slot_mapping[write].long()
    if v_pages is None:
        kp[dst] = torch.cat((kn, vn), dim=-1)[write]
    else:
        kp[dst] = kn[write]
        _pool3(v_pages)[dst] = vn[write]
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_mla_decode_fused_plain(
    q_eff: torch.Tensor,         # [B, H, k_dim]: absorbed q_latent | q_pe
    latent_pool: torch.Tensor,   # [N, X] or [1, N, X], X >= k_dim
    latent_new: torch.Tensor,    # [B, X] this step's rows
    slot_mapping: torch.Tensor,  # [B] int; < 0 => not written
    page_tables: torch.Tensor,   # [B, maxp] int; < 0 => padding
    context_lens: torch.Tensor,  # [B] int, counting the current token
    page_size: int,
    scale: float,
    v_dim: int,
) -> torch.Tensor:
    pool = _pool_2d(latent_pool)
    k_dim = q_eff.shape[-1]
    new = latent_new.to(pool.dtype)
    rows = pool[slot_indices(page_tables, page_size)].float()[:, :, None]  # [B, KV, 1, X]
    new_f = new.float()[:, None]                                          # [B, 1, X]
    out = _attend_fused(q_eff.float()[:, None], rows[..., :k_dim], rows[..., :v_dim],
                        new_f[..., :k_dim], new_f[..., :v_dim], context_lens, scale, 0)
    write = _write_mask(slot_mapping, context_lens, pool.shape[0])
    pool[slot_mapping[write].long()] = new[write]
    return out[:, 0].to(q_eff.dtype)


def _check_tables(what, B, slot_mapping, page_tables, context_lens):
    for name, t in (("slot_mapping", slot_mapping), ("page_tables", page_tables),
                    ("context_lens", context_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{what}: {name} must be int32, got {t.dtype}")
    if page_tables.dim() != 2 or page_tables.shape[0] != B or context_lens.shape != (B,) \
            or slot_mapping.shape != (B,):
        raise ValueError(f"{what}: page_tables [B, maxp], context_lens [B], slot_mapping [B]")


def _check_devices(what, tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one device")


def _entry_fused():
    fn = _build.library("paged_attention_fused").zt_paged_decode_attention_fused
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 12 + [i, i, i, i, ll, ll, i, i, ctypes.c_float, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attention_fused(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Write each slot's new K and V rows into the slot-major pools (or the
    packed pool, ``v_pages=None``) in place and return the attention output
    [B, Hq, D] over the whole context, the new token included."""
    args = (q, k_pages, v_pages, k_new, v_new, slot_mapping, page_tables, context_lens,
            page_size, scale, sliding_window)
    if q.device.type == "cpu":
        return paged_decode_attention_fused_plain(*args)
    out = _launch_fused(*args)
    paged_decode_attention_fused.launches += 1
    return out


paged_decode_attention_fused.launches = 0


def _launch_fused(q, k_pages, v_pages, k_new, v_new, slot_mapping, page_tables, context_lens,
                  page_size, scale, sliding_window) -> torch.Tensor:
    what = "paged_decode_attention_fused"
    if not q.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {q.device}")
    packed = v_pages is None
    kp = _pool3(k_pages)
    B, Hq, D = q.shape
    N, Hkv, width = kp.shape
    vp = kp if packed else _pool3(v_pages)
    if width != (2 * D if packed else D) or vp.shape != kp.shape or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k_pages.shape)}, "
                         f"v {None if packed else tuple(v_pages.shape)}")
    fp16 = _build.elem_flag(f"{what} (q and pools)", q, kp, vp)
    if D > MAX_HEAD_DIM:
        raise NotImplementedError(f"{what} kernel: head_dim {D} > {MAX_HEAD_DIM}")
    if k_new.shape != (B, Hkv, D) or v_new.shape != (B, Hkv, D):
        raise ValueError(f"{what}: rows {tuple(k_new.shape)} / {tuple(v_new.shape)}, "
                         f"want {(B, Hkv, D)}")
    # the rows in the pool's dtype, as the reference casts them before the write
    kn, vn = k_new.to(kp.dtype).contiguous(), v_new.to(kp.dtype).contiguous()
    _check_tables(what, B, slot_mapping, page_tables, context_lens)
    _check_devices(what, (q, kp, vp, kn, vn, slot_mapping, page_tables, context_lens))
    maxp = page_tables.shape[1]
    splits, scratch = _split_scratch(q, B, Hkv, Hq // Hkv, D, maxp, page_size,
                                     "paged_attention_fused")
    out = torch.empty_like(q)
    v_ptr = kp.data_ptr() + D * kp.element_size() if packed else vp.data_ptr()
    err = _entry_fused()(
        out.data_ptr(), *_ptrs(scratch), q.data_ptr(), kp.data_ptr(), v_ptr, kn.data_ptr(),
        vn.data_ptr(), slot_mapping.data_ptr(), page_tables.data_ptr(), context_lens.data_ptr(),
        B, Hkv, Hq // Hkv, D, width, N, maxp, page_size, float(scale), int(sliding_window),
        splits, fp16, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, what)
    return out


def _entry_mla_fused():
    fn = _build.library("mla_decode").zt_mla_decode_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_longlong, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_mla_decode_fused(
    q_eff: torch.Tensor,
    latent_pool: torch.Tensor,
    latent_new: torch.Tensor,
    slot_mapping: torch.Tensor,
    page_tables: torch.Tensor,
    context_lens: torch.Tensor,
    page_size: int,
    scale: float,
    v_dim: int,
) -> torch.Tensor:
    """Write each slot's new latent row into the latent pool in place and
    return the absorbed latent attention [B, H, v_dim] over the whole
    context, the new row included."""
    args = (q_eff, latent_pool, latent_new, slot_mapping, page_tables, context_lens, page_size,
            scale, v_dim)
    if q_eff.device.type == "cpu":
        return paged_mla_decode_fused_plain(*args)
    out = _launch_mla_fused(*args)
    paged_mla_decode_fused.launches += 1
    return out


paged_mla_decode_fused.launches = 0


def _launch_mla_fused(q_eff, latent_pool, latent_new, slot_mapping, page_tables, context_lens,
                      page_size, scale, v_dim) -> torch.Tensor:
    what = "paged_mla_decode_fused"
    if not q_eff.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {q_eff.device}")
    pool = _pool_2d(latent_pool)
    B, H, k_dim, N, stored, maxp, fp16 = check_mla(what, q_eff, pool, page_tables, context_lens,
                                                   v_dim)
    if latent_new.shape != (B, stored):
        raise ValueError(f"{what}: rows {tuple(latent_new.shape)}, want {(B, stored)}")
    new = latent_new.to(pool.dtype).contiguous()
    _check_tables(what, B, slot_mapping, page_tables, context_lens)
    _check_devices(what, (q_eff, pool, new, slot_mapping, page_tables, context_lens))
    splits = mla_plan(q_eff.device, B, H, maxp * page_size)
    out = torch.empty((B, H, v_dim), dtype=q_eff.dtype, device=q_eff.device)
    err = _entry_mla_fused()(
        out.data_ptr(), q_eff.data_ptr(), pool.data_ptr(), new.data_ptr(),
        slot_mapping.data_ptr(), page_tables.data_ptr(), context_lens.data_ptr(), B, H, k_dim,
        v_dim, N, stored, maxp, page_size, float(scale), splits, fp16,
        torch.cuda.current_stream(q_eff.device).cuda_stream,
    )
    _build.check(err, what)
    return out
