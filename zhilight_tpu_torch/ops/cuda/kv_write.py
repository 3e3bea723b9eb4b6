"""KV-pool row writes: into the head-major packed pool, into a 2-D pool, and
into separate slot-major K and V pools; and the attention prologues of the
three pools, which rotate q and k and write the rows in one launch.

Counterpart of ``zhilight_tpu/ops/pallas/kv_write.py`` ``write_rows_hm``
(:606). The CUDA kernel is ``csrc/kv_write.cu``; the plain PyTorch version
is :func:`write_rows_hm_plain`. :func:`write_rows_hm` takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

Semantics: ``pool[h, slot[t], :D] = k[t, h]``, ``pool[h, slot[t], D:] =
v[t, h]`` for every row with ``0 <= slot[t] < N``; rows with a negative slot
are skipped. This is the general per-row scatter of the XLA path, so chunks
may start mid-page. K and V are taken separately, which saves the
``concatenate`` of ``kvcache/paged.py:287-290``. The pool is updated in
place and returned (JAX's version returns a new pool). The kernel moves
bytes, so the int8 rows of a quantized cache (64 or 128 bytes per half) go
through it as they are; a half must be a multiple of 16 bytes.

:func:`write_rows_2d` is the counterpart of ``write_rows_2d`` (:324), the row
write of the MLA latent pool: ``pool[slot[t], :] = rows[t, :]`` for a pool
``[N, X]`` (or ``[1, N, X]``, as the cache holds it) and rows ``[T, X]``, cast
to the pool's dtype first as the reference does. Its CUDA kernel is
``csrc/kv_write_2d.cu``, its plain version :func:`write_rows_2d_plain`. The
reference's ``page_size`` argument served its page-granular TPU kernels and
is dropped, as in :func:`write_rows_hm`.

:func:`rope_write_rows_hm` is the packed pool's attention prologue, the
redesign of row 1 (``write_rows_hm``) into one launch a layer:
``q_rot = apply_rope_rot(q)`` is returned, and the pool rows become
``apply_rope_rot(k) | v``; over an int8 pool (scales given) the rows are
quantized first by :func:`quantize_rows` and their scales scattered by
:func:`scatter_scales`, a skipped row's into the spare column N. The CUDA
kernel is ``csrc/kv_write.cu`` (its rope modes; the copy mode is
:func:`write_rows_hm`), bit-equal to :func:`rope_write_rows_hm_plain`, which
is that composition of PyTorch ops. q, k and v may be strided views (of a
fused qkv projection's output): the kernel reads them through their strides.
:func:`rope_write_rows_2d` is the latent pool's prologue, the redesign of
row 7: ``q_pe`` rotated and returned, the latent row ``c_kv | rope(k_pe)``
written (``models/mla.py``'s two rotations, concatenation and
:func:`write_rows_2d` in one launch of ``csrc/kv_write_2d.cu``); its plain
version is :func:`rope_write_rows_2d_plain`. cos and sin are the fp32 ``[T,
D]`` tables of ``RopeTable.rot_values``; the kernels take bf16 or fp16 rows
(q, k, v and a model-dtype pool of one type).

:func:`write_rows_pair` writes the separate slot-major K and V pools,
``[N, Hkv, D]`` (or ``[1, N, Hkv, D]``, as the cache holds them), in one call:
``k_cache[slot[t]] = k_rows[t]`` and ``v_cache[slot[t]] = v_rows[t]`` for
``0 <= slot[t] < N``, rows cast to the pools' dtype, pools updated in place and
returned as ``(k_cache, v_cache)``. It is the counterpart of both
``paged_write_rows`` (:141) and ``write_rows_2d_pair`` (:427): the reference
has two because its TPU kernels need tile-aligned rows for the first; on the
GPU they compute one thing, the copy mode of ``csrc/kv_write_pair.cu`` (any
row width, bf16 or int8 rows), whose plain version is
:func:`write_rows_pair_plain`. ``page_size`` and ``interpret`` are dropped.
:func:`rope_write_rows_pair` is the slot-major pools' attention prologue, the
redesign of rows 11 and 12 into one launch a layer: ``q_rot =
apply_rope_rot(q)`` is returned, ``apply_rope_rot(k)`` and ``v`` go into the
K and V pools; over int8 pools (scales given) the rows are quantized by
:func:`quantize_rows` and their scales scattered by :func:`scatter_scales`, a
skipped row's into the spare column N. Its kernel is the rope modes of
``csrc/kv_write_pair.cu`` (every even head_dim up to 256; q, k and v read
through their strides), bit-equal to :func:`rope_write_rows_pair_plain`, which
is that composition of PyTorch ops.

:func:`flush_side_rows_hm` (:796) and :func:`flush_side_rows_2d` (:929) end a
decode window with side-buffered KV writes (``ZT_WINDOW_KV=1``): slot b's
first ``n_rows[b]`` window rows, which sit at positions ``entry_pos[b] ...``
and so in at most two pages (``Kw <= page_size``), go into the pool through
the page table: ``pool[:, slot(b, j)] = side[b, :, j]`` for the head-major
pool ``[Hkv, N, 2D]`` and side rows ``[B, Hkv, Kw, 2D]``, and
``pool[slot(b, j)] = side[b, j]`` for the latent pool ``[N, X]`` (or
``[1, N, X]``) and side rows ``[B, Kw, X]``. Rows past ``n_rows`` are left
alone. Both launch ``csrc/kv_flush.cu``, which computes each row's slot on
the device (no host sync); :func:`_side_page_runs` is the reference's split
of a slot's rows into its page runs, from which the plain versions and
:func:`side_slots` compute the same slots. Side rows are cast to the pool's
dtype, as the reference casts them; an int8 pool takes int8 rows only.
:func:`flush_side_layers_hm` and :func:`flush_side_layers_2d`, the redesign
of both, flush every layer of a window in one launch of the same kernel:
side rows ``[L, B, Hkv, Kw, 2D]`` (``[L, B, Kw, X]``) into L pools; over int8
pools (their K and V scale arrays given) the fp32 side rows are requantized
(:func:`quantize_rows`' rule) and their scales written at the live rows'
slots in the same launch, where the reference loops over the layers with its
requantization and scale scatter in XLA ops. Their plain versions are that
loop (:func:`flush_side_layers_hm_plain`, :func:`flush_side_layers_2d_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..rope import apply_rope_rot
from . import _build

__all__ = ["write_rows_hm", "write_rows_hm_plain", "write_rows_2d", "write_rows_2d_plain",
           "rope_write_rows_hm", "rope_write_rows_hm_plain", "rope_write_rows_2d",
           "rope_write_rows_2d_plain", "quantize_rows", "scatter_scales",
           "write_rows_pair", "write_rows_pair_plain", "rope_write_rows_pair",
           "rope_write_rows_pair_plain", "flush_side_rows_hm", "flush_side_rows_hm_plain",
           "flush_side_rows_2d", "flush_side_rows_2d_plain", "flush_side_layers_hm",
           "flush_side_layers_hm_plain", "flush_side_layers_2d", "flush_side_layers_2d_plain",
           "side_slots"]


def write_rows_hm_plain(
    pool: torch.Tensor,          # [Hkv, N, 2D]
    k: torch.Tensor,             # [T, Hkv, D]
    v: torch.Tensor,             # [T, Hkv, D]
    slot_mapping: torch.Tensor,  # [T] int; < 0 => skip
) -> torch.Tensor:
    rows = torch.cat([k, v], dim=-1).to(pool.dtype)  # [T, Hkv, 2D]
    keep = (slot_mapping >= 0) & (slot_mapping < pool.shape[1])
    pool[:, slot_mapping[keep].long()] = rows[keep].transpose(0, 1)
    return pool


def _entry():
    fn = _build.library("kv_write").zt_write_rows_hm
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def write_rows_hm(
    pool: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> torch.Tensor:
    """Write K|V rows into the head-major pool in place; returns the pool."""
    if pool.device.type == "cpu":
        return write_rows_hm_plain(pool, k, v, slot_mapping)
    if not pool.is_cuda:
        raise NotImplementedError(f"write_rows_hm: no kernel for device {pool.device}")
    H, N, X = pool.shape
    T, Hk, D = k.shape
    if v.shape != k.shape or Hk != H or 2 * D != X:
        raise ValueError(f"write_rows_hm: pool {tuple(pool.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != pool.dtype or v.dtype != pool.dtype:
        raise ValueError(f"write_rows_hm: rows {k.dtype}/{v.dtype} vs pool {pool.dtype}")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("write_rows_hm: slot_mapping must be int32 [T]")
    row_bytes = D * pool.element_size()
    if row_bytes % 16:
        raise NotImplementedError(f"write_rows_hm: row of {row_bytes} bytes is not 16-byte aligned")
    for t in (pool, k, v, slot_mapping):
        if t.device != pool.device or not t.is_contiguous():
            raise ValueError("write_rows_hm: tensors must be contiguous and on one device")
    err = _entry()(
        pool.data_ptr(), k.data_ptr(), v.data_ptr(), slot_mapping.data_ptr(),
        T, H, N, row_bytes, torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(err, "write_rows_hm")
    write_rows_hm.launches += 1
    return pool


write_rows_hm.launches = 0


# ---------------------------------------------------------------------------
# 2-D pool (MLA latents)
# ---------------------------------------------------------------------------

def _pool_2d(pool: torch.Tensor) -> torch.Tensor:
    """The pool as [N, X]: a leading unit dimension is dropped (a view)."""
    if pool.dim() == 3 and pool.shape[0] == 1:
        return pool[0]
    if pool.dim() != 2:
        raise ValueError(f"2-D pool: must be [N, X] or [1, N, X], got {tuple(pool.shape)}")
    return pool


def write_rows_2d_plain(
    pool: torch.Tensor,          # [N, X] or [1, N, X]
    rows: torch.Tensor,          # [T, X]
    slot_mapping: torch.Tensor,  # [T] int; < 0 => skip
) -> torch.Tensor:
    p2 = _pool_2d(pool)
    keep = (slot_mapping >= 0) & (slot_mapping < p2.shape[0])
    p2[slot_mapping[keep].long()] = rows.to(pool.dtype)[keep]
    return pool


def _entry_2d():
    fn = _build.library("kv_write_2d").zt_write_rows_2d
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def write_rows_2d(
    pool: torch.Tensor,
    rows: torch.Tensor,
    slot_mapping: torch.Tensor,
) -> torch.Tensor:
    """Write rows into the 2-D pool in place; returns the pool."""
    if pool.device.type == "cpu":
        return write_rows_2d_plain(pool, rows, slot_mapping)
    if not pool.is_cuda:
        raise NotImplementedError(f"write_rows_2d: no kernel for device {pool.device}")
    p2 = _pool_2d(pool)
    N, X = p2.shape
    T = rows.shape[0]
    if rows.shape != (T, X):
        raise ValueError(f"write_rows_2d: pool {tuple(pool.shape)}, rows {tuple(rows.shape)}")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("write_rows_2d: slot_mapping must be int32 [T]")
    rows = rows.to(pool.dtype).contiguous()
    for t in (p2, rows, slot_mapping):
        if t.device != pool.device or not t.is_contiguous():
            raise ValueError("write_rows_2d: tensors must be contiguous and on one device")
    err = _entry_2d()(
        p2.data_ptr(), rows.data_ptr(), slot_mapping.data_ptr(), T, N,
        X * pool.element_size(), torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(err, "write_rows_2d")
    write_rows_2d.launches += 1
    return pool


write_rows_2d.launches = 0


# ---------------------------------------------------------------------------
# attention prologues: rope, int8 quantization and the row write
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization of K or V rows [..., D]:
    int8 rows and their fp32 scales [...] (an all-zero row gets the 1e-8
    floor; ties round half to even, as the reference's ``jnp.round``)."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def scatter_scales(k_scale: torch.Tensor, v_scale: torch.Tensor, scales: torch.Tensor,
                   slot_mapping: torch.Tensor) -> None:
    """Scales [2, T, Hkv] of K and V rows into the head-major ``[Hkv, N + 1]``
    arrays at their slots, in place; a skipped row (slot < 0, or past the
    pool) lands in the spare last column."""
    N = k_scale.shape[1] - 1
    idx = slot_mapping.long()
    idx = torch.where((idx < 0) | (idx >= N), N, idx)
    k_scale[:, idx] = scales[0].t()
    v_scale[:, idx] = scales[1].t()


def rope_write_rows_hm_plain(
    pool: torch.Tensor,                      # [Hkv, N, 2D]
    q: torch.Tensor,                         # [T, Hq, D]
    k: torch.Tensor,                         # [T, Hkv, D]
    v: torch.Tensor,                         # [T, Hkv, D]
    cos_f: torch.Tensor,                     # [T, D] fp32
    sin_f: torch.Tensor,
    neox: bool,
    slot_mapping: torch.Tensor,              # [T] int; < 0 => skip
    k_scale: Optional[torch.Tensor] = None,  # int8 pool: [Hkv, N + 1] fp32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    q_rot = apply_rope_rot(q, cos_f, sin_f, neox)
    k_rot = apply_rope_rot(k, cos_f, sin_f, neox)
    if k_scale is None:
        write_rows_hm_plain(pool, k_rot.to(pool.dtype), v.to(pool.dtype), slot_mapping)
        return q_rot
    rows, scales = quantize_rows(torch.stack((k_rot, v)))  # [2, T, Hkv, D], [2, T, Hkv]
    write_rows_hm_plain(pool, rows[0], rows[1], slot_mapping)
    scatter_scales(k_scale, v_scale, scales, slot_mapping)
    return q_rot


def _entry_rope_hm():
    fn = _build.library("kv_write").zt_rope_write_rows_hm
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 7 + [i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _rows_ok(x: torch.Tensor) -> bool:
    """Rows the prologue kernels read through their strides: unit last
    stride, every row on a 16-byte boundary."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s * x.element_size() % 16 == 0 for s in x.stride()[:-1]))


def _tables_ok(cos_f: torch.Tensor, sin_f: torch.Tensor, T: int, D: int) -> bool:
    return all(c.dtype == torch.float32 and c.shape == (T, D) and c.is_contiguous()
               and c.data_ptr() % 16 == 0 for c in (cos_f, sin_f))


def rope_write_rows_hm(pool, q, k, v, cos_f, sin_f, neox: bool, slot_mapping,
                       k_scale=None, v_scale=None) -> torch.Tensor:
    """Rotate q and k, write the K|V rows (quantized over an int8 pool, whose
    scales are given) into the head-major pool in place; returns q rotated,
    ``[T, Hq, D]``."""
    if pool.device.type == "cpu":
        return rope_write_rows_hm_plain(pool, q, k, v, cos_f, sin_f, neox, slot_mapping,
                                        k_scale, v_scale)
    if not pool.is_cuda:
        raise NotImplementedError(f"rope_write_rows_hm: no kernel for device {pool.device}")
    Hkv, N, X = pool.shape
    T, Hq, D = q.shape
    if k.shape != (T, Hkv, D) or v.shape != k.shape or X != 2 * D:
        raise ValueError(f"rope_write_rows_hm: pool {tuple(pool.shape)}, q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    int8 = k_scale is not None
    fp16 = _build.elem_flag("rope_write_rows_hm (rows and a model-dtype pool)",
                            q, k, v, *(() if int8 else (pool,)))
    if int8 and pool.dtype != torch.int8:
        raise NotImplementedError(f"rope_write_rows_hm: scales need an int8 pool, got {pool.dtype}")
    if D % 16 or D > 256:
        raise NotImplementedError(f"rope_write_rows_hm: head_dim {D} (the kernel takes "
                                  f"multiples of 16 up to 256)")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("rope_write_rows_hm: slot_mapping must be int32 [T]")
    scales = (k_scale, v_scale) if int8 else ()
    if any(s.dtype != torch.float32 or s.shape != (Hkv, N + 1) or not s.is_contiguous()
           for s in scales):
        raise ValueError(f"rope_write_rows_hm: scales must be fp32 [Hkv, N + 1] = "
                         f"[{Hkv}, {N + 1}] and contiguous")
    if not (all(_rows_ok(x) for x in (q, k, v)) and _tables_ok(cos_f, sin_f, T, D)
            and pool.is_contiguous()):
        raise ValueError("rope_write_rows_hm: rows must have unit last stride and 16-byte "
                         "aligned rows, cos/sin fp32 [T, D] contiguous, the pool contiguous")
    if any(x.device != pool.device for x in (q, k, v, cos_f, sin_f, slot_mapping, *scales)):
        raise ValueError("rope_write_rows_hm: tensors must be on one device")
    q_out = torch.empty((T, Hq, D), dtype=q.dtype, device=q.device)
    err = _entry_rope_hm()(
        pool.data_ptr(), k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_out.data_ptr(), cos_f.data_ptr(), sin_f.data_ptr(), slot_mapping.data_ptr(),
        T, Hq, Hkv, D, N, *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], int(neox), int(int8),
        fp16, torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(err, "rope_write_rows_hm")
    rope_write_rows_hm.launches += 1
    return q_out


rope_write_rows_hm.launches = 0


def rope_write_rows_2d_plain(
    pool: torch.Tensor,          # [N, L + R] or [1, N, L + R]
    q_pe: torch.Tensor,          # [T, H, R]
    c_kv: torch.Tensor,          # [T, L]
    k_pe: torch.Tensor,          # [T, R]
    cos_f: torch.Tensor,         # [T, R] fp32
    sin_f: torch.Tensor,
    neox: bool,
    slot_mapping: torch.Tensor,  # [T] int; < 0 => skip
) -> torch.Tensor:
    q_rot = apply_rope_rot(q_pe, cos_f, sin_f, neox)
    k_rot = apply_rope_rot(k_pe[:, None, :], cos_f, sin_f, neox)[:, 0]
    write_rows_2d_plain(pool, torch.cat([c_kv, k_rot], dim=-1), slot_mapping)
    return q_rot


def _entry_rope_2d():
    fn = _build.library("kv_write_2d").zt_rope_write_rows_2d
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 8 + [i] * 4 + [ll] * 5 + [i, i, p]
        fn.restype = ctypes.c_int
    return fn


def rope_write_rows_2d(pool, q_pe, c_kv, k_pe, cos_f, sin_f, neox: bool,
                       slot_mapping) -> torch.Tensor:
    """Rotate q_pe and k_pe and write the latent rows ``c_kv | rope(k_pe)``
    into the 2-D pool in place; returns q_pe rotated, ``[T, H, R]``."""
    if pool.device.type == "cpu":
        return rope_write_rows_2d_plain(pool, q_pe, c_kv, k_pe, cos_f, sin_f, neox, slot_mapping)
    if not pool.is_cuda:
        raise NotImplementedError(f"rope_write_rows_2d: no kernel for device {pool.device}")
    p2 = _pool_2d(pool)
    N, X = p2.shape
    T, H, R = q_pe.shape
    L = c_kv.shape[-1]
    if c_kv.shape != (T, L) or k_pe.shape != (T, R) or X != L + R:
        raise ValueError(f"rope_write_rows_2d: pool {tuple(pool.shape)}, q_pe "
                         f"{tuple(q_pe.shape)}, c_kv {tuple(c_kv.shape)}, k_pe {tuple(k_pe.shape)}")
    fp16 = _build.elem_flag("rope_write_rows_2d (rows and pool)", pool, q_pe, c_kv, k_pe)
    if R % 16 or R > 256 or L % 8:
        raise NotImplementedError(f"rope_write_rows_2d: rope width {R}, latent width {L} (the "
                                  f"kernel takes R a multiple of 16 up to 256, L of 8)")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("rope_write_rows_2d: slot_mapping must be int32 [T]")
    if not (all(_rows_ok(x) for x in (q_pe, c_kv, k_pe)) and _tables_ok(cos_f, sin_f, T, R)
            and p2.is_contiguous() and p2.data_ptr() % 16 == 0):
        raise ValueError("rope_write_rows_2d: rows must have unit last stride and 16-byte "
                         "aligned rows, cos/sin fp32 [T, R] contiguous, the pool contiguous")
    if any(x.device != pool.device for x in (q_pe, c_kv, k_pe, cos_f, sin_f, slot_mapping)):
        raise ValueError("rope_write_rows_2d: tensors must be on one device")
    q_out = torch.empty((T, H, R), dtype=q_pe.dtype, device=q_pe.device)
    err = _entry_rope_2d()(
        p2.data_ptr(), q_out.data_ptr(), q_pe.data_ptr(), c_kv.data_ptr(), k_pe.data_ptr(),
        cos_f.data_ptr(), sin_f.data_ptr(), slot_mapping.data_ptr(), T, H, L, R, N,
        *q_pe.stride()[:2], c_kv.stride(0), k_pe.stride(0), int(neox), fp16,
        torch.cuda.current_stream(pool.device).cuda_stream,
    )
    _build.check(err, "rope_write_rows_2d")
    rope_write_rows_2d.launches += 1
    return q_out


rope_write_rows_2d.launches = 0


# ---------------------------------------------------------------------------
# separate slot-major K and V pools
# ---------------------------------------------------------------------------

def _pool_3d(pool: torch.Tensor) -> torch.Tensor:
    """A slot-major pool [N, Hkv, D] (or [1, N, Hkv, D]) as [N, Hkv, D]."""
    if pool.dim() == 4 and pool.shape[0] == 1:
        pool = pool[0]
    if pool.dim() != 3:
        raise ValueError(f"pair write: pool must be [N, Hkv, D] or [1, N, Hkv, D], "
                         f"got {tuple(pool.shape)}")
    return pool


def _rows_view(pool: torch.Tensor) -> torch.Tensor:
    """A slot-major pool as its 2-D view [N, Hkv * D]: one token's row of
    every head."""
    pool = _pool_3d(pool)
    return pool.view(pool.shape[0], -1)


def write_rows_pair_plain(
    k_cache: torch.Tensor,       # [N, Hkv, D] or [1, N, Hkv, D]
    v_cache: torch.Tensor,
    k_rows: torch.Tensor,        # [T, Hkv, D]
    v_rows: torch.Tensor,
    slot_mapping: torch.Tensor,  # [T] int; < 0 => skip
):
    for pool, rows in ((k_cache, k_rows), (v_cache, v_rows)):
        write_rows_2d_plain(_rows_view(pool), rows.reshape(rows.shape[0], -1), slot_mapping)
    return k_cache, v_cache


def _entry_pair():
    fn = _build.library("kv_write_pair").zt_write_rows_pair
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def write_rows_pair(k_cache, v_cache, k_rows, v_rows, slot_mapping):
    """Write K and V rows into the slot-major pools in place; returns
    ``(k_cache, v_cache)``. The counterpart of both ``paged_write_rows``
    (:141) and ``write_rows_2d_pair`` (:427)."""
    if k_cache.device.type == "cpu":
        return write_rows_pair_plain(k_cache, v_cache, k_rows, v_rows, slot_mapping)
    if not k_cache.is_cuda:
        raise NotImplementedError(f"write_rows_pair: no kernel for device {k_cache.device}")
    k2, v2 = _rows_view(k_cache), _rows_view(v_cache)
    N, X = k2.shape
    T = k_rows.shape[0]
    if v2.shape != (N, X) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"write_rows_pair: k {tuple(k_cache.shape)} {k_cache.dtype}, "
                         f"v {tuple(v_cache.shape)} {v_cache.dtype}")
    rk = k_rows.to(k_cache.dtype).reshape(T, -1).contiguous()
    rv = v_rows.to(k_cache.dtype).reshape(T, -1).contiguous()
    if rk.shape != (T, X) or rv.shape != (T, X):
        raise ValueError(f"write_rows_pair: pools {tuple(k_cache.shape)}, rows "
                         f"{tuple(k_rows.shape)} / {tuple(v_rows.shape)}")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("write_rows_pair: slot_mapping must be int32 [T]")
    for t in (k2, v2, rk, rv, slot_mapping):
        if t.device != k_cache.device or not t.is_contiguous():
            raise ValueError("write_rows_pair: tensors must be contiguous and on one device")
    err = _entry_pair()(
        k2.data_ptr(), v2.data_ptr(), rk.data_ptr(), rv.data_ptr(), slot_mapping.data_ptr(),
        T, N, X * k_cache.element_size(), torch.cuda.current_stream(k_cache.device).cuda_stream,
    )
    _build.check(err, "write_rows_pair")
    write_rows_pair.launches += 1
    return k_cache, v_cache


write_rows_pair.launches = 0


def rope_write_rows_pair_plain(
    k_cache: torch.Tensor,                   # [N, Hkv, D] or [1, N, Hkv, D]
    v_cache: torch.Tensor,
    q: torch.Tensor,                         # [T, Hq, D]
    k: torch.Tensor,                         # [T, Hkv, D]
    v: torch.Tensor,                         # [T, Hkv, D]
    cos_f: torch.Tensor,                     # [T, D] fp32
    sin_f: torch.Tensor,
    neox: bool,
    slot_mapping: torch.Tensor,              # [T] int; < 0 => skip
    k_scale: Optional[torch.Tensor] = None,  # int8 pools: [Hkv, N + 1] fp32
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    q_rot = apply_rope_rot(q, cos_f, sin_f, neox)
    k_rot = apply_rope_rot(k, cos_f, sin_f, neox)
    if k_scale is None:
        write_rows_pair_plain(k_cache, v_cache, k_rot, v, slot_mapping)
        return q_rot
    rows, scales = quantize_rows(torch.stack((k_rot, v)))  # [2, T, Hkv, D], [2, T, Hkv]
    write_rows_pair_plain(k_cache, v_cache, rows[0], rows[1], slot_mapping)
    scatter_scales(k_scale, v_scale, scales, slot_mapping)
    return q_rot


def _entry_rope_pair():
    fn = _build.library("kv_write_pair").zt_rope_write_rows_pair
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 11 + [i] * 4 + [ll] * 7 + [i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def rope_write_rows_pair(k_cache, v_cache, q, k, v, cos_f, sin_f, neox: bool, slot_mapping,
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """Rotate q and k, write the K and V rows (quantized over int8 pools,
    whose scales are given) into the slot-major pools in place; returns q
    rotated, ``[T, Hq, D]``."""
    if k_cache.device.type == "cpu":
        return rope_write_rows_pair_plain(k_cache, v_cache, q, k, v, cos_f, sin_f, neox,
                                          slot_mapping, k_scale, v_scale)
    if not k_cache.is_cuda:
        raise NotImplementedError(f"rope_write_rows_pair: no kernel for device {k_cache.device}")
    k3, v3 = _pool_3d(k_cache), _pool_3d(v_cache)
    N, Hkv, D = k3.shape
    T, Hq = q.shape[:2]
    if (q.shape != (T, Hq, D) or k.shape != (T, Hkv, D) or v.shape != k.shape
            or v3.shape != k3.shape):
        raise ValueError(f"rope_write_rows_pair: pools {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)}, q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    int8 = k_scale is not None
    fp16 = _build.elem_flag("rope_write_rows_pair (rows and model-dtype pools)",
                            q, k, v, *(() if int8 else (k3, v3)))
    if int8 and (k3.dtype != torch.int8 or v3.dtype != torch.int8):
        raise NotImplementedError(f"rope_write_rows_pair: scales need int8 pools, got "
                                  f"{k3.dtype}/{v3.dtype}")
    if D % 2 or D > 256:
        raise NotImplementedError(f"rope_write_rows_pair: head_dim {D} (the kernel takes even "
                                  f"head dims up to 256)")
    if slot_mapping.dtype != torch.int32 or slot_mapping.shape != (T,):
        raise ValueError("rope_write_rows_pair: slot_mapping must be int32 [T]")
    scales = (k_scale, v_scale) if int8 else ()
    if any(s is None or s.dtype != torch.float32 or s.shape != (Hkv, N + 1)
           or not s.is_contiguous() for s in scales):
        raise ValueError(f"rope_write_rows_pair: scales must be fp32 [Hkv, N + 1] = "
                         f"[{Hkv}, {N + 1}] and contiguous")
    if not (all(x.stride(-1) == 1 for x in (q, k, v))
            and all(c.dtype == torch.float32 and c.shape == (T, D) and c.is_contiguous()
                    for c in (cos_f, sin_f))
            and k3.is_contiguous() and v3.is_contiguous()):
        raise ValueError("rope_write_rows_pair: rows must have unit last stride, cos/sin fp32 "
                         "[T, D] contiguous, the pools contiguous")
    if any(x.device != k_cache.device
           for x in (v_cache, q, k, v, cos_f, sin_f, slot_mapping, *scales)):
        raise ValueError("rope_write_rows_pair: tensors must be on one device")
    q_out = torch.empty((T, Hq, D), dtype=q.dtype, device=q.device)
    err = _entry_rope_pair()(
        k3.data_ptr(), v3.data_ptr(), k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q_out.data_ptr(), cos_f.data_ptr(), sin_f.data_ptr(), slot_mapping.data_ptr(),
        T, Hq, Hkv, D, N, *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], int(neox), int(int8),
        fp16, torch.cuda.current_stream(k_cache.device).cuda_stream,
    )
    _build.check(err, "rope_write_rows_pair")
    rope_write_rows_pair.launches += 1
    return q_out


rope_write_rows_pair.launches = 0


# ---------------------------------------------------------------------------
# end-of-window flush of the decode side buffer
# ---------------------------------------------------------------------------

def _side_page_runs(entry_pos, n_rows, page_tables, page_size):
    """Split each slot's contiguous window rows into its <= 2 page runs:
    (starts1, lens1, starts2, lens2), pool rows and row counts [B]. Padding
    pages (< 0) read page 0 and page-table indices clip to the last column,
    as the reference's do."""
    S, maxp = page_size, page_tables.shape[1]
    safe = page_tables.clamp_min(0)
    page1 = safe.gather(1, (entry_pos // S).clamp(0, maxp - 1).long()[:, None])[:, 0]
    off1 = entry_pos % S
    lens1 = torch.minimum(n_rows, S - off1)
    page2 = safe.gather(1, ((entry_pos + lens1) // S).clamp(0, maxp - 1).long()[:, None])[:, 0]
    return page1 * S + off1, lens1, page2 * S, (n_rows - lens1).clamp_min(0)


def side_slots(entry_pos, n_rows, page_tables, page_size: int, window: int) -> torch.Tensor:
    """Pool slot of each window row, [B, window] int64; -1 past ``n_rows``."""
    starts1, lens1, starts2, _ = _side_page_runs(entry_pos, n_rows, page_tables, page_size)
    j = torch.arange(window, device=entry_pos.device)[None, :]
    slots = torch.where(j < lens1[:, None], starts1[:, None] + j, starts2[:, None] + j - lens1[:, None])
    return torch.where(j < n_rows[:, None], slots.long(), -1)


def _side_rows(what: str, side: torch.Tensor, pool: torch.Tensor) -> torch.Tensor:
    if pool.dtype == torch.int8 and side.dtype != torch.int8:
        raise ValueError(f"{what}: an int8 pool takes requantized int8 rows, got {side.dtype}")
    return side.to(pool.dtype)


def flush_side_rows_hm_plain(
    pool: torch.Tensor,         # [Hkv, N, X]
    side: torch.Tensor,         # [B, Hkv, Kw, X]
    entry_pos: torch.Tensor,    # [B] int: position of each slot's first window row
    n_rows: torch.Tensor,       # [B] int: live window rows (0 => untouched slot)
    page_tables: torch.Tensor,  # [B, maxp] int
    page_size: int,
) -> torch.Tensor:
    slots = side_slots(entry_pos, n_rows, page_tables, page_size, side.shape[2])
    live = (slots >= 0) & (slots < pool.shape[1])
    rows = _side_rows("flush_side_rows_hm", side, pool).transpose(1, 2)[live]  # [n, Hkv, X]
    pool[:, slots[live]] = rows.transpose(0, 1)
    return pool


def flush_side_rows_2d_plain(
    pool: torch.Tensor,         # [N, X] or [1, N, X]
    side: torch.Tensor,         # [B, Kw, X]
    entry_pos: torch.Tensor,
    n_rows: torch.Tensor,
    page_tables: torch.Tensor,
    page_size: int,
) -> torch.Tensor:
    p2 = _pool_2d(pool)
    slots = side_slots(entry_pos, n_rows, page_tables, page_size, side.shape[1])
    live = (slots >= 0) & (slots < p2.shape[0])
    p2[slots[live]] = _side_rows("flush_side_rows_2d", side, pool)[live]
    return pool


def _live_slots(side_slots_: torch.Tensor, N: int) -> torch.Tensor:
    """The live window rows of :func:`side_slots`' result: slots in [0, N)."""
    return (side_slots_ >= 0) & (side_slots_ < N)


def flush_side_layers_hm_plain(
    pools,                      # L pools [Hkv, N, 2D]
    side: torch.Tensor,         # [L, B, Hkv, Kw, 2D]: the pools' dtype, or fp32 over int8 pools
    entry_pos: torch.Tensor,
    n_rows: torch.Tensor,
    page_tables: torch.Tensor,
    page_size: int,
    k_scales=None,              # int8 pools: L arrays [Hkv, N + 1] fp32
    v_scales=None,
):
    """Every layer's window rows into its head-major pool, in place: the
    per-layer plain flush, after (over int8 pools) :func:`quantize_rows` of
    each row's K and V halves and the scatter of their scales at the live
    rows' slots (the dead and skipped rows' are dropped, as the reference
    drops them). Returns the pools."""
    if k_scales is None:
        for pool, rows in zip(pools, side):
            flush_side_rows_hm_plain(pool, rows, entry_pos, n_rows, page_tables, page_size)
        return pools
    D = side.shape[-1] // 2
    slots = side_slots(entry_pos, n_rows, page_tables, page_size, side.shape[3])  # [B, Kw]
    live = _live_slots(slots, pools[0].shape[1])
    for pool, rows, ks, vs in zip(pools, side, k_scales, v_scales):
        codes, scales = quantize_rows(torch.stack((rows[..., :D], rows[..., D:])))
        flush_side_rows_hm_plain(pool, torch.cat((codes[0], codes[1]), dim=-1), entry_pos,
                                 n_rows, page_tables, page_size)
        # scales [2, B, Hkv, Kw] -> the live rows' columns of [Hkv, N + 1]
        per_row = scales.permute(0, 1, 3, 2)[:, live]  # [2, n, Hkv]
        ks[:, slots[live]] = per_row[0].t()
        vs[:, slots[live]] = per_row[1].t()
    return pools


def flush_side_layers_2d_plain(pools, side, entry_pos, n_rows, page_tables, page_size: int):
    """Every layer's window latent rows ``side`` [L, B, Kw, X] into its pool
    ([N, X] or [1, N, X]), in place: the per-layer plain flush. Returns the
    pools."""
    for pool, rows in zip(pools, side):
        flush_side_rows_2d_plain(pool, rows, entry_pos, n_rows, page_tables, page_size)
    return pools


def _entry_flush():
    fn = _build.library("kv_flush").zt_flush_side_rows
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 7 + [ll] + [p] * 3 + [i] * 4 + [ll, i, i, i, ll, i, p]
        fn.restype = ctypes.c_int
    return fn


# per device: the int64 tables of pool (and scale array) addresses handed to
# the layered flush, keyed on the addresses themselves
_TABLES: dict = {}


def _address_table(tensors) -> Optional[torch.Tensor]:
    """A device int64 table of the tensors' addresses, or None for one tensor
    (the kernel then takes its address directly). A table is cached under the
    addresses it holds, so it is right whatever tensors the caller passes
    (the engine's pools never change, a scratch cache's are new) and costs one
    small host-to-device copy per new set of addresses, none per window."""
    if len(tensors) == 1:
        return None
    device = tensors[0].device
    key = (device, tuple(t.data_ptr() for t in tensors))
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= 64:
            _TABLES.clear()
        table = _TABLES[key] = torch.tensor(key[1], dtype=torch.int64, device=device)
    return table


def _flush(what: str, pools3, side5, entry_pos, n_rows, page_tables, page_size: int,
           k_scales=None, v_scales=None) -> None:
    """Launch csrc/kv_flush.cu once for L pools [H, N, X] and side rows
    [L, B, H, Kw, X] on the GPU (fp32 rows and the scale arrays over int8
    pools: the kernel quantizes), or raise."""
    pool3 = pools3[0]
    if not pool3.is_cuda:
        raise NotImplementedError(f"{what}: no kernel for device {pool3.device}")
    H, N, X = pool3.shape
    L, B, Hs, Kw, Xs = side5.shape
    if (Hs, Xs) != (H, X) or len(pools3) != L or any(
            p.shape != pool3.shape or p.dtype != pool3.dtype for p in pools3):
        raise ValueError(f"{what}: {len(pools3)} pools {tuple(pool3.shape)}, side rows "
                         f"{tuple(side5.shape)}")
    if Kw > page_size:
        raise ValueError(f"{what}: {Kw} window rows do not fit a page of {page_size}")
    int8 = k_scales is not None
    if int8:
        if pool3.dtype != torch.int8 or side5.dtype != torch.float32 or X % 8 or X > 512:
            raise NotImplementedError(f"{what}: requantizing flushes take fp32 rows into int8 "
                                      f"pools, 2D a multiple of 8 up to 512; got "
                                      f"{side5.dtype} rows of {X} into {pool3.dtype}")
        scales = list(k_scales) + list(v_scales)
        if len(scales) != 2 * L or any(
                s.dtype != torch.float32 or s.shape != (H, N + 1) or not s.is_contiguous()
                or s.device != pool3.device for s in scales):
            raise ValueError(f"{what}: {L} K and V scale arrays fp32 [H, N + 1] = "
                             f"[{H}, {N + 1}], contiguous, on the pools' device")
    else:
        side5 = _side_rows(what, side5, pool3)
    side5 = side5.contiguous()
    maxp = page_tables.shape[1]
    for t, shape in ((entry_pos, (B,)), (n_rows, (B,)), (page_tables, (B, maxp))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{what}: entry_pos, n_rows int32 [B], page_tables int32 [B, maxp]")
    for t in (*pools3, side5, entry_pos, n_rows, page_tables):
        if t.device != pool3.device or not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous and on one device")
    pools_t = _address_table(pools3)
    ks_t = _address_table(list(k_scales)) if int8 else None
    vs_t = _address_table(list(v_scales)) if int8 else None
    bits = 0
    for p in pools3:
        bits |= p.data_ptr()
    err = _entry_flush()(
        pool3.data_ptr(), None if pools_t is None else pools_t.data_ptr(),
        k_scales[0].data_ptr() if int8 else None, v_scales[0].data_ptr() if int8 else None,
        None if ks_t is None else ks_t.data_ptr(), None if vs_t is None else vs_t.data_ptr(),
        side5.data_ptr(), side5.stride(0) * side5.element_size(), entry_pos.data_ptr(),
        n_rows.data_ptr(), page_tables.data_ptr(), L, B, H, Kw, N, maxp, page_size,
        X * pool3.element_size(), bits, int(int8),
        torch.cuda.current_stream(pool3.device).cuda_stream,
    )
    _build.check(err, what)


def flush_side_rows_hm(pool, side, entry_pos, n_rows, page_tables, page_size: int):
    """Write each slot's live window rows into the head-major pool in place;
    returns the pool."""
    if pool.device.type == "cpu":
        return flush_side_rows_hm_plain(pool, side, entry_pos, n_rows, page_tables, page_size)
    _flush("flush_side_rows_hm", [pool], side[None], entry_pos, n_rows, page_tables, page_size)
    flush_side_rows_hm.launches += 1
    return pool


flush_side_rows_hm.launches = 0


def flush_side_rows_2d(pool, side, entry_pos, n_rows, page_tables, page_size: int):
    """Write each slot's live window rows into the 2-D (latent) pool in place;
    returns the pool."""
    if pool.device.type == "cpu":
        return flush_side_rows_2d_plain(pool, side, entry_pos, n_rows, page_tables, page_size)
    _flush("flush_side_rows_2d", [_pool_2d(pool)[None]], side[None, :, None], entry_pos, n_rows,
           page_tables, page_size)
    flush_side_rows_2d.launches += 1
    return pool


flush_side_rows_2d.launches = 0


def flush_side_layers_hm(pools, side, entry_pos, n_rows, page_tables, page_size: int,
                         k_scales=None, v_scales=None):
    """Every layer's live window rows ``side`` [L, B, Hkv, Kw, 2D] into its
    head-major pool (``pools``, L of them) in place, in one launch; over int8
    pools (their K and V scale arrays given) the fp32 side rows are
    requantized and their scales written in the same launch. Returns the
    pools."""
    if pools[0].device.type == "cpu":
        return flush_side_layers_hm_plain(pools, side, entry_pos, n_rows, page_tables, page_size,
                                          k_scales, v_scales)
    _flush("flush_side_layers_hm", list(pools), side, entry_pos, n_rows, page_tables, page_size,
           k_scales, v_scales)
    flush_side_layers_hm.launches += 1
    return pools


flush_side_layers_hm.launches = 0


def flush_side_layers_2d(pools, side, entry_pos, n_rows, page_tables, page_size: int):
    """Every layer's live window latent rows ``side`` [L, B, Kw, X] into its
    pool ([N, X] or [1, N, X], L of them) in place, in one launch. Returns the
    pools."""
    if pools[0].device.type == "cpu":
        return flush_side_layers_2d_plain(pools, side, entry_pos, n_rows, page_tables, page_size)
    _flush("flush_side_layers_2d", [_pool_2d(p)[None] for p in pools], side[:, :, None],
           entry_pos, n_rows, page_tables, page_size)
    flush_side_layers_2d.launches += 1
    return pools


flush_side_layers_2d.launches = 0
