"""KV-pool row writes into the head-major packed pool.

Counterpart of ``zhilight_tpu/ops/pallas/kv_write.py`` ``write_rows_hm``
(:606). The CUDA kernel is ``csrc/kv_write.cu``; the plain PyTorch version
is :func:`write_rows_hm_plain`. :func:`write_rows_hm` takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.

Semantics: ``pool[h, slot[t], :D] = k[t, h]``, ``pool[h, slot[t], D:] =
v[t, h]`` for every row with ``0 <= slot[t] < N``; rows with a negative slot
are skipped. This is the general per-row scatter of the XLA path, so chunks
may start mid-page. K and V are taken separately, which saves the
``concatenate`` of ``kvcache/paged.py:287-290``. The pool is updated in
place and returned (JAX's version returns a new pool).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["write_rows_hm", "write_rows_hm_plain"]


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
