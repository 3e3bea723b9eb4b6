"""Device-side paged KV cache.

Counterpart of ``zhilight_tpu/kvcache/paged.py``: one statically shaped
paged pool per layer, addressed by page tables, in one of the reference's two
layouts, chosen as the reference chooses (:func:`_use_packed`):

* packed head-major, whenever ``2*head_dim % 128 == 0``: each layer's pool is
  ``[Hkv, num_pages * page_size, 2*head_dim]``, K in lanes ``[:D]`` and V in
  lanes ``[D:]``;
* slot-major otherwise (head_dim 16, 80, 96, 100 ...), or for any head_dim
  under ``ZT_NO_PACKED_KV=1``: separate K and V pools per layer, each the
  reference's ``[N_slots, Hkv, D]`` stored with a leading unit dimension,
  ``[1, N_slots, Hkv, D]``. ``pool[0]`` is the reference's array, so one
  token's row of ``Hkv*D`` elements is contiguous.

An int8 cache (``quantized=True``) stores int8 elements in the same pool
geometry plus one fp32 absmax scale per (token, KV head) for K and for V. The
scales are head-major ``[Hkv, N_slots + 1]`` in both layouts (the reference
keeps them slot-major ``[N_slots, Hkv]``): an attention block that owns one KV
head reads its tokens' scales from neighbouring addresses. The last column is
a spare that absorbs the scales of skipped rows.

An MLA model keeps one latent row per token instead (:func:`new_latent_cache`):
each layer's pool is ``[1, num_pages * page_size, latent_dim]``, the
compressed KV (``kv_lora_rank``) followed by the rope key. The reference pads
the row to a multiple of 128 lanes for its TPU kernels; the port stores
``latent_dim`` elements (576 for DeepSeek-V2: 1152 bytes, a multiple of 16).

Every array of a cache has its slot dimension at dim 1 (hence the leading unit
dimensions), so the engine's pool-row operations serve every layout.

Writes update the pool in place (PyTorch has no buffer donation to emulate):
:func:`write_kv` returns the same cache object it was given; it copies rows
through ``write_rows_hm`` (packed pool) or ``write_rows_pair`` (slot-major
pools; the counterpart of both of the reference's slot-major writes). A
model's per-step writes go through the attention prologues instead:
:func:`rope_write_kv` (``rope_write_rows_hm`` over a packed pool,
``rope_write_rows_pair`` over slot-major pools) and :func:`rope_write_latent`
(latent pool) rotate q and k and write the rows, quantized over an int8 pool,
in one kernel launch, bit-equal to :func:`apply_rope_rot` followed by
:func:`write_kv` / :func:`write_latent`.

A decode window with side-buffered KV writes (``ZT_WINDOW_KV=1``) writes no
row while it runs and flushes every layer's window rows at its end in one
kernel launch, :func:`flush_side_layers` (an int8 pool requantizes the fp32
side rows and scatters their scales in the same launch; dead rows' are
dropped, as the reference drops them); :func:`flush_side_kv` (packed pool)
and :func:`flush_side_latent` (latent pool) flush one layer.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.cuda import kv_write

__all__ = ["KVCache", "new_kv_cache", "new_latent_cache", "write_kv", "write_latent",
           "rope_write_kv", "rope_write_latent",
           "flush_side_kv", "flush_side_latent", "flush_side_layers", "gather_kv", "gather_hm",
           "gather_scales", "gather_latent", "slot_indices"]


@dataclass
class KVCache:
    """Per-layer pools: head-major packed ``[Hkv, N_slots, 2D]`` in ``k``
    (``packed``), or slot-major ``[1, N_slots, Hkv, D]`` in ``k`` and ``v``;
    for an int8 cache also the per-layer fp32 scales ``[Hkv, N_slots + 1]`` of
    K and of V (the last column a spare). An MLA cache holds ``latent``
    instead: per-layer latent pools ``[1, N_slots, latent_dim]``."""

    k: Optional[List[torch.Tensor]] = None
    page_size: int = 16
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None
    latent: Optional[List[torch.Tensor]] = None
    v: Optional[List[torch.Tensor]] = None  # slot-major V pools; None when packed
    packed: bool = False

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def is_latent(self) -> bool:
        return self.latent is not None

    def arrays(self) -> List[List[torch.Tensor]]:
        """Every per-layer array list of the cache (the pools, then the
        scales of an int8 cache). Each array's slot dimension is dim 1."""
        if self.is_latent:
            return [self.latent]
        pools = [self.k] if self.packed else [self.k, self.v]
        if self.quantized:
            return pools + [self.k_scale, self.v_scale]
        return pools

    @property
    def num_slots(self) -> int:
        return self.arrays()[0][0].shape[1]

    @property
    def num_pages(self) -> int:
        return self.num_slots // self.page_size

    @property
    def num_layers(self) -> int:
        return len(self.arrays()[0])


def _use_packed(head_dim: int) -> bool:
    """The packed head-major layout for any head_dim whose K|V row tiles the
    reference's 128-lane registers; slot-major pools otherwise, or for every
    head_dim under ``ZT_NO_PACKED_KV=1`` (read here, as the reference reads
    it). The switch picks a layout: both layouts run CUDA kernels."""
    if os.environ.get("ZT_NO_PACKED_KV") == "1":
        return False
    return (2 * head_dim) % 128 == 0


def new_kv_cache(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    quantized: bool = False,
    device: Optional[torch.device] = None,
) -> KVCache:
    N = num_pages * page_size
    store_dtype = torch.int8 if quantized else dtype
    packed = _use_packed(head_dim)
    shape = (num_kv_heads, N, 2 * head_dim) if packed else (1, N, num_kv_heads, head_dim)

    def pools():
        return [torch.zeros(shape, dtype=store_dtype, device=device) for _ in range(num_layers)]

    def scales():
        # one spare column past the pool's slots takes the scales of skipped
        # rows (slot < 0), so the scatter needs no mask and no host sync
        return [torch.zeros((num_kv_heads, N + 1), dtype=torch.float32, device=device)
                for _ in range(num_layers)]

    return KVCache(
        k=pools(), v=None if packed else pools(), page_size=page_size, packed=packed,
        k_scale=scales() if quantized else None, v_scale=scales() if quantized else None,
    )


def new_latent_cache(
    num_layers: int,
    num_pages: int,
    page_size: int,
    latent_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[torch.device] = None,
) -> KVCache:
    """A zeroed MLA latent cache: one ``[1, N_slots, latent_dim]`` pool per
    layer in ``dtype``. There is no int8 form, as in the reference."""
    shape = (1, num_pages * page_size, latent_dim)
    return KVCache(
        latent=[torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
        page_size=page_size,
    )


# per-(token, head) absmax int8 quantization of K or V rows (kept beside the
# prologue kernel's plain version, which shares it)
_quantize_rows = kv_write.quantize_rows


def _write_rows(cache: KVCache, layer: int, k_rows, v_rows, slot_mapping) -> None:
    """Rows into layer ``layer``'s pools, whatever the layout and dtype: the
    CUDA writes move bytes, so int8 rows take the same kernel as model-dtype
    rows (the reference scatters slot-major int8 rows through XLA)."""
    if cache.packed:
        kv_write.write_rows_hm(cache.k[layer], k_rows, v_rows, slot_mapping)
    else:
        kv_write.write_rows_pair(cache.k[layer], cache.v[layer], k_rows, v_rows, slot_mapping)


def write_kv(
    cache: KVCache,
    layer: int,
    k_new: torch.Tensor,         # [T, Hkv, D]
    v_new: torch.Tensor,         # [T, Hkv, D]
    slot_mapping: torch.Tensor,  # [T] int32 flat slot (page*page_size + offset); < 0 => skip
) -> KVCache:
    """Write new K/V rows into layer ``layer``'s pools, in place. An int8
    cache quantizes the rows first and scatters their scales beside them
    (plain tensor ops, as the reference leaves both to XLA)."""
    if cache.quantized:
        # K and V in one pass: half the small launches of two
        rows, scales = _quantize_rows(torch.stack((k_new, v_new)))  # [2, T, Hkv, D], [2, T, Hkv]
        _write_rows(cache, layer, rows[0], rows[1], slot_mapping)
        kv_write.scatter_scales(cache.k_scale[layer], cache.v_scale[layer], scales, slot_mapping)
        return cache
    dtype = cache.k[layer].dtype
    _write_rows(cache, layer, k_new.to(dtype).contiguous(), v_new.to(dtype).contiguous(),
                slot_mapping)
    return cache


def rope_write_kv(
    cache: KVCache,
    layer: int,
    q: torch.Tensor,             # [T, Hq, D]
    k: torch.Tensor,             # [T, Hkv, D]
    v: torch.Tensor,             # [T, Hkv, D]
    cos_f: torch.Tensor,         # [T, D] fp32 (RopeTable.rot_values)
    sin_f: torch.Tensor,
    neox: bool,
    slot_mapping: torch.Tensor,  # [T] int32; < 0 => skip
) -> torch.Tensor:
    """The attention prologue of a packed or slot-major cache: rotate q and
    k, write the K and V rows into layer ``layer``'s pools in place (an int8
    cache quantizes them and scatters their scales), one launch on the GPU;
    returns q rotated. The same as :func:`apply_rope_rot` on q and k followed
    by :func:`write_kv`, bit for bit."""
    scales = (cache.k_scale[layer], cache.v_scale[layer]) if cache.quantized else ()
    if cache.packed:
        return kv_write.rope_write_rows_hm(cache.k[layer], q, k, v, cos_f, sin_f, neox,
                                           slot_mapping, *scales)
    return kv_write.rope_write_rows_pair(cache.k[layer], cache.v[layer], q, k, v, cos_f, sin_f,
                                         neox, slot_mapping, *scales)


def rope_write_latent(
    cache: KVCache,
    layer: int,
    q_pe: torch.Tensor,          # [T, H, rope]
    c_kv: torch.Tensor,          # [T, kv_lora_rank]
    k_pe: torch.Tensor,          # [T, rope]
    cos_f: torch.Tensor,         # [T, rope] fp32
    sin_f: torch.Tensor,
    neox: bool,
    slot_mapping: torch.Tensor,  # [T] int32; < 0 => skip
) -> torch.Tensor:
    """The latent pool's attention prologue: rotate q_pe and k_pe and write
    the latent rows ``c_kv | rope(k_pe)`` into layer ``layer``'s pool in
    place, one launch on the GPU; returns q_pe rotated."""
    return kv_write.rope_write_rows_2d(cache.latent[layer], q_pe, c_kv, k_pe, cos_f, sin_f,
                                       neox, slot_mapping)


def write_latent(
    cache: KVCache,
    layer: int,
    latent_new: torch.Tensor,    # [T, latent_dim]
    slot_mapping: torch.Tensor,  # [T] int32; < 0 => skip
) -> KVCache:
    """Write new latent rows into layer ``layer``'s pool, in place."""
    kv_write.write_rows_2d(cache.latent[layer], latent_new, slot_mapping)
    return cache


def flush_side_kv(
    cache: KVCache,
    layer: int,
    rows: torch.Tensor,          # [B, Hkv, Kw, 2D] window rows (fp32 for an int8 cache)
    entry_pos: torch.Tensor,     # [B] int32 position of each slot's first window row
    n_rows: torch.Tensor,        # [B] int32 live window rows
    page_tables: torch.Tensor,   # [B, maxp] int32
) -> KVCache:
    """Flush one layer's window rows into its packed pool, in place. An int8
    cache requantizes them (idempotent on the values the window attended
    over) and writes their scales in the same launch."""
    if cache.quantized:
        kv_write.flush_side_layers_hm([cache.k[layer]], rows[None], entry_pos, n_rows,
                                      page_tables, cache.page_size, [cache.k_scale[layer]],
                                      [cache.v_scale[layer]])
    else:
        kv_write.flush_side_rows_hm(cache.k[layer], rows, entry_pos, n_rows, page_tables,
                                    cache.page_size)
    return cache


def flush_side_latent(cache: KVCache, layer: int, rows, entry_pos, n_rows, page_tables) -> KVCache:
    """Flush one layer's window latent rows [B, Kw, latent_dim] into its
    pool, in place."""
    kv_write.flush_side_rows_2d(cache.latent[layer], rows, entry_pos, n_rows, page_tables,
                                cache.page_size)
    return cache


def flush_side_layers(
    cache: KVCache,
    side: torch.Tensor,          # [L, B, Hkv, Kw, 2D] (fp32 for an int8 cache) or [L, B, Kw, X]
    entry_pos: torch.Tensor,     # [B] int32 position of each slot's first window row
    n_rows: torch.Tensor,        # [B] int32 live window rows
    page_tables: torch.Tensor,   # [B, maxp] int32
) -> KVCache:
    """Flush every layer's window rows into its pool (packed, or latent),
    in place, in one kernel launch on the GPU; an int8 cache's rows are
    requantized and their scales written in the same launch."""
    if cache.is_latent:
        kv_write.flush_side_layers_2d(cache.latent, side, entry_pos, n_rows, page_tables,
                                      cache.page_size)
    else:
        kv_write.flush_side_layers_hm(cache.k, side, entry_pos, n_rows, page_tables,
                                      cache.page_size, cache.k_scale, cache.v_scale)
    return cache


def slot_indices(page_indices: torch.Tensor, page_size: int) -> torch.Tensor:
    """[..., pages] page ids -> [..., pages*page_size] slot ids (padding
    pages, < 0, read page 0 and are masked by the caller)."""
    safe = page_indices.clamp_min(0).long()
    slots = safe[..., None] * page_size + torch.arange(page_size, device=safe.device)
    return slots.reshape(*page_indices.shape[:-1], page_indices.shape[-1] * page_size)


def gather_hm(
    pool: torch.Tensor,          # [Hkv, N, 2D]
    page_indices: torch.Tensor,  # [..., pages]
    page_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather pages into contiguous K and V ``[..., pages*page_size, Hkv, D]``."""
    kv = torch.movedim(pool[:, slot_indices(page_indices, page_size)], 0, -2)
    d = kv.shape[-1] // 2
    return kv[..., :d], kv[..., d:]


def gather_scales(
    scales: torch.Tensor,        # [Hkv, >= N]
    page_indices: torch.Tensor,  # [..., pages]
    page_size: int,
) -> torch.Tensor:
    """Gather pages of a scale array into ``[..., pages*page_size, Hkv]``."""
    return torch.movedim(scales[:, slot_indices(page_indices, page_size)], 0, -1)


def gather_kv(
    cache: KVCache, layer: int, page_indices: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous K and V ``[..., pages*page_size, Hkv, D]`` of the given
    pages. An int8 cache is dequantized and, as in the reference's
    ``gather_kv``, rounded to bf16 (the slot-major prefill attends over this)."""
    if cache.packed:
        k, v = gather_hm(cache.k[layer], page_indices, cache.page_size)
    else:
        slots = slot_indices(page_indices, cache.page_size)
        k, v = cache.k[layer][0][slots], cache.v[layer][0][slots]
    if cache.quantized:
        ks = gather_scales(cache.k_scale[layer], page_indices, cache.page_size)
        vs = gather_scales(cache.v_scale[layer], page_indices, cache.page_size)
        k = (k.float() * ks[..., None]).to(torch.bfloat16)
        v = (v.float() * vs[..., None]).to(torch.bfloat16)
    return k, v


def gather_latent(cache: KVCache, layer: int, page_indices: torch.Tensor) -> torch.Tensor:
    """Gather latent pages into ``[..., pages*page_size, latent_dim]``."""
    return cache.latent[layer][0][slot_indices(page_indices, cache.page_size)]
