"""Device-side paged KV cache.

Counterpart of ``zhilight_tpu/kvcache/paged.py``: one statically shaped
paged pool per layer, addressed by page tables. The port holds the packed
head-major layout that the reference uses whenever ``2*head_dim % 128 == 0``:
each layer's pool is ``[Hkv, num_pages * page_size, 2*head_dim]``, K in
lanes ``[:D]`` and V in lanes ``[D:]``. Slot-major, int8 and MLA latent pools
are later slices of the port and raise ``NotImplementedError``.

Writes update the pool in place (PyTorch has no buffer donation to emulate):
:func:`write_kv` returns the same cache object it was given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..ops.cuda import kv_write

__all__ = ["KVCache", "new_kv_cache", "write_kv", "gather_kv", "gather_hm", "slot_indices"]


@dataclass
class KVCache:
    """Per-layer head-major packed pools ``[Hkv, N_slots, 2D]``."""

    k: List[torch.Tensor]
    page_size: int = 16

    @property
    def num_slots(self) -> int:
        return self.k[0].shape[1]

    @property
    def num_pages(self) -> int:
        return self.num_slots // self.page_size

    @property
    def num_layers(self) -> int:
        return len(self.k)


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
    if quantized:
        raise NotImplementedError("int8 KV pools are not ported yet")
    if (2 * head_dim) % 128:
        raise NotImplementedError(
            f"head_dim {head_dim}: slot-major pools (2*head_dim % 128 != 0) are not ported yet"
        )
    shape = (num_kv_heads, num_pages * page_size, 2 * head_dim)
    pools = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)]
    return KVCache(k=pools, page_size=page_size)


def write_kv(
    cache: KVCache,
    layer: int,
    k_new: torch.Tensor,         # [T, Hkv, D]
    v_new: torch.Tensor,         # [T, Hkv, D]
    slot_mapping: torch.Tensor,  # [T] int32 flat slot (page*page_size + offset); < 0 => skip
) -> KVCache:
    """Write new K/V rows into layer ``layer``'s pool, in place."""
    pool = cache.k[layer]
    kv_write.write_rows_hm(
        pool,
        k_new.to(pool.dtype).contiguous(),
        v_new.to(pool.dtype).contiguous(),
        slot_mapping,
    )
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


def gather_kv(
    cache: KVCache, layer: int, page_indices: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return gather_hm(cache.k[layer], page_indices, cache.page_size)
