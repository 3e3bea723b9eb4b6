from .allocator import PageAllocator, make_page_allocator
from .paged import (
    KVCache,
    gather_kv,
    gather_latent,
    new_kv_cache,
    new_latent_cache,
    write_kv,
    write_latent,
)

__all__ = [
    "PageAllocator",
    "make_page_allocator",
    "KVCache",
    "new_kv_cache",
    "new_latent_cache",
    "write_kv",
    "write_latent",
    "gather_kv",
    "gather_latent",
]
