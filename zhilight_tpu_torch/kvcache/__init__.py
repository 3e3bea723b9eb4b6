from .allocator import PageAllocator, make_page_allocator
from .paged import KVCache, gather_kv, new_kv_cache, write_kv

__all__ = [
    "PageAllocator",
    "make_page_allocator",
    "KVCache",
    "new_kv_cache",
    "write_kv",
    "gather_kv",
]
