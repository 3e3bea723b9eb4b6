"""Host-side page allocator with prefix-sharing.

Functional parity with the reference's ``BlockAllocator`` / ``BlockTrieNode``
copy-on-write prefix trie (src/kvcache/block_allocator.h, paged_kvcache.cu)
and the scheduler-level ``PrefixCache`` LRU (src/generator/prefix_cache.hpp:25-140):
ref-counted pages, full-page prefix reuse keyed by token-chunk hashes, LRU
eviction of unreferenced cached pages. This is pure host bookkeeping — the
device only ever sees page-index tables, so no device allocation/defrag is
needed (the reference's defragmentation machinery has no TPU analogue by design).

Copy of ``zhilight_tpu/kvcache/allocator.py``. The scheduler takes the C++
allocator (``zhilight_tpu_torch/native``, a subclass of :class:`PageAllocator`)
unless ``ZT_NO_NATIVE=1`` asks for this Python one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PageAllocator", "make_page_allocator"]


def make_page_allocator(num_pages: int, page_size: int, enable_prefix_cache: bool = False):
    """The page allocator the scheduler uses: the C++ one
    (``csrc/native.cpp``), or the Python one below under ``ZT_NO_NATIVE=1``.
    Both expose the same surface; tests assert behavioral parity. A failed
    build of the C++ one raises."""
    from .. import native

    if native.enabled():
        return native.NativePageAllocator(num_pages, page_size, enable_prefix_cache)
    return PageAllocator(num_pages, page_size, enable_prefix_cache)


def _chunk_key(prev_key: int, tokens: Tuple[int, ...]) -> int:
    return hash((prev_key, tokens))


@dataclass
class _PageInfo:
    ref_count: int = 0
    # prefix-cache identity: hash chain key of the full-page token content
    key: Optional[int] = None
    lru_tick: int = 0


class PageAllocator:
    """Ref-counted page pool + optional prefix cache.

    The device never moves KV data for reuse: a prefix hit just places the
    shared page index into the new sequence's block table (copy-on-write is
    unnecessary because full pages are immutable once complete).
    """

    def __init__(self, num_pages: int, page_size: int, enable_prefix_cache: bool = False):
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_cache = enable_prefix_cache
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._info: List[_PageInfo] = [_PageInfo() for _ in range(num_pages)]
        # full-page content hash -> page index (reference BlockTrieNode role)
        self._prefix_index: Dict[int, int] = {}
        # cached-but-unreferenced pages eligible for eviction, LRU ordered
        self._tick = 0

    # -- capacity ---------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + sum(
            1
            for p, i in self._prefix_index.items()
            if self._info[i].ref_count == 0
        )

    def free_token_capacity(self) -> int:
        return self.num_free * self.page_size

    @property
    def num_cached(self) -> int:
        return len(self._prefix_index)

    # -- core alloc/free --------------------------------------------------
    def _evict_one(self) -> bool:
        """Evict the least-recently-used unreferenced cached page."""
        victim_key, victim_page, best = None, None, None
        for key, page in self._prefix_index.items():
            info = self._info[page]
            if info.ref_count == 0 and (best is None or info.lru_tick < best):
                victim_key, victim_page, best = key, page, info.lru_tick
        if victim_page is None:
            return False
        del self._prefix_index[victim_key]
        self._info[victim_page] = _PageInfo()
        self._free.append(victim_page)
        return True

    def alloc_page(self) -> Optional[int]:
        if not self._free and not self._evict_one():
            return None
        page = self._free.pop()
        info = self._info[page]
        info.ref_count = 1
        info.key = None
        return page

    def ref_page(self, page: int) -> None:
        self._info[page].ref_count += 1

    def free_page(self, page: int) -> None:
        info = self._info[page]
        assert info.ref_count > 0, f"double free of page {page}"
        info.ref_count -= 1
        if info.ref_count == 0:
            if info.key is not None and self.enable_prefix_cache:
                # keep cached for future prefix hits; evictable via LRU
                self._tick += 1
                info.lru_tick = self._tick
            else:
                self._free.append(page)
                self._info[page] = _PageInfo()

    def free_pages(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.free_page(p)

    # -- prefix cache -----------------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached full-page prefix of ``tokens``.

        Returns (pages, num_cached_tokens). The returned pages have their
        refcount incremented. Mirrors the scheduler's prefix-cache match in
        fill_encode_input (batch_generator.cpp:1120-1122); matching is
        whole-page granular like PrefixCache's block keys.
        """
        if not self.enable_prefix_cache:
            return [], 0
        return self._match_full_pages(tokens)

    def _match_full_pages(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        pages: List[int] = []
        key = 0
        n = 0
        S = self.page_size
        # never match the entire prompt: leave >=1 token to prefill so the
        # model still produces a first output token (reference behaves the same
        # by reserving the last token for encode)
        limit = (max(len(tokens) - 1, 0)) // S
        for i in range(limit):
            chunk = tuple(tokens[i * S : (i + 1) * S])
            key = _chunk_key(key, chunk)
            page = self._prefix_index.get(key)
            if page is None:
                break
            self._tick += 1
            self._info[page].lru_tick = self._tick
            self._info[page].ref_count += 1
            pages.append(page)
            n += S
        return pages, n

    def register_prefix(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Register completed full pages of a sequence for future reuse
        (reference save_prompt_cache, batch_generator.cpp:1213-1225)."""
        if not self.enable_prefix_cache:
            return
        key = 0
        S = self.page_size
        for i in range(len(tokens) // S):
            if i >= len(pages):
                break
            chunk = tuple(tokens[i * S : (i + 1) * S])
            key = _chunk_key(key, chunk)
            page = pages[i]
            existing = self._prefix_index.get(key)
            if existing is None:
                info = self._info[page]
                if info.key is None:
                    info.key = key
                    self._prefix_index[key] = page
            # if a different page already holds this prefix chunk, keep the
            # existing one (first writer wins); both stay valid for readers.
