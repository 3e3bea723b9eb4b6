"""The native (C++) host runtime: the page allocator and the ngram penalty map.

Counterpart of ``zhilight_tpu/native``, over the port's own copy of the
source, ``zhilight_tpu_torch/csrc/native.cpp``: a ref-counted page pool with a
full-page prefix index and LRU eviction, and the KMP ngram repetition penalty.
The library is compiled with ``g++`` at first use into
``zhilight_tpu_torch/build/native-<digest>.so`` (the digest covers the source
and the flags) and loaded with :mod:`ctypes`. Each build writes a file of its
own and moves it into place, so processes that build at once do not clash.

There is no silent fallback: ``ZT_NO_NATIVE=1`` in the environment selects the
Python implementations (:func:`enabled` is False); otherwise a failed build
or load raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..kvcache.allocator import PageAllocator

__all__ = ["enabled", "build", "load", "NativePageAllocator", "native_ngram_penalty_map"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "native.cpp"
_BUILD = _PKG / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None


def enabled() -> bool:
    """False when the caller asked for the Python implementations
    (``ZT_NO_NATIVE=1``)."""
    return os.environ.get("ZT_NO_NATIVE") != "1"


def build(src: Path, build_dir: Path) -> Path:
    """Compile ``src`` into ``build_dir/native-<digest>.so`` unless it is
    there already; returns its path. Raises RuntimeError with ``g++``'s output
    if the compile fails."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    so = Path(build_dir) / f"native-{digest[:16]}.so"
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    out = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build of {src} failed (g++ exit {out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The native library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build(_SRC, _BUILD)))
        i32, f32, vp = ctypes.c_int32, ctypes.c_float, ctypes.c_void_p
        pi32, pf32 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
        lib.pa_create.restype = vp
        lib.pa_create.argtypes = [i32, i32, i32]
        lib.pa_destroy.argtypes = [vp]
        lib.pa_alloc.restype = i32
        lib.pa_alloc.argtypes = [vp]
        lib.pa_ref.argtypes = [vp, i32]
        lib.pa_free_page.restype = i32
        lib.pa_free_page.argtypes = [vp, i32]
        lib.pa_num_free.restype = i32
        lib.pa_num_free.argtypes = [vp]
        lib.pa_match_prefix.restype = i32
        lib.pa_match_prefix.argtypes = [vp, pi32, i32, pi32, i32]
        lib.pa_register_prefix.argtypes = [vp, pi32, i32, pi32, i32]
        lib.pa_num_cached.restype = i32
        lib.pa_num_cached.argtypes = [vp]
        lib.ngram_penalty.restype = i32
        lib.ngram_penalty.argtypes = [pi32, i32, f32, f32, pi32, pf32, i32]
        _lib = lib
        return _lib


def _i32(values) -> np.ndarray:
    return np.asarray(list(values), dtype=np.int32)


def _ptr(arr: np.ndarray, ctype=ctypes.c_int32):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativePageAllocator(PageAllocator):
    """:class:`PageAllocator`'s surface over the C++ pool: its state lives in
    the library. ``match_prefix`` stays the Python class's entry point (the
    disabled-cache check), which calls :meth:`_match_full_pages` here."""

    def __init__(self, num_pages: int, page_size: int, enable_prefix_cache: bool = False):
        self._lib = load()
        self._h = self._lib.pa_create(num_pages, page_size, 1 if enable_prefix_cache else 0)
        self.num_pages = num_pages
        self.page_size = page_size
        self.enable_prefix_cache = enable_prefix_cache

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.pa_destroy(h)

    @property
    def num_free(self) -> int:
        return int(self._lib.pa_num_free(self._h))

    @property
    def num_cached(self) -> int:
        return int(self._lib.pa_num_cached(self._h))

    def alloc_page(self):
        p = int(self._lib.pa_alloc(self._h))
        return None if p < 0 else p

    def ref_page(self, page: int) -> None:
        self._lib.pa_ref(self._h, page)

    def free_page(self, page: int) -> None:
        rc = self._lib.pa_free_page(self._h, page)
        assert rc == 0, f"double free of page {page}"

    def _match_full_pages(self, tokens) -> Tuple[List[int], int]:
        arr = _i32(tokens)
        cap = max(len(arr) // self.page_size + 1, 1)
        out = np.zeros(cap, dtype=np.int32)
        n = self._lib.pa_match_prefix(self._h, _ptr(arr), len(arr), _ptr(out), cap)
        return out[:n].tolist(), int(n) * self.page_size

    def register_prefix(self, tokens, pages) -> None:
        arr, pg = _i32(tokens), _i32(pages)
        self._lib.pa_register_prefix(self._h, _ptr(arr), len(arr), _ptr(pg), len(pg))


def native_ngram_penalty_map(all_tokens, ngram_penalty: float,
                             repetition_penalty: float) -> Dict[int, float]:
    """The C++ ``calc_repetition_ngram`` over the reversed sequence, times
    ``repetition_penalty``."""
    lib = load()
    rev = _i32(list(all_tokens)[::-1])
    cap = len(rev) + 1
    out_t = np.zeros(cap, dtype=np.int32)
    out_v = np.zeros(cap, dtype=np.float32)
    n = lib.ngram_penalty(_ptr(rev), len(rev), ctypes.c_float(ngram_penalty),
                          ctypes.c_float(repetition_penalty), _ptr(out_t),
                          _ptr(out_v, ctypes.c_float), cap)
    return {int(t): float(v) for t, v in zip(out_t[:n], out_v[:n])}
