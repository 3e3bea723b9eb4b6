"""The port's native host runtime (zhilight_tpu_torch/native over its own copy
of csrc/native.cpp) against the port's Python allocator and ngram map, and
against the JAX package's native library on the same random operations
(tests/test_native.py's three tests, then the port's own rules: the source is
the reference's byte for byte, ``ZT_NO_NATIVE=1`` is the only way to the
Python allocator, and a source that does not compile raises)."""

from pathlib import Path

import numpy as np
import pytest

from zhilight_tpu import native as jnative
from zhilight_tpu_torch import native
from zhilight_tpu_torch.engine.penalties import calc_repetition_ngram, ngram_penalty_map
from zhilight_tpu_torch.kvcache.allocator import PageAllocator, make_page_allocator
from zhilight_tpu_torch.native import NativePageAllocator, native_ngram_penalty_map

ROOT = Path(__file__).resolve().parents[1]


def _random_ops(a, b, seed, steps=500, pages=32):
    """Drive allocators ``a`` and ``b`` through the same random operations,
    holding their free counts, allocation results and prefix matches equal
    (``same_pages``: the page ids too)."""
    rng = np.random.RandomState(seed)
    held_a, held_b = [], []
    for step in range(steps):
        op = rng.randint(4)
        assert a.num_free == b.num_free, f"free divergence at step {step}"
        assert a.num_cached == b.num_cached, f"cached divergence at step {step}"
        if op == 0:  # alloc
            x, y = a.alloc_page(), b.alloc_page()
            assert (x is None) == (y is None)
            if x is not None:
                held_a.append(x)
                held_b.append(y)
        elif op == 1 and held_a:  # free
            i = rng.randint(len(held_a))
            a.free_page(held_a.pop(i))
            b.free_page(held_b.pop(i))
        elif op == 2 and held_a:  # ref + free (net zero)
            i = rng.randint(len(held_a))
            a.ref_page(held_a[i]); a.free_page(held_a[i])
            b.ref_page(held_b[i]); b.free_page(held_b[i])
        elif op == 3 and len(held_a) >= 2:  # register + rematch a prefix
            toks = list(rng.randint(0, 50, size=8))
            a.register_prefix(toks, held_a[:2])
            b.register_prefix(toks, held_b[:2])
            a_pages, a_n = a.match_prefix(toks + [1])
            b_pages, b_n = b.match_prefix(toks + [1])
            assert a_n == b_n
            assert len(a_pages) == len(b_pages)
            a.free_pages(a_pages)
            b.free_pages(b_pages)
    return held_a, held_b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_parity_random_ops(seed):
    _random_ops(PageAllocator(32, 4, enable_prefix_cache=True),
                NativePageAllocator(32, 4, enable_prefix_cache=True), seed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_the_jax_packages_native(seed):
    """The same C++ behind both bridges: the same page ids, op for op."""
    assert jnative.load() is not None
    held_t, held_j = _random_ops(NativePageAllocator(32, 4, enable_prefix_cache=True),
                                 jnative.NativePageAllocator(32, 4, enable_prefix_cache=True),
                                 seed)
    assert held_t == held_j


def test_prefix_reuse_and_eviction():
    cc = NativePageAllocator(4, 4, enable_prefix_cache=True)
    pages = [cc.alloc_page() for _ in range(4)]
    toks = list(range(16))
    cc.register_prefix(toks, pages)
    cc.free_pages(pages)  # cached, rc=0
    got, n = cc.match_prefix(toks + [99])
    assert n == 16 and got == pages  # the extra token is left for prefill
    # a query of exactly the registered tokens must keep one token unprefixed
    cc.free_pages(got)
    got2, n2 = cc.match_prefix(toks)
    assert n2 == 12 and got2 == pages[:3]
    cc.free_pages(got2)
    # pool exhausted of fresh pages -> eviction must recycle cached ones
    fresh = [cc.alloc_page() for _ in range(4)]
    assert all(p is not None for p in fresh)


def test_disabled_prefix_cache_matches_nothing():
    cc = NativePageAllocator(4, 4, enable_prefix_cache=False)
    pages = [cc.alloc_page() for _ in range(2)]
    cc.register_prefix(list(range(8)), pages)
    assert cc.match_prefix(list(range(9))) == ([], 0) and cc.num_cached == 0


def test_ngram_parity():
    rng = np.random.RandomState(1)
    for _ in range(20):
        seq = list(rng.randint(0, 12, size=rng.randint(1, 40)))
        p = float(rng.uniform(1.01, 2.0))
        rep = float(rng.uniform(1.0, 1.5))
        got = native_ngram_penalty_map(seq, p, rep)
        ref = {t: v * rep for t, v in calc_repetition_ngram(seq[::-1], p).items()}
        assert set(got) == set(ref)
        for t in ref:
            assert abs(got[t] - ref[t]) < 1e-4 * max(1.0, ref[t])
        # the JAX package's native library gives the same values
        assert got == jnative.native_ngram_penalty_map(seq, p, rep)


def test_source_is_the_references_byte_for_byte():
    assert (ROOT / "zhilight_tpu_torch" / "csrc" / "native.cpp").read_bytes() == \
        (ROOT / "csrc" / "native.cpp").read_bytes()


def test_default_is_native_and_zt_no_native_gives_python(monkeypatch):
    monkeypatch.delenv("ZT_NO_NATIVE", raising=False)
    assert type(make_page_allocator(8, 4, True)) is NativePageAllocator
    monkeypatch.setenv("ZT_NO_NATIVE", "1")
    assert type(make_page_allocator(8, 4, True)) is PageAllocator
    seq = [3, 4, 3, 4, 5]
    assert ngram_penalty_map(seq, 1.5, 1.2) == {
        t: v * 1.2 for t, v in calc_repetition_ngram(seq[::-1], 1.5).items()}


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile raises with g++'s
    output, from the build and from every entry point that needs it."""
    bad = tmp_path / "native.cpp"
    bad.write_text("extern \"C\" int pa_create( { return 0; }\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(bad, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*"))  # no library, no stray file

    monkeypatch.delenv("ZT_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build of .* failed"):
        make_page_allocator(8, 4, True)
    with pytest.raises(RuntimeError, match="native build of .* failed"):
        ngram_penalty_map([1, 2, 1], 1.5, 1.0)


def test_build_is_keyed_by_the_source(tmp_path):
    src = tmp_path / "native.cpp"
    src.write_bytes((ROOT / "csrc" / "native.cpp").read_bytes())
    first = native.build(src, tmp_path)
    assert first.exists() and native.build(src, tmp_path) == first
    src.write_bytes(src.read_bytes() + b"\n// edited\n")
    second = native.build(src, tmp_path)
    assert second != first and second.exists()
