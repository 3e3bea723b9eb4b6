"""The port's kernel modules (zhilight_tpu_torch/ops/cuda) against the JAX
package's Pallas kernels run in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold the plain versions to the Pallas kernels, on the input builders of the
Pallas kernels' own tests. The KV write is also held to the XLA scatter on
a chunk that starts mid-page, which the Pallas prefill kernel's page-aligned
contract does not cover. Tolerance: fp32 rtol = atol = 1e-4 (the Pallas
kernels run an online softmax, the plain versions a full one); writes are
exact. The CUDA kernels themselves are held to these plain versions on the
GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_headmajor_attention import _setup as decode_setup
from test_prefill_kernel import _setup as prefill_setup
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.kvcache import write_kv as j_write_kv
from zhilight_tpu.ops.pallas.attn_headmajor import paged_decode_attention_hm as j_decode
from zhilight_tpu.ops.pallas.kv_write import write_rows_hm as j_write_rows_hm
from zhilight_tpu.ops.pallas.prefill_attention import paged_prefill_attention_hm as j_prefill
from zhilight_tpu.ops.pallas.prefill_attention import (
    paged_prefill_attention_hm_packed as j_prefill_packed,
)
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import prefill_attention as P

RTOL = ATOL = 1e-4
S = 16
T = torch.from_numpy


# ---------------------------------------------------------------------------
# write_rows_hm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,H", [(1, 4), (8, 36), (16, 12), (64, 36)])
def test_write_rows_hm_matches_pallas(n, H):
    """The Pallas kernel's contract cases (tests/test_kv_write_kernel.py):
    decode rows on exclusive pages with a skipped row; prefill page runs
    whose valid rows form page prefixes."""
    P_, X = 24, 128
    rng = np.random.RandomState(n + H)
    pool = rng.randn(H, P_ * S, X).astype(np.float32)
    rows = rng.randn(n, H, X).astype(np.float32)
    if n >= 2 * S:
        slots = np.arange(n, dtype=np.int32) + S
        slots[-3:] = -1
    else:
        pages = rng.choice(P_, size=n, replace=False)
        slots = np.array([pg * S + rng.randint(S) for pg in pages], np.int32)
        if n > 2:
            slots[1] = -1
    want = j_write_rows_hm(jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(slots), S,
                           interpret=True)
    got = W.write_rows_hm(T(pool.copy()), T(rows[..., : X // 2]).contiguous(),
                          T(rows[..., X // 2 :]).contiguous(), T(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("start,n", [(5, 24), (13, 40), (3, 1)])
def test_write_rows_hm_mid_page_matches_scatter(start, n):
    """A chunk starting mid-page through a shuffled page table, against the
    reference's XLA scatter (zhilight_tpu.kvcache.write_kv on a packed pool)."""
    H, D, pages = 4, 64, 12
    rng = np.random.RandomState(start)
    table = rng.permutation(pages)
    pos = np.arange(start, start + n)
    slots = (table[pos // S] * S + pos % S).astype(np.int32)
    k = rng.randn(n, H, D).astype(np.float32)
    v = rng.randn(n, H, D).astype(np.float32)
    jcache = j_new_kv_cache(1, pages, S, H, D, jnp.float32)
    assert jcache.packed
    want = j_write_kv(jcache, 0, jnp.asarray(k), jnp.asarray(v), jnp.asarray(slots)).k[0]
    got = W.write_rows_hm(torch.zeros(H, pages * S, 2 * D), T(k), T(v), T(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# paged_decode_attention_hm
# ---------------------------------------------------------------------------

def _pool(k, v):
    return np.concatenate([k, v], axis=-1).transpose(1, 0, 2).copy()  # [Hkv, N, 2D]


@pytest.mark.parametrize("hkv,hq", [(2, 8), (36, 36), (1, 16)])
@pytest.mark.parametrize("sliding_window", [0, 24])
def test_decode_attention_matches_pallas(hkv, hq, sliding_window):
    q, k, v, tables, ctx = decode_setup(Hq=hq, Hkv=hkv)
    pool = _pool(k, v)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = j_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(ctx),
                    S, scale, sliding_window=sliding_window, interpret=True)
    got = A.paged_decode_attention_hm(T(q), T(pool), T(tables), T(ctx), S, scale, sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decode_attention_empty_slot_is_zero_like_pallas():
    q, k, v, tables, ctx = decode_setup(B=3)
    ctx[1] = 0
    tables[1] = -1
    pool = _pool(k, v)
    want = j_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(ctx),
                    S, 0.125, interpret=True)
    got = A.paged_decode_attention_hm(T(q), T(pool), T(tables), T(ctx), S, 0.125)
    assert not torch.isnan(got).any()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# paged_prefill_attention_hm(_packed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "n,cache_len,q_len,hq,hkv,D,window",
    [
        (64, 0, 50, 8, 2, 64, 0),     # first chunk, GQA, padding rows
        (64, 0, 50, 16, 1, 64, 0),    # MQA
        (32, 37, 29, 8, 2, 64, 0),    # later chunk, not page-aligned
        (32, 160, 29, 4, 4, 64, 0),   # later chunk, MHA
        (48, 64, 48, 4, 4, 64, 40),   # sliding window
        (40, 0, 40, 8, 8, 128, 0),    # head_dim 128
    ],
)
def test_prefill_attention_matches_pallas(n, cache_len, q_len, hq, hkv, D, window):
    q, k, v, pages, _ = prefill_setup(n, cache_len + q_len, hq, hkv, D, seed=cache_len + hq)
    pool = _pool(k, v)
    scale = 1.0 / np.sqrt(D)
    want = j_prefill(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(pages), jnp.int32(cache_len),
                     jnp.int32(q_len), S, scale, sliding_window=window, interpret=True)
    got = P.paged_prefill_attention_hm(T(q), T(pool), T(pages), torch.tensor(cache_len),
                                       torch.tensor(q_len), S, scale, window)
    np.testing.assert_allclose(got[:q_len].numpy(), np.asarray(want)[:q_len], rtol=RTOL, atol=ATOL)


def test_packed_prefill_attention_matches_pallas():
    """Packed segments with cache_len > 0 and an empty (q_len 0) segment
    (the builder of tests/test_prefill_kernel.py's packed test)."""
    rng = np.random.RandomState(3)
    Hkv, G, D = 2, 2, 64
    NS, TC, maxp = 4, 64, 16
    pool = rng.randn(Hkv, NS * maxp * S, 2 * D).astype(np.float32)
    q = rng.randn(NS * TC, Hkv * G, D).astype(np.float32)
    tables = np.stack([s * maxp + np.arange(maxp) for s in range(NS)]).astype(np.int32)
    cache_lens = np.array([32, 0, 100, 7], np.int32)
    q_lens = np.array([64, 40, 64, 0], np.int32)
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(j_prefill_packed(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables),
                                       jnp.asarray(cache_lens), jnp.asarray(q_lens), S, scale,
                                       0, True))
    got = P.paged_prefill_attention_hm_packed(T(q), T(pool), T(tables), T(cache_lens),
                                              T(q_lens), S, scale).numpy()
    assert np.all(np.isfinite(got))
    for s in range(NS):
        rows = slice(s * TC, s * TC + int(q_lens[s]))
        np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device (here the
    meta device) gets no plain version and no kernel: the wrappers raise."""
    meta = dict(device="meta")
    pool = torch.empty(2, 64, 128, **meta)
    q = torch.empty(3, 4, 64, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(NotImplementedError):
        W.write_rows_hm(pool, torch.empty(3, 2, 64, **meta), torch.empty(3, 2, 64, **meta),
                        torch.empty(3, **i32))
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm(q, pool, torch.empty(3, 4, **i32), torch.empty(3, **i32), S, 0.125)
    with pytest.raises(NotImplementedError):
        P.paged_prefill_attention_hm_packed(q, pool, torch.empty(1, 4, **i32), torch.empty(1, **i32),
                                            torch.empty(1, **i32), S, 0.125)


@pytest.mark.parametrize("kw", [dict(emit_partial=True), dict(v_dim=64)])
def test_decode_attention_modes_of_later_slices_raise(kw):
    q, k, v, tables, ctx = decode_setup(B=2)
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm(T(q), T(_pool(k, v)), T(tables), T(ctx), S, 0.125, **kw)
