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


@pytest.mark.parametrize("D,hkv,hq,sliding_window", [
    (192, 2, 8, 0),    # G 4 at head_dim 192
    (256, 1, 16, 0),   # G 16 at 256
    (128, 2, 32, 0),   # G 16 at 128
    (256, 2, 4, 24),   # a sliding window at 256
])
def test_decode_attention_wide_heads_match_pallas(D, hkv, hq, sliding_window):
    """The head dims and query groups the bf16 CUDA kernel takes beyond D 64
    and 128 with G <= 8: its plain version against the Pallas kernel."""
    q, k, v, tables, ctx = decode_setup(Hq=hq, Hkv=hkv, D=D, seed=D + hq)
    pool = _pool(k, v)
    scale = 1.0 / np.sqrt(D)
    want = j_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables), jnp.asarray(ctx),
                    S, scale, sliding_window=sliding_window, interpret=True)
    got = A.paged_decode_attention_hm(T(q), T(pool), T(tables), T(ctx), S, scale, sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,Hkv,G,max_ctx,capacity,want", [
    (16, 36, 1, 4096, 792, 1),     # MiniCPM-2B's batch: 576 blocks in one wave, no split
    (8, 8, 5, 3904, 264, 4),       # Qwen2.5-14B's: 64 blocks, 4 splits fill two an SM
    (8, 8, 5, 64, 264, 1),         # one tile to split
    (8, 8, 5, 0, 264, 1),          # nothing to address
    (1, 1, 1, 1 << 20, 264, 64),   # the most splits the kernel takes
    (8, 2, 40, 3000, 264, 5),      # G 40: three row groups of 16 a KV head
    (32, 36, 1, 4096, 792, 1),     # more blocks than one wave: never fewer than 1
])
def test_decode_splits(B, Hkv, G, max_ctx, capacity, want):
    """The bf16 decode kernel's split count: as many splits as keep every
    block in one wave of ``capacity`` blocks, never more than the
    addressable context has 64-token tiles (a split is whole tiles), at
    least 1 and at most 64."""
    assert A.decode_splits(B, Hkv, G, max_ctx, capacity) == want


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
        (48, 0, 40, 8, 4, 192, 0),    # head_dim 192, GQA, padding rows
        (32, 37, 29, 8, 2, 256, 24),  # head_dim 256: a window, a chunk not page-aligned
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


# ---------------------------------------------------------------------------
# the twins: plain versions in the kernels' rounding order, on bf16 inputs
# ---------------------------------------------------------------------------

# max |twin - Pallas| / max |Pallas| on bf16 inputs. Twin and kernel round the
# unnormalized p to bf16 for P.V and divide by l last; what differs is the
# order of the fp32 sums and, in prefill, the Pallas kernel's running max over
# its key blocks (measured at most 2^-10 on these inputs). The plain versions
# round the normalized probabilities, as the XLA path does, which costs up to
# one bf16 ulp of the output: on the (seed 0, V x 6) case, with outputs in
# [4, 16), more than this bound.
TWIN_TOL = 2.0 ** -8


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16)


def _twin_errors(got_twin, got_plain, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    top = np.abs(want).max()
    return (np.abs(got_twin.float().numpy() - want).max() / top,
            np.abs(got_plain.float().numpy() - want).max() / top)


def _torch_bf16(x):
    return T(np.array(x.astype(jnp.float32))).bfloat16()


@pytest.mark.parametrize("seed,v_mul", [(0, 1.0), (1, 1.0), (0, 6.0)])
def test_decode_attention_twin_matches_pallas_on_bf16(seed, v_mul):
    """paged_decode_attention_hm_twin against the Pallas kernel on a bf16
    pool; the plain version is further off, and on (0, 6.0) outside the
    bound."""
    q, k, v, tables, ctx = decode_setup(B=4, Hq=8, Hkv=2, D=64, seed=seed)
    qb, pool = _bf16(q), _bf16(_pool(k, v * v_mul))
    want = j_decode(qb, pool, jnp.asarray(tables), jnp.asarray(ctx), S, 0.125, interpret=True)
    args = (_torch_bf16(qb), _torch_bf16(pool), T(tables), T(ctx), S, 0.125)
    twin, plain = _twin_errors(A.paged_decode_attention_hm_twin(*args),
                               A.paged_decode_attention_hm_plain(*args), want)
    assert twin <= TWIN_TOL and twin <= plain
    if v_mul > 1:
        assert plain > TWIN_TOL


@pytest.mark.parametrize("seed,v_mul", [(0, 1.0), (1, 1.0), (0, 6.0)])
def test_prefill_attention_twin_matches_pallas_on_bf16(seed, v_mul):
    """paged_prefill_attention_hm_packed_twin against the Pallas kernel on a
    bf16 pool: a 50-token chunk at cache 40."""
    n, cache_len, q_len, D = 64, 40, 50, 64
    q, k, v, pages, _ = prefill_setup(n, cache_len + q_len, 8, 2, D, seed=seed)
    qb, pool = _bf16(q), _bf16(_pool(k, v * v_mul))
    want = j_prefill(qb, pool, jnp.asarray(pages), jnp.int32(cache_len), jnp.int32(q_len), S,
                     0.125, interpret=True)[:q_len]
    args = (_torch_bf16(qb), _torch_bf16(pool), T(pages)[None],
            torch.tensor([cache_len], dtype=torch.int32), torch.tensor([q_len], dtype=torch.int32),
            S, 0.125)
    twin, plain = _twin_errors(P.paged_prefill_attention_hm_packed_twin(*args)[:q_len],
                               P.paged_prefill_attention_hm_packed_plain(*args)[:q_len], want)
    assert twin <= TWIN_TOL and twin <= plain
    if v_mul > 1:
        assert plain > TWIN_TOL


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


@pytest.mark.parametrize("kw", [dict(emit_partial=True), dict(emit_partial=True, v_dim=64)])
def test_decode_attention_modes_of_later_slices_raise(kw):
    """The flash-partial output, in the default and in the latent mode, takes
    its plain version only on the CPU (both are held to the Pallas kernels in
    tests/test_torch_window.py): on the meta device it raises."""
    q, k, v, tables, ctx = decode_setup(B=2)
    args = [T(q), T(_pool(k, v)), T(tables), T(ctx)]
    if "v_dim" in kw:  # the latent mode: one [1, N, stored] pool
        args[1] = args[1][:1].contiguous()
    m, l, acc = A.paged_decode_attention_hm(*args, S, 0.125, **kw)
    assert m.dtype == l.dtype == acc.dtype == torch.float32 and acc.shape[-1] == 64
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm(*(a.to("meta") for a in args), S, 0.125, **kw)
