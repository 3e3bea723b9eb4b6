"""The plain versions of the port's latent-row write and grouped int4 matmul
against the JAX package's Pallas kernels (interpret mode) and references, on
the CPU.

``write_rows_2d`` is bit-exact. The plain ``w4a16_ragged_matmul`` keeps fp32
activations, the Pallas kernel casts them to bf16: against the kernel the
outputs agree to 1e-2 of the largest, against a per-row dequantize-and-dot
reference to 1e-4. ``ragged_layout`` and the per-expert int4 packing are
integer work and must be equal. Inputs come from a numpy seed.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zhilight_tpu.ops.pallas import kv_write as JW
from zhilight_tpu.ops.pallas import quant_ragged as JR
from zhilight_tpu.ops.quant import dequant_int4 as j_dequant_int4
from zhilight_tpu_torch.ops import quant as TQ
from zhilight_tpu_torch.ops.cuda import kv_write as TW
from zhilight_tpu_torch.ops.cuda import quant_ragged as TR

T = torch.from_numpy


# ---------------------------------------------------------------------------
# write_rows_2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,X", [(8, 2304), (64, 2304), (8, 576), (64, 576), (48, 36)])
def test_write_rows_2d_plain_matches_pallas(n, X):
    S, N = 16, 256
    rng = np.random.RandomState(2)
    cache = rng.randn(N, X).astype(np.float32)
    rows = rng.randn(n, X).astype(np.float32)
    slots = np.full(n, -1, np.int32)
    if n < 2 * S:  # decode: distinct pages per token, two rows skipped
        pages = rng.choice(N // S, size=n, replace=False)
        for t in range(n - 2):
            slots[t] = pages[t] * S + rng.randint(S)
    else:  # prefill: page runs with a partial tail page
        pages = rng.choice(N // S, size=n // S, replace=False)
        for i in range(n - 5):
            slots[i] = pages[i // S] * S + i % S
    want = JW.write_rows_2d(jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(slots), S,
                            interpret=True)
    got = TW.write_rows_2d(T(cache.copy()), T(rows), T(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the cache's own shape, a leading unit dimension, writes the same rows in place
    pool3 = T(cache.copy())[None]
    assert TW.write_rows_2d_plain(pool3, T(rows), T(slots)) is pool3
    np.testing.assert_array_equal(pool3[0].numpy(), np.asarray(want))


def test_write_rows_2d_casts_rows_and_skips_out_of_pool_slots():
    pool = torch.zeros(8, 4, dtype=torch.bfloat16)
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 0.001
    TW.write_rows_2d(pool, rows, torch.tensor([5, -1, 99], dtype=torch.int32))
    assert torch.equal(pool[5], rows[0].to(torch.bfloat16))
    assert pool.float().abs().sum() == pool[5].float().abs().sum()
    with pytest.raises(ValueError):
        TW.write_rows_2d_plain(torch.zeros(2, 8, 4), rows, torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------------------
# expert stacks: packing, layout
# ---------------------------------------------------------------------------

def _stack(E, K, N, gs=128, seed=0, pad_groups=0):
    rng = np.random.RandomState(seed)
    nib = rng.randint(0, 16, size=(E, K, N)).astype(np.int8)
    G = K // gs
    scales = ((rng.rand(E, G, N).astype(np.float32) + 0.5) * 0.02).astype(np.float32)
    zeros = rng.randint(0, 16, size=(E, G, N)).astype(np.float32)
    if pad_groups:  # the loader's zero-scale pad groups at the end of K
        scales[:, -pad_groups:] = 0
    return nib, scales, zeros


def test_expert_int4_pack_unpack_dequant_match_jax():
    nib, scales, zeros = _stack(3, 256, 128)
    packed = TQ.pack_expert_int4(T(nib))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JR.pack_expert_int4(jnp.asarray(nib))))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 128, 128)
    assert torch.equal(TQ.unpack_expert_int4(packed), T(nib))
    got = TQ.dequant_expert_int4(packed, T(scales), T(zeros), torch.float32)
    for e in range(3):
        want = j_dequant_int4(jnp.asarray(nib[e]), jnp.asarray(scales[e]), jnp.asarray(zeros[e]),
                              jnp.float32)
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(want))


@pytest.mark.parametrize("E,tm,occ,R", [(4, 8, 0, 6), (5, 8, 0, 37), (5, 64, 0, 37), (64, 8, 0, 8),
                                        (9, 8, 8, 40), (65, 64, 64, 700)])
def test_ragged_layout_equals_jax(E, tm, occ, R):
    rng = np.random.RandomState(R)
    flat = rng.randint(0, E, size=R).astype(np.int32)
    flat[flat == 1] = 0  # an expert without rows
    want = JR.ragged_layout(jnp.asarray(flat), E, tm, occ_experts=occ)
    got = TQ.ragged_layout(T(flat), E, tm, occ_experts=occ)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4] == want[4]
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32 and got[3].shape == (1,)


# ---------------------------------------------------------------------------
# w4a16_ragged_matmul
# ---------------------------------------------------------------------------

def _ragged_case(E, K, N, R, tm, seed, pad_groups=0):
    nib, scales, zeros = _stack(E, K, N, seed=seed, pad_groups=pad_groups)
    rng = np.random.RandomState(seed + 1)
    flat = rng.randint(0, E, size=R).astype(np.int32)
    x = rng.randn(R, K).astype(np.float32)
    if pad_groups:
        x[:, K - 128 * pad_groups :] = 0  # the activation columns the caller pads
    sort_idx, dest, tile_expert, num_occ, mp = TQ.ragged_layout(T(flat), E, tm)
    xp = torch.zeros(mp, K)
    xp[dest] = T(x)[sort_idx]
    return nib, scales, zeros, flat, x, sort_idx, dest, tile_expert, num_occ, xp


@pytest.mark.parametrize("E,K,N,R,tm,pad", [
    (5, 256, 256, 37, 8, 0), (5, 256, 256, 37, 64, 0),
    (64, 256, 256, 8, 8, 0),     # many experts, few rows: most tiles are padding
    (4, 512, 128, 20, 8, 1),     # a K the loader padded with a zero-scale group
])
def test_ragged_matmul_plain_matches_pallas_and_dequant(E, K, N, R, tm, pad):
    nib, scales, zeros, flat, x, sort_idx, dest, tile_expert, num_occ, xp = _ragged_case(
        E, K, N, R, tm, seed=E + tm, pad_groups=pad)
    w_p = TQ.pack_expert_int4(T(nib))
    got_all = TR.w4a16_ragged_matmul(xp, w_p, T(scales), T(zeros), tile_expert, num_occ)
    assert got_all.shape == (xp.shape[0], N) and got_all.dtype == torch.float32
    got = got_all[dest].numpy()

    # the Pallas kernel (interpret mode) on the same padded rows, cast to bf16
    out = JR.w4a16_ragged_matmul(
        jnp.asarray(xp.numpy(), jnp.bfloat16), jnp.asarray(w_p.numpy()), jnp.asarray(scales),
        jnp.asarray(zeros), jnp.asarray(tile_expert.numpy()), jnp.asarray(num_occ.numpy()),
        interpret=True)
    kern = np.asarray(out, np.float32)[dest.numpy()]
    assert np.abs(got - kern).max() <= 1e-2 * np.abs(got).max()

    # per-row dequantize-and-dot, fp32
    for i, r in enumerate(sort_idx.numpy()):
        e = flat[r]
        w = np.asarray(j_dequant_int4(jnp.asarray(nib[e]), jnp.asarray(scales[e]),
                                      jnp.asarray(zeros[e]), jnp.float32))
        np.testing.assert_allclose(got[i], x[r] @ w, rtol=1e-4, atol=1e-4 * np.abs(got).max())
    # tiles past the occupied prefix come out as zeros
    n_occ = int(num_occ[0])
    assert not got_all[n_occ * tm :].any()
    if E == 64:
        assert xp.shape[0] // tm > n_occ and int(dest.max()) < n_occ * tm


@pytest.mark.parametrize("case", ["decode", "every_expert", "num_occ_0"])
def test_ragged_matmul_plain_matches_pallas_at_the_decode_layout(case):
    """DeepSeek-V2-Lite's decode layout: 8 tokens' top 6 of 63 experts (48
    rows, TM 8, 64 experts and the overflow bucket: 63 m-tiles), every one of
    the 64 experts occupied (128 rows), and no occupied m-tile (num_occ 0:
    the plain version gives zeros, the kernels write nothing)."""
    E, K, N, TM = 64, 256, 128, 8
    nib, scales, zeros = _stack(E, K, N, seed=5)
    rng = np.random.RandomState(6)
    if case == "every_expert":
        flat = np.concatenate([rng.permutation(E), rng.permutation(E)])
    else:
        flat = np.concatenate([rng.permutation(E - 1)[:6] for _ in range(8)])
    flat = flat.astype(np.int32)
    _, dest, tile_expert, num_occ, mp = TQ.ragged_layout(T(flat), E + 1, TM, occ_experts=E)
    xp = torch.zeros(mp, K)
    xp[dest] = T(rng.randn(len(flat), K).astype(np.float32))
    if case == "decode":
        assert mp // TM == 63
    if case == "num_occ_0":
        num_occ = torch.zeros_like(num_occ)
    w_p = TQ.pack_expert_int4(T(nib))
    got = TR.w4a16_ragged_matmul(xp, w_p, T(scales), T(zeros), tile_expert, num_occ)
    out = JR.w4a16_ragged_matmul(
        jnp.asarray(xp.numpy(), jnp.bfloat16), jnp.asarray(w_p.numpy()), jnp.asarray(scales),
        jnp.asarray(zeros), jnp.asarray(tile_expert.numpy()), jnp.asarray(num_occ.numpy()),
        interpret=True)
    if case == "num_occ_0":
        assert got.shape == (mp, N) and not got.any()
        return
    assert int(num_occ[0]) * TM >= int(dest.max()) + 1
    kern = np.asarray(out, np.float32)[dest.numpy()]
    got = got[dest].numpy()
    assert np.abs(got - kern).max() <= 1e-2 * np.abs(got).max()


def test_ragged_matmul_pad_group_contributes_exact_zeros():
    """Rows of a zero-scale pad group dequantize to exact zeros whatever the
    nibbles: garbage activations there change nothing."""
    nib, scales, zeros, flat, x, sort_idx, dest, tile_expert, num_occ, xp = _ragged_case(
        4, 512, 128, 20, 8, seed=9, pad_groups=1)
    w_p = TQ.pack_expert_int4(T(nib))
    base = TR.w4a16_ragged_matmul_plain(xp, w_p, T(scales), T(zeros), tile_expert, num_occ)
    noisy = xp.clone()
    noisy[:, -128:] = 1e3
    assert torch.equal(
        TR.w4a16_ragged_matmul_plain(noisy, w_p, T(scales), T(zeros), tile_expert, num_occ), base)


def test_ragged_matmul_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(NotImplementedError):
        TR.w4a16_ragged_matmul(
            torch.empty(16, 256, **meta), torch.empty(2, 128, 128, dtype=torch.uint8, **meta),
            torch.empty(2, 2, 128, **meta), torch.empty(2, 2, 128, **meta),
            torch.empty(2, dtype=torch.int32, **meta), torch.empty(1, dtype=torch.int32, **meta))
    with pytest.raises(NotImplementedError):
        TW.write_rows_2d(torch.empty(8, 4, **meta), torch.empty(2, 4, **meta),
                         torch.empty(2, dtype=torch.int32, **meta))
