"""The attention prologues of the port's pools against the JAX composition
they replace, on the CPU.

``kvcache.paged.rope_write_kv`` (packed head-major pool or slot-major K and V
pools, bf16 or int8) and ``kvcache.paged.rope_write_latent`` (MLA latent pool)
rotate q and k and write the rows in one CUDA kernel on the GPU
(``csrc/kv_write.cu``, ``csrc/kv_write_pair.cu``, ``csrc/kv_write_2d.cu``); on
the CPU they run their plain versions, which are held here against
``zhilight_tpu.ops.rope.apply_rope_rot`` followed by
``zhilight_tpu.kvcache.paged.write_kv`` / ``write_latent`` (XLA's scatter: the
JAX package writes through Pallas only on a TPU). Inputs are bf16 rows made
with numpy from a seed and one fp32 cos/sin table handed to both sides.
Tolerance: the pools and the int8 scales bit-equal (the scales in the JAX
layout ``[N, Hkv]``, the latent rows' first ``latent_dim`` columns), q within
the rope tests' 1e-4. 2-layer fp32 models over a packed pool (head_dim 64)
and over slot-major pools (head_dim 80, fp32 and int8) take the prologue and
give the JAX model's logits within 1e-4, as the model tests (int8 pools: 1e-2
of the largest logit, as the int8 model tests).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.kvcache import paged as JP
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.ops import rope as JR
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import RopeConfig as TRopeConfig
from zhilight_tpu_torch.kvcache import paged as TP
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.ops import rope as TR
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
INT8_TOL = 1e-2  # logits over int8 pools, of the largest
S = 16
T_ = torch.from_numpy


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_pair(x: np.ndarray):
    """The same bf16 values on both sides (both round to nearest even)."""
    return jnp.asarray(x).astype(jnp.bfloat16), T_(x).bfloat16()


def _tables(rng, T: int, D: int, neox: bool):
    """fp32 cos/sin [T, D] laid out for the style, from the port's table."""
    table = TR.build_rope_table(D, 10000.0, TRopeConfig(neox_style=neox), 4096, 4096)
    cos, sin = table.rot_values(T_(rng.integers(0, 4000, T).astype(np.int32)))
    return (jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())), (cos, sin)


def _slots(rng, T: int, N: int) -> np.ndarray:
    """T distinct pool slots; past one token, one skipped (-1) and one past the pool."""
    slots = rng.permutation(N)[:T].astype(np.int32)
    if T > 1:
        slots[T // 3] = -1
        slots[T - 1] = N + 5
    return slots


def _qkv(rng, T, Hq, Hkv, D, fused_qkv: bool):
    """q, k, v [T, H, D] as numpy and as torch bf16: contiguous, or strided
    views of one fused qkv projection's output [T, (Hq + 2 Hkv) D]."""
    x = rng.standard_normal((T, (Hq + 2 * Hkv) * D)).astype(np.float32)
    parts = np.split(x, [Hq * D, (Hq + Hkv) * D], axis=-1)
    parts = [p.reshape(T, -1, D) for p in parts]
    if fused_qkv:
        qkv = T_(x).bfloat16()
        tq, tk, tv = (p.reshape(T, -1, D) for p in
                      torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1))
        assert not tk.is_contiguous()
    else:
        tq, tk, tv = (T_(np.ascontiguousarray(p)).bfloat16() for p in parts)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(p)).astype(jnp.bfloat16) for p in parts)
    return (jq, jk, jv), (tq, tk, tv)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T,fused_qkv", [(1, False), (8, True), (33, True), (33, False)])
def test_packed_prologue_matches_jax(T, fused_qkv, neox, D, int8):
    rng = np.random.default_rng(T * 1000 + D + 7 * int8 + 3 * neox)
    Hq, Hkv, pages = 4, 2, 4
    N = pages * S
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, T, Hq, Hkv, D, fused_qkv)
    (jcos, jsin), (tcos, tsin) = _tables(rng, T, D, neox)
    slots = _slots(rng, T, N)

    jc = JP.new_kv_cache(1, pages, S, Hkv, D, jnp.bfloat16, quantized=int8)
    assert jc.packed
    jq_rot = JR.apply_rope_rot(jq, jcos, jsin, neox)
    jc = JP.write_kv(jc, 0, JR.apply_rope_rot(jk, jcos, jsin, neox), jv, jnp.asarray(slots))

    tc = TP.new_kv_cache(1, pages, S, Hkv, D, torch.bfloat16, quantized=int8, device="cpu")
    tq_rot = TP.rope_write_kv(tc, 0, tq, tk, tv, tcos, tsin, neox, T_(slots))

    assert tq_rot.shape == (T, Hq, D) and tq_rot.dtype == torch.bfloat16
    np.testing.assert_allclose(tq_rot.float().numpy(), _f32(jq_rot), rtol=RTOL, atol=ATOL)
    if int8:
        np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
        for got, want in ((tc.k_scale[0], jc.k_scale[0]), (tc.v_scale[0], jc.v_scale[0])):
            np.testing.assert_array_equal(got[:, :N].numpy().T, np.asarray(want))
    else:
        np.testing.assert_array_equal(tc.k[0].float().numpy(), _f32(jc.k[0]))
    # the skipped rows (slot -1, slot past the pool) wrote nothing
    assert int((tc.k[0] != 0).any(-1).any(0).sum()) == len(set(slots[(slots >= 0) & (slots < N)]))


@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T", [1, 8, 33])
def test_latent_prologue_matches_jax(T, neox):
    """DeepSeek-V2-Lite's latent row (kv_lora_rank 512 + rope 64), 16 heads:
    q_pe a view of the q projection [T, H, 128 + 64], k_pe the tail of the
    kv_a projection [T, 512 + 64], as the model hands them over."""
    rng = np.random.default_rng(T + 50 * neox)
    H, nope, R, L, pages = 16, 128, 64, 512, 4
    N = pages * S
    q = rng.standard_normal((T, H, nope + R)).astype(np.float32)
    kv_a = rng.standard_normal((T, L + R)).astype(np.float32)
    (jcos, jsin), (tcos, tsin) = _tables(rng, T, R, neox)
    slots = _slots(rng, T, N)

    jq, tq = _bf16_pair(q)
    ja, ta = _bf16_pair(kv_a)
    jq_rot = JR.apply_rope_rot(jq[..., nope:], jcos, jsin, neox)
    jk_rot = JR.apply_rope_rot(ja[:, None, L:], jcos, jsin, neox)[:, 0]
    jc = JP.new_latent_cache(1, pages, S, L + R, jnp.bfloat16)
    jc = JP.write_latent(jc, 0, jnp.concatenate([ja[:, :L], jk_rot], axis=-1), jnp.asarray(slots))

    tc = TP.new_latent_cache(1, pages, S, L + R, torch.bfloat16, device="cpu")
    tq_rot = TP.rope_write_latent(tc, 0, tq[..., nope:], ta[:, :L], ta[:, L:], tcos, tsin, neox,
                                  T_(slots))

    assert tq_rot.shape == (T, H, R)
    np.testing.assert_allclose(tq_rot.float().numpy(), _f32(jq_rot), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tc.latent[0][0].float().numpy(), _f32(jc.latent[0])[:, : L + R])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [16, 80, 100, 128])
@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("T,fused_qkv", [(1, False), (8, True), (33, True), (33, False)])
def test_slot_major_prologue_matches_jax(T, fused_qkv, neox, D, int8, monkeypatch):
    """The slot-major pools' prologue (separate K and V pools [1, N, Hkv, D];
    head_dim 128 only under ZT_NO_PACKED_KV=1) against JAX's rope and
    ``write_kv`` over the same layout."""
    if D == 128:
        monkeypatch.setenv("ZT_NO_PACKED_KV", "1")
    rng = np.random.default_rng(T * 1000 + D + 7 * int8 + 3 * neox + 11)
    Hq, Hkv, pages = 4, 2, 4
    N = pages * S
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, T, Hq, Hkv, D, fused_qkv)
    (jcos, jsin), (tcos, tsin) = _tables(rng, T, D, neox)
    slots = _slots(rng, T, N)

    jc = JP.new_kv_cache(1, pages, S, Hkv, D, jnp.bfloat16, quantized=int8)
    assert not jc.packed
    jq_rot = JR.apply_rope_rot(jq, jcos, jsin, neox)
    jc = JP.write_kv(jc, 0, JR.apply_rope_rot(jk, jcos, jsin, neox), jv, jnp.asarray(slots))

    tc = TP.new_kv_cache(1, pages, S, Hkv, D, torch.bfloat16, quantized=int8, device="cpu")
    assert not tc.packed
    tq_rot = TP.rope_write_kv(tc, 0, tq, tk, tv, tcos, tsin, neox, T_(slots))

    assert tq_rot.shape == (T, Hq, D) and tq_rot.dtype == torch.bfloat16
    np.testing.assert_allclose(tq_rot.float().numpy(), _f32(jq_rot), rtol=RTOL, atol=ATOL)
    for got, want in ((tc.k[0][0], jc.k[0]), (tc.v[0][0], jc.v[0])):
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    if int8:
        for got, want in ((tc.k_scale[0], jc.k_scale[0]), (tc.v_scale[0], jc.v_scale[0])):
            np.testing.assert_array_equal(got[:, :N].numpy().T, np.asarray(want))
    # the skipped rows (slot -1, slot past the pool) wrote nothing
    kept = len(set(slots[(slots >= 0) & (slots < N)]))
    for pool in (tc.k[0][0], tc.v[0][0]):
        assert int((pool != 0).flatten(1).any(1).sum()) == kept


def _two_layer_run(monkeypatch, D: int, quantized: bool, spied):
    """A 2-layer fp32 model (4 / 2 heads of ``D``) on both sides: an 11-token
    prefill chunk, then a decode step of the sequence and an inactive slot.
    Counts the port's calls of each ``kv_write`` function named in ``spied``.
    Returns the JAX and the port's (prefill, decode) logits, both caches and
    the counts."""
    kw = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=D,
              num_kv_heads=2, dim_ff=128, vocab_size=101, dtype="float32")
    jcfg, tcfg = JModelConfig(**kw), TModelConfig(**kw)
    jp = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = params_to_torch(jax.device_get(jp), "cpu")
    jrope, trope = JL.build_rope(jcfg), TL.build_rope(tcfg)
    pages, maxp, n = 8, 4, 11
    jc = JP.new_kv_cache(2, pages, S, 2, D, jnp.float32, quantized=quantized)
    tc = TP.new_kv_cache(2, pages, S, 2, D, torch.float32, quantized=quantized, device="cpu")

    calls = {name: 0 for name in spied}
    for name in spied:
        fn = getattr(W, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(TP.kv_write, name, counted)

    rng = np.random.default_rng(0)
    table = np.full(maxp, -1, np.int32)
    table[:2] = [5, 2]
    toks = rng.integers(2, 101, 16).astype(np.int32)
    pos = np.where(np.arange(16) < n, np.arange(16), 0).astype(np.int32)
    slots = np.where(np.arange(16) < n, table[pos // S] * S + pos % S, -1).astype(np.int32)
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    jm = JPrefillMeta(i32(pos), i32(slots), i32(table), i32(0), i32(n))
    tm = TPrefillMeta(T_(pos), T_(slots), T_(table), torch.tensor(0, dtype=torch.int32),
                      torch.tensor(n, dtype=torch.int32))
    jl, jc = JL.forward_prefill(jp, jcfg, jrope, i32(toks), jm, jc)
    tl, tc = TL.forward_prefill(tp, tcfg, trope, T_(toks), tm, tc)
    prefill = dict(calls)

    tables = np.stack([table, np.full(maxp, -1, np.int32)])
    dpos = np.array([n, 0], np.int32)
    dslots = np.array([table[n // S] * S + n % S, -1], np.int32)
    dctx = np.array([n + 1, 0], np.int32)
    dtok = np.array([int(np.asarray(jl).argmax()), 0], np.int32)
    jd = JDecodeMeta(i32(dpos), i32(dslots), i32(tables), i32(dctx))
    td = TDecodeMeta(T_(dpos), T_(dslots), T_(tables), T_(dctx))
    jd_l, jc = JL.forward_decode(jp, jcfg, jrope, i32(dtok), jd, jc)
    td_l, tc = TL.forward_decode(tp, tcfg, trope, T_(dtok), td, tc)
    return ((np.asarray(jl), np.asarray(jd_l)[0]), (tl.numpy(), td_l[0].numpy()), jc, tc,
            prefill, calls)


def test_model_takes_the_packed_prologue(monkeypatch):
    """A 2-layer fp32 model (head_dim 64, GQA) over a packed pool: a prefill
    chunk and a decode step go through rope_write_kv, one call a layer, and
    give the JAX model's logits and pool."""
    want, got, jc, tc, prefill, calls = _two_layer_run(monkeypatch, 64, False,
                                                       ("rope_write_rows_hm",))
    assert tc.packed
    assert prefill["rope_write_rows_hm"] == 2 and calls["rope_write_rows_hm"] == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for layer in range(2):
        np.testing.assert_allclose(tc.k[layer].numpy(), np.asarray(jc.k[layer]), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_model_takes_the_slot_major_prologue(monkeypatch, quantized):
    """A 2-layer fp32 model at head_dim 80 over slot-major pools, model-dtype
    or int8: the prefill chunk and the decode step write through
    rope_write_rows_pair, one call a layer, never through the copy wrapper,
    and give the JAX model's logits (int8: within 1e-2 of the largest, as the
    JAX CPU path rounds dequantized rows to bf16) and, over the model-dtype
    pools, its pools."""
    spied = ("rope_write_rows_pair", "write_rows_pair")
    want, got, jc, tc, prefill, calls = _two_layer_run(monkeypatch, 80, quantized, spied)
    assert not tc.packed and tc.quantized == quantized
    assert prefill == {"rope_write_rows_pair": 2, "write_rows_pair": 0}
    assert calls == {"rope_write_rows_pair": 4, "write_rows_pair": 0}
    for g, w in zip(got, want):
        if quantized:
            assert np.abs(g - w).max() < INT8_TOL * np.abs(w).max()
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if quantized:  # layer 0 sees the same inputs on both sides: the same int8 rows
        np.testing.assert_array_equal(tc.k[0][0].numpy(), np.asarray(jc.k[0]))
        np.testing.assert_array_equal(tc.v[0][0].numpy(), np.asarray(jc.v[0]))
    else:
        for layer in range(2):
            for t_pool, j_pool in ((tc.k[layer], jc.k[layer]), (tc.v[layer], jc.v[layer])):
                np.testing.assert_allclose(t_pool[0].numpy(), np.asarray(j_pool), rtol=RTOL,
                                           atol=ATOL)
