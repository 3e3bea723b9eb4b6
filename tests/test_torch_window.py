"""Decode windows with side-buffered KV writes (``ZT_WINDOW_KV=1``): the
port against the JAX package on the CPU, in fp32, from the same inputs.

The JAX side runs its Pallas kernels in interpret mode (``ZT_PALLAS_INTERPRET=1``
through ``monkeypatch``), and its engine additionally with ``ZT_WINDOW_KV=1``,
so that its decode windows really take the side-buffer path (the engine-level
tests of tests/test_window_side_kv.py set only the first, which no longer
reaches that path). Every engine case here checks on both sides that the
window path ran.

- **Partials**: the plain partial modes of the three decode kernels (packed
  bf16-layout and int8 pools, the MLA latent pool) against the Pallas
  ``emit_partial=True`` outputs: m where l > 0, l and acc within 1e-4 (sums in
  another order); an empty pool gives m = -2e38, l = 0, acc = 0.
- **Flushes**: the plain ``flush_side_rows_hm`` / ``flush_side_rows_2d`` and
  ``_side_page_runs`` against the Pallas kernels, bit-exact: fp32 and int8
  rows, windows that start mid-page, on a page boundary or on a page's last
  row, that cross a page, with 0, some or all rows live.
- **Model**: tests/test_window_side_kv.py's window (contexts 13, 16, 31, 3;
  slot 2 freezes after 2 steps) through ``forward_decode_window``: logits
  within 1e-4 of JAX's at every step, side rows within 1e-4, and the port's
  flush of JAX's side rows bit-equal to JAX's flushed pools; the port's
  window against its own per-step decode within 2e-4 (as the reference test
  holds its window to its per-step path). Over an int8 pool the logits agree
  within 1e-2 of the largest (the tolerance of the other int8 tests), codes
  and scales after the flush bit-equal; over the MLA latent pool, the latent
  columns.
- **Engine**: greedy tokens of the port's ``LLM`` with ``ZT_WINDOW_KV=1``
  equal the JAX ``LLM``'s, for the four models of
  tests/test_window_side_kv.py (dense, int8 pool, MLA, MoE); and where the
  side path must not run (1-step windows, windows longer than a page, a
  sliding window, a slot-major pool) the port decodes per step and still
  returns JAX's tokens.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import MLAConfig as JMLAConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config
from zhilight_tpu.config.model_config import MoEConfig as JMoEConfig
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import paged as JP
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.ops.pallas import kv_write as JW
from zhilight_tpu.ops.pallas.attn_headmajor import paged_decode_attention_hm as j_decode
from zhilight_tpu.ops.pallas.attn_headmajor import paged_decode_attention_hm_q as j_decode_q
from zhilight_tpu.ops.pallas.paged_attention import paged_mla_decode as j_mla_decode
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, MLAConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt_hf_config
from zhilight_tpu_torch.config.model_config import MoEConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.kvcache import paged as TP
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
INT8_TOL = 1e-2
S = 16
T = torch.from_numpy


def _i8(x):
    """Per-(row) absmax int8 codes and fp32 scales, as the caches quantize."""
    scale = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    return np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8), scale


def _j_partial(out, D):
    """The Pallas partials [..., 2D] (lane 0 m, lane 1 l, [D:] acc) apart."""
    out = np.asarray(out)
    return out[..., 0], out[..., 1], out[..., D:]


def _assert_partials(got, want):
    m, l, acc = (t.numpy() for t in got)
    wm, wl, wacc = want
    live = wl > 0
    np.testing.assert_allclose(m[live], wm[live], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l, wl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(acc, wacc, rtol=RTOL, atol=ATOL)
    assert np.all(m[~live] == np.float32(-2e38)) and not acc[~live].any()


# ---------------------------------------------------------------------------
# kernels: partial modes and flushes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("empty", [False, True])
@pytest.mark.parametrize("kind", ["bf16_layout", "int8", "mla"])
def test_partial_modes_match_pallas(kind, empty):
    """tests/test_partitioned_kernels.py's window inputs (B 4, 16 / 8 heads of
    64, pool lengths from 1) for the packed pools, the latent decode's for MLA;
    ``empty`` makes one pool length 0."""
    rng = np.random.RandomState(1)
    B, Hq, Hkv, D, pages, maxp, Kw = 4, 16, 8, 64, 16, 4, 6
    q = rng.randn(B, Hq, D).astype(np.float32)
    pool_lens = rng.randint(1, maxp * S - Kw, size=B).astype(np.int32)
    if empty:
        pool_lens[2] = 0
    tables = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    scale = 1.0 / np.sqrt(D)
    if kind == "bf16_layout":
        pool = rng.randn(Hkv, pages * S, 2 * D).astype(np.float32)
        want = _j_partial(j_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(tables),
                                   jnp.asarray(pool_lens), S, scale, 0, interpret=True,
                                   emit_partial=True), D)
        got = A.paged_decode_attention_hm(T(q), T(pool), T(tables), T(pool_lens), S, scale,
                                          emit_partial=True)
        assert got[0].shape == (B, Hkv, Hq // Hkv) and got[2].shape == (B, Hkv, Hq // Hkv, D)
    elif kind == "int8":
        k_q, k_s = _i8(rng.randn(pages * S, Hkv, D).astype(np.float32))
        v_q, v_s = _i8(rng.randn(pages * S, Hkv, D).astype(np.float32))
        pool = np.concatenate([k_q, v_q], -1).transpose(1, 0, 2).copy()  # [Hkv, N, 2D]
        want = _j_partial(j_decode_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s),
                                     jnp.asarray(v_s), jnp.asarray(tables), jnp.asarray(pool_lens),
                                     S, scale, 0, interpret=True, emit_partial=True), D)
        spare = np.zeros((Hkv, 1), np.float32)  # the port's scales [Hkv, N + 1]
        ks, vs = (T(np.concatenate([s.T, spare], 1)) for s in (k_s, v_s))
        got = A.paged_decode_attention_hm_q(T(q), T(pool), ks, vs, T(tables), T(pool_lens), S,
                                            scale, emit_partial=True)
    else:
        H, lora, latent = 16, 128, 192
        q_eff = rng.randn(B, H, latent).astype(np.float32)
        pool = rng.randn(pages * S, latent).astype(np.float32)
        out = np.asarray(j_mla_decode(jnp.asarray(q_eff), jnp.asarray(pool), jnp.asarray(tables),
                                      jnp.asarray(pool_lens), S, 0.11, v_dim=lora,
                                      interpret=True, emit_partial=True))
        want = out[..., 0], out[..., 1], out[..., 128:]
        got = A.paged_mla_decode(T(q_eff), T(pool), T(tables), T(pool_lens), S, 0.11,
                                 v_dim=lora, emit_partial=True)
        assert got[0].shape == (B, H) and got[2].shape == (B, H, lora)
        # the head-major entry point's latent mode gives the same partials
        hm = A.paged_decode_attention_hm(T(q_eff), T(pool)[None], T(tables), T(pool_lens), S,
                                         0.11, emit_partial=True, v_dim=lora)
        assert all(torch.equal(a, b) for a, b in zip(hm, got))
    _assert_partials(got, want)


@pytest.mark.parametrize("ctx", [1, 16, 64, 65])
def test_latent_partial_mode_at_tile_edges_matches_pallas(ctx):
    """The latent decode's partial mode (row 2bp) at a pool length of 1, a
    whole page, a whole 64-token tile and one token past, beside two other
    lengths; 16 heads, latent rows of 128 + 64."""
    rng = np.random.RandomState(ctx)
    B, H, lora, latent, maxp = 3, 16, 128, 192, 6
    pool_lens = np.array([ctx, 7, 70], np.int32)
    tables = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    q_eff = rng.randn(B, H, latent).astype(np.float32)
    pool = rng.randn(B * maxp * S, latent).astype(np.float32)
    out = np.asarray(j_mla_decode(jnp.asarray(q_eff), jnp.asarray(pool), jnp.asarray(tables),
                                  jnp.asarray(pool_lens), S, 0.11, v_dim=lora, interpret=True,
                                  emit_partial=True))
    got = A.paged_mla_decode_partial(T(q_eff), T(pool), T(tables), T(pool_lens), S, 0.11, lora)
    _assert_partials(got, (out[..., 0], out[..., 1], out[..., 128:]))


@pytest.mark.parametrize("D,Hq,Hkv", [(256, 16, 8), (192, 8, 2)])
def test_int8_partial_mode_wide_heads_matches_pallas(D, Hq, Hkv):
    """The int8 partial mode at head_dim 256 (Gemma-2-9B's 16 / 8 heads) and
    192, which the int8 CUDA decode kernel takes since its redesign, against
    the Pallas partial mode; one empty pool."""
    rng = np.random.RandomState(D)
    B, pages, maxp, Kw = 4, 16, 4, 6
    q = rng.randn(B, Hq, D).astype(np.float32)
    pool_lens = rng.randint(1, maxp * S - Kw, size=B).astype(np.int32)
    pool_lens[1] = 0
    tables = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    scale = 1.0 / np.sqrt(D)
    k_q, k_s = _i8(rng.randn(pages * S, Hkv, D).astype(np.float32))
    v_q, v_s = _i8(rng.randn(pages * S, Hkv, D).astype(np.float32))
    pool = np.concatenate([k_q, v_q], -1).transpose(1, 0, 2).copy()  # [Hkv, N, 2D]
    want = _j_partial(j_decode_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s),
                                 jnp.asarray(v_s), jnp.asarray(tables), jnp.asarray(pool_lens),
                                 S, scale, 0, interpret=True, emit_partial=True), D)
    spare = np.zeros((Hkv, 1), np.float32)  # the port's scales [Hkv, N + 1]
    ks, vs = (T(np.concatenate([s.T, spare], 1)) for s in (k_s, v_s))
    got = A.paged_decode_attention_hm_q(T(q), T(pool), ks, vs, T(tables), T(pool_lens), S,
                                        scale, emit_partial=True)
    assert got[0].shape == (B, Hkv, Hq // Hkv) and got[2].shape == (B, Hkv, Hq // Hkv, D)
    _assert_partials(got, want)


# windows of B 8: entries mid-page, on a page boundary, on a page's last row;
# n_rows 0, partial and full (Kw 8), runs that cross into the next page
ENTRY = np.array([13, 16, 15, 3, 40, 31, 0, 57], np.int32)
N_ROWS = np.array([8, 0, 4, 8, 1, 8, 5, 7], np.int32)


def _flush_inputs(rng, dtype, Hkv=None):
    B, Kw, maxp, X = len(ENTRY), 8, 5, 2 * 64
    tables = rng.permutation(B * maxp + 3)[: B * maxp].astype(np.int32).reshape(B, maxp)
    tables[1, 3:] = -1  # padding pages
    N = (B * maxp + 3) * S
    lead = () if Hkv is None else (Hkv,)
    side_lead = (B,) if Hkv is None else (B, Hkv)
    if dtype == np.int8:
        pool = rng.randint(-127, 128, lead + (N, X)).astype(np.int8)
        side = rng.randint(-127, 128, side_lead + (Kw, X)).astype(np.int8)
    else:
        pool = rng.randn(*lead, N, X).astype(dtype)
        side = rng.randn(*side_lead, Kw, X).astype(dtype)
    return pool, side, tables


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
@pytest.mark.parametrize("layout", ["hm", "2d"])
def test_flushes_match_pallas_bit_exact(layout, dtype):
    rng = np.random.RandomState(7)
    pool, side, tables = _flush_inputs(rng, dtype, Hkv=2 if layout == "hm" else None)
    j_fn, t_fn = ((JW.flush_side_rows_hm, W.flush_side_rows_hm) if layout == "hm"
                  else (JW.flush_side_rows_2d, W.flush_side_rows_2d))
    want = np.asarray(j_fn(jnp.asarray(pool), jnp.asarray(side), jnp.asarray(ENTRY),
                           jnp.asarray(N_ROWS), jnp.asarray(tables), S, interpret=True))
    got = t_fn(T(pool.copy()), T(side), T(ENTRY), T(N_ROWS), T(tables), S)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, pool)
    if layout == "2d":  # the cache's latent pools carry a leading unit dimension
        got3 = W.flush_side_rows_2d(T(pool.copy())[None], T(side), T(ENTRY), T(N_ROWS),
                                    T(tables), S)
        assert np.array_equal(got3[0].numpy(), want)


def test_side_page_runs_and_slots_match_jax():
    tables = np.random.RandomState(2).permutation(64)[:40].astype(np.int32).reshape(8, 5)
    tables[1, 3:] = -1
    want = JW._side_page_runs(jnp.asarray(ENTRY), jnp.asarray(N_ROWS), jnp.asarray(tables), S)
    got = W._side_page_runs(T(ENTRY), T(N_ROWS), T(tables), S)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    slots = W.side_slots(T(ENTRY), T(N_ROWS), T(tables), S, 8).numpy()
    for b in range(8):
        for j in range(8):
            pos = ENTRY[b] + j
            want_slot = max(tables[b, min(pos // S, 4)], 0) * S + pos % S
            assert slots[b, j] == (want_slot if j < N_ROWS[b] else -1)


def test_flush_rejects_float_rows_for_an_int8_pool():
    pool = torch.zeros(2, 64, 8, dtype=torch.int8)
    side = torch.zeros(1, 2, 2, 8)
    i32 = dict(dtype=torch.int32)
    with pytest.raises(ValueError, match="int8"):
        W.flush_side_rows_hm(pool, side, torch.zeros(1, **i32), torch.ones(1, **i32),
                             torch.zeros(1, 4, **i32), S)


# ---------------------------------------------------------------------------
# model: one window through forward_decode_window and the flush
# ---------------------------------------------------------------------------

B, KW, MAXP = 4, 6, 4
CTX0 = np.array([13, 16, 31, 3], np.int32)
LIMITS = np.array([64, 64, 31 + 2, 64], np.int32)  # slot 2 freezes after 2 steps
TABLES = np.arange(B * MAXP, dtype=np.int32).reshape(B, MAXP)
DENSE = dict(model_type="llama", num_layers=2, dim_model=128, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=128, dtype="float32")


def _dense_model():
    jcfg = JModelConfig(**DENSE)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return (jcfg, jparams, JL.build_rope(jcfg), ModelConfig(**DENSE),
            params_to_torch(jax.device_get(jparams), "cpu"), TL.build_rope(ModelConfig(**DENSE)))


def _mla_model():
    """tests/test_torch_mla.py's DeepSeek-V2-Lite-style model (MLA, then a
    MoE layer)."""
    from test_torch_mla import deepseek_v2_cfg

    hf = deepseek_v2_cfg()
    jcfg = j_adapt_hf_config(hf).replace(dtype="float32")
    tcfg = t_adapt_hf_config(hf).replace(dtype="float32")
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return (jcfg, jparams, JL.build_rope(jcfg), tcfg,
            params_to_torch(jax.device_get(jparams), "cpu"), TL.build_rope(tcfg))


def _caches(kind, jcfg, rng):
    """The same random pool (and scales) in both packages' layouts."""
    N, L = B * MAXP * S, jcfg.num_layers
    if kind == "mla":
        lat = [rng.randn(N, jcfg.mla.latent_dim).astype(np.float32) for _ in range(L)]
        pad = -jcfg.mla.latent_dim % 128  # the JAX package pads rows to 128 lanes
        jc = JP.KVCache(latent=tuple(jnp.asarray(np.pad(x, ((0, 0), (0, pad)))) for x in lat),
                        page_size=S)
        return jc, TP.KVCache(latent=[T(x.copy())[None] for x in lat], page_size=S)
    Hkv, D = jcfg.num_kv_heads, jcfg.dim_head
    rows = [rng.randn(2, N, Hkv, D).astype(np.float32) for _ in range(L)]
    if kind == "dense":
        pools = [np.concatenate([r[0], r[1]], -1).transpose(1, 0, 2).copy() for r in rows]
        return (JP.KVCache(k=tuple(map(jnp.asarray, pools)), page_size=S, packed=True),
                TP.KVCache(k=[T(p.copy()) for p in pools], page_size=S, packed=True))
    quant = [(_i8(r[0]), _i8(r[1])) for r in rows]
    pools = [np.concatenate([kq, vq], -1).transpose(1, 0, 2).copy() for (kq, _), (vq, _) in quant]
    spare = np.zeros((Hkv, 1), np.float32)
    jc = JP.KVCache(k=tuple(map(jnp.asarray, pools)),
                    k_scale=tuple(jnp.asarray(ks) for (_, ks), _ in quant),
                    v_scale=tuple(jnp.asarray(vs) for _, (_, vs) in quant), page_size=S, packed=True)
    tc = TP.KVCache(k=[T(p.copy()) for p in pools],
                    k_scale=[T(np.concatenate([ks.T, spare], 1)) for (_, ks), _ in quant],
                    v_scale=[T(np.concatenate([vs.T, spare], 1)) for _, (_, vs) in quant],
                    page_size=S, packed=True)
    return jc, tc


def _copy(tcache):
    return TP.KVCache(**{f: ([a.clone() for a in getattr(tcache, f)]
                             if isinstance(getattr(tcache, f), list) else getattr(tcache, f))
                         for f in ("k", "v", "latent", "k_scale", "v_scale", "page_size", "packed")})


def _step_meta(pos, ctx, valid):
    slots = np.where(valid, TABLES[np.arange(B), pos // S] * S + pos % S, -1).astype(np.int32)
    arrays = (pos, slots, TABLES, np.where(valid, ctx + 1, ctx).astype(np.int32))
    return JDecodeMeta(*map(jnp.asarray, arrays)), TDecodeMeta(*(T(a.copy()) for a in arrays))


def _pool_arrays(cache, latent_dim=0):
    """Every array of a cache as numpy, in the JAX package's layout; a JAX
    latent pool cut to its first ``latent_dim`` columns."""
    if isinstance(cache, JP.KVCache):
        if cache.is_latent:
            return [np.asarray(a)[:, :latent_dim] for a in cache.latent]
        return [np.asarray(a) for a in cache.k + (cache.k_scale or ()) + (cache.v_scale or ())]
    if cache.is_latent:
        return [a[0].numpy() for a in cache.latent]
    N = cache.num_slots
    return ([a.numpy() for a in cache.k] + [a[:, :N].numpy().T for a in cache.k_scale or []]
            + [a[:, :N].numpy().T for a in cache.v_scale or []])


# the layered flush's window: slot 0 crosses from its first page into its
# second, slot 1 is dead (no live row), slot 2 has 2 live rows of 6, slot 3
# starts on a page boundary
FLUSH_ENTRY = np.array([13, 20, 30, 16], np.int32)
FLUSH_LIVE = np.array([6, 0, 2, 6], np.int32)


@pytest.mark.parametrize("kind", ["dense", "int8", "mla"])
def test_layered_plain_flush_matches_jax_flush_window_rows(kind, monkeypatch):
    """The port's layered plain flush (one call for every layer; over an int8
    pool it requantizes the fp32 side rows and scatters their scales) against
    JAX's flush_window_rows, which loops its per-layer flush_side_rows_hm /
    _2d (interpret mode) and its requantization over the layers: three
    layers, a dead slot, a window across a page, bit-equal pools and scales
    (the port's spare scale column untouched)."""
    monkeypatch.setenv("ZT_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(11)
    if kind == "mla":
        jcfg = _mla_model()[0].replace(num_layers=3)
        shape = (B, KW, jcfg.mla.latent_dim)
    else:
        jcfg = JModelConfig(**dict(DENSE, num_layers=3))
        shape = (B, jcfg.num_kv_heads, KW, 2 * jcfg.dim_head)
    jcache, tcache = _caches(kind, jcfg, rng)
    side = rng.randn(3, *shape).astype(np.float32)
    valid = np.arange(KW)[None, :] < FLUSH_LIVE[:, None]
    pad = -jcfg.mla.latent_dim % 128 if kind == "mla" else 0
    j_side = [jnp.asarray(np.pad(r, [(0, 0)] * (r.ndim - 1) + [(0, pad)])) for r in side]
    jcache = JL.flush_window_rows(jcfg, jcache, j_side, jnp.asarray(valid),
                                  jnp.asarray(FLUSH_ENTRY), jnp.asarray(TABLES))
    spare = [a[:, -1].clone() for a in tcache.k_scale or []]
    args = (T(FLUSH_ENTRY.copy()), T(FLUSH_LIVE.copy()), T(TABLES.copy()), S)
    if kind == "mla":
        pools = W.flush_side_layers_2d(tcache.latent, T(side.copy()), *args)
    else:
        pools = W.flush_side_layers_hm(tcache.k, T(side.copy()), *args, tcache.k_scale,
                                       tcache.v_scale)
    assert pools is (tcache.latent if kind == "mla" else tcache.k)
    latent_dim = jcfg.mla.latent_dim if kind == "mla" else 0
    for got, want in zip(_pool_arrays(tcache), _pool_arrays(jcache, latent_dim)):
        assert np.array_equal(got, want)
    for before, after in zip(spare, tcache.k_scale or []):
        assert torch.equal(before, after[:, -1])


@pytest.mark.parametrize("kind", ["dense", "int8", "mla"])
def test_window_matches_jax_and_the_per_step_path(kind, monkeypatch):
    monkeypatch.setenv("ZT_PALLAS_INTERPRET", "1")
    jcfg, jparams, jrope, tcfg, tparams, trope = _mla_model() if kind == "mla" else _dense_model()
    rng = np.random.RandomState(0)
    jcache, tcache = _caches(kind, jcfg, rng)
    step_cache = _copy(tcache)  # the port's per-step path
    tol = (lambda x: INT8_TOL * np.abs(x).max()) if kind == "int8" else (lambda x: RTOL)
    side_dtype = jnp.float32
    j_rows = JL.new_side_rows(jcfg, B, KW, side_dtype)
    t_rows = TL.new_side_rows(tcfg, B, KW, torch.float32)
    j_valid, t_valid = jnp.zeros((B, KW), bool), torch.zeros((B, KW), dtype=torch.bool)
    pos, ctx, tok = CTX0.copy(), CTX0.copy(), np.array([5, 7, 11, 13], np.int32)
    for k in range(KW):
        valid = ctx + 1 <= LIMITS
        jmeta, tmeta = _step_meta(pos, ctx, valid)
        j_valid = j_valid.at[:, k].set(jnp.asarray(valid))
        t_valid[:, k] = T(valid)
        jl, jcache, j_rows = JL.forward_decode_window(jparams, jcfg, jrope, jnp.asarray(tok), jmeta,
                                                      jcache, j_rows, j_valid, jnp.asarray(CTX0),
                                                      jnp.int32(k))
        with torch.no_grad():
            tl, tcache, t_rows = TL.forward_decode_window(tparams, tcfg, trope, T(tok.copy()), tmeta,
                                                          tcache, t_rows, t_valid, T(CTX0.copy()), k)
            sl, step_cache = TL.forward_decode(tparams, tcfg, trope, T(tok.copy()), tmeta, step_cache)
        jl, tl, sl = np.asarray(jl), tl.numpy(), sl.numpy()
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=RTOL, atol=tol(jl[valid]),
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(tl[valid], sl[valid], rtol=2 * RTOL, atol=2 * tol(sl[valid]),
                                   err_msg=f"step {k} vs the per-step path")
        tok = np.where(valid, jl.argmax(-1), tok).astype(np.int32)
        pos, ctx = np.where(valid, pos + 1, pos), np.where(valid, ctx + 1, ctx)
    for jr, tr in zip(j_rows, t_rows):
        width = tr.shape[-1]
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr)[..., :width], rtol=RTOL,
                                   atol=tol(np.asarray(jr)))

    entry, tables = jnp.asarray(CTX0), jnp.asarray(TABLES)
    jcache = JL.flush_window_rows(jcfg, jcache, j_rows, j_valid, entry, tables)
    # the port's flush of JAX's own side rows: bit-equal pools
    j_rows_t = [T(np.asarray(r)[..., : t.shape[-1]].copy()) for r, t in zip(j_rows, t_rows)]
    flushed = TL.flush_window_rows(tcfg, _copy(tcache), j_rows_t, t_valid, T(CTX0.copy()), T(TABLES))
    latent_dim = tcfg.mla.latent_dim if kind == "mla" else 0
    for got, want in zip(_pool_arrays(flushed), _pool_arrays(jcache, latent_dim)):
        assert np.array_equal(got, want)
    # the port's own window, flushed, against JAX's pools and its own per-step path
    tcache = TL.flush_window_rows(tcfg, tcache, t_rows, t_valid, T(CTX0.copy()), T(TABLES))
    for got, want, step in zip(_pool_arrays(tcache), _pool_arrays(jcache, latent_dim),
                               _pool_arrays(step_cache)):
        if got.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1
            assert np.abs(got.astype(np.int32) - step).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(got, step, rtol=2 * RTOL, atol=2 * RTOL)


# ---------------------------------------------------------------------------
# engine: greedy tokens with ZT_WINDOW_KV=1, and where the side path is off
# ---------------------------------------------------------------------------

TINY = dict(num_layers=2, dim_model=128, num_heads=4, dim_head=64, num_kv_heads=2, dim_ff=128,
            vocab_size=128, dtype="float32")
ENGINE_MODELS = {
    # tests/test_window_side_kv.py:191-394: model, cache, prompt lengths, max_length
    "dense": (dict(model_type="llama"), {}, (13, 5), 10),
    "int8": (dict(model_type="llama"), dict(kv_dtype="int8"), (11, 7), 8),
    "mla": (dict(model_type="deepseek_v2", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
                 num_kv_heads=4, dim_ff=64,
                 mla=dict(q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
                          qk_rope_head_dim=4, v_head_dim=8)), {}, (12, 6), 8),
    "moe": (dict(model_type="qwen2_moe",
                 moe=dict(num_experts=4, top_k=2, intermediate_size=64,
                          shared_expert_intermediate_size=64, shared_expert_gate=True,
                          norm_topk_prob=True)), {}, (10, 6), 8),
}
GATED = {
    # what keeps the side path off, as the reference's _use_side_window has it
    "one_step_windows": (dict(model_type="llama"), dict(decode_multi_step=1), {}),
    "window_longer_than_a_page": (dict(model_type="llama"), dict(decode_multi_step=8), dict(page_size=4)),
    "sliding_window": (dict(model_type="mistral", sliding_window=8), {}, {}),
    "slot_major_pool": (dict(model_type="llama", dim_head=16), {}, {}),
}


def _configs(model):
    model = dict(TINY, **model)
    mla, moe = model.pop("mla", None), model.pop("moe", None)
    jcfg = JModelConfig(**model, **({"mla": JMLAConfig(**mla)} if mla else {}),
                        **({"moe": JMoEConfig(**moe)} if moe else {}))
    tcfg = ModelConfig(**model, **({"mla": MLAConfig(**mla)} if mla else {}),
                       **({"moe": MoEConfig(**moe)} if moe else {}))
    return jcfg, tcfg


def _serve_both(monkeypatch, model, cache, sched, lens, max_length, seed):
    """Greedy tokens of the JAX engine (ZT_WINDOW_KV=1, interpret kernels) and
    of the port's (ZT_WINDOW_KV=1, CPU), with what each decode window ran."""
    jcfg, tcfg = _configs(model)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    cache = dict(dict(page_size=16, num_pages=16), **cache)
    sched = dict(dict(max_batch=2, chunk_size=16, prefill_buckets=(16,), eos_id=1,
                      decode_multi_step=4), **sched)
    prompts = [list(np.random.RandomState(seed).randint(2, 100, size=n)) for n in lens]
    monkeypatch.setenv("ZT_WINDOW_KV", "1")
    ran = dict(j_window=0, t_window=0, t_step=0, flush=0, window_writes=0)

    inside = []  # non-empty while the port runs a window step

    def spy(module, name, key, window_step=False):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            ran[key] += 1 if key != "window_writes" else bool(inside)
            inside.extend([1] if window_step else [])
            try:
                return fn(*a, **kw)
            finally:
                del inside[: int(window_step)]
        monkeypatch.setattr(module, name, wrapped)

    spy(JL, "forward_decode_window", "j_window")
    spy(TL, "forward_decode_window", "t_window", window_step=True)
    spy(TL, "forward_decode", "t_step")
    for name in ("flush_side_rows_hm", "flush_side_rows_2d", "flush_side_layers_hm",
                 "flush_side_layers_2d"):
        spy(W, name, "flush")
    for name in ("write_rows_hm", "write_rows_2d", "write_rows_pair", "rope_write_rows_pair"):
        spy(W, name, "window_writes")

    with monkeypatch.context() as m:
        m.setenv("ZT_PALLAS_INTERPRET", "1")
        jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
            max_model_len=64, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**sched)))
        with jllm.generator() as g:
            want = [g.generate(p, JGeneratorArg(max_length=max_length)).outputs[0].token_ids
                    for p in prompts]
    tllm = LLM(model_config=tcfg, params=params_to_torch(jax.device_get(jparams), "cpu"),
               device="cpu", engine_config=EngineConfig(
                   max_model_len=64, cache=CacheConfig(**cache),
                   scheduler=SchedulerConfig(**sched)))
    assert tllm.executor.window_kv
    with DynamicBatchGenerator(tllm) as g:
        got = [g.generate(p, GeneratorArg(max_length=max_length), timeout=300).outputs[0].token_ids
               for p in prompts]
    return got, want, ran


@pytest.mark.parametrize("name", sorted(ENGINE_MODELS))
def test_engine_window_tokens_match_jax(name, monkeypatch):
    model, cache, lens, max_length = ENGINE_MODELS[name]
    got, want, ran = _serve_both(monkeypatch, model, cache, {}, lens, max_length,
                                 seed=sorted(ENGINE_MODELS).index(name) + 1)
    assert got == want
    assert all(len(t) > 1 for t in got)
    assert ran["j_window"] > 0, "the JAX engine never took its window path"
    assert ran["t_window"] > 0 and ran["t_step"] == 0, ran
    assert ran["flush"] > 0 and ran["window_writes"] == 0, ran


@pytest.mark.parametrize("name", sorted(GATED))
def test_engine_decodes_per_step_where_the_side_path_is_off(name, monkeypatch):
    model, sched, cache = GATED[name]
    got, want, ran = _serve_both(monkeypatch, model, cache, sched, (13, 5), 10, seed=9)
    assert got == want
    assert ran["j_window"] == 0 and ran["t_window"] == 0 and ran["flush"] == 0, ran
    assert ran["t_step"] > 0
