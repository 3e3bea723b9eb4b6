"""The port's slot-major KV pools against the JAX package on the CPU.

The reference keeps separate K and V pools ``[N, Hkv, D]`` per layer whenever
``2*head_dim % 128 != 0`` (head_dim 16, 80, 96, 100 ...), or under
``ZT_NO_PACKED_KV=1``. The port stores each as ``[1, N, Hkv, D]`` (the
reference's array behind a unit dimension) and an int8 pool's scales
head-major ``[Hkv, N + 1]`` (the reference's ``[N, Hkv]``); ``_t_pool`` /
``_t_scales`` and ``_j_scales`` convert.

Held here, inputs from numpy seeds:
- the plain versions of the four slot-major kernels against the Pallas
  kernels in interpret mode: decode attention over bf16-dtype and int8 pools
  within rtol = atol = 1e-4 (an online softmax against a full one, fp32), the
  two row writes bit-exact;
- ``new_kv_cache`` / ``write_kv`` / ``gather_kv`` bit-equal to
  ``zhilight_tpu.kvcache.paged``, model-dtype and int8 pools;
- model logits and greedy tokens of the serving stack against the JAX model
  and engine at head_dim 16 and 80. With an int8 pool the logits agree to 1e-2
  of the largest: off the TPU the JAX decode step attends over ``gather_kv``'s
  rows, rounded to bf16 (``kvcache/paged.py:412-413``), where the port's
  kernel folds the fp32 scales and rounds nothing;
- the verify recipe's checkpoint (``tools/make_tiny_model.py``, head_dim 16)
  through ``LLM(model_path=...)``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_paged_attention_kernel import _setup as decode_setup
from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import paged as JP
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.ops.pallas.kv_write import paged_write_rows as j_paged_write_rows
from zhilight_tpu.ops.pallas.kv_write import write_rows_2d_pair as j_write_rows_2d_pair
from zhilight_tpu.ops.pallas.paged_attention import paged_decode_attention as j_decode
from zhilight_tpu.ops.pallas.paged_attention import paged_decode_attention_q as j_decode_q
from zhilight_tpu_torch.config import CacheConfig as TCacheConfig
from zhilight_tpu_torch.config import EngineConfig as TEngineConfig
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import SchedulerConfig as TSchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.kvcache import paged as TP
from zhilight_tpu_torch.llm import LLM as TLLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import paged_attention as PA
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
LOGIT_TOL = 1e-2  # int8 pools: the JAX side's bf16 rounding (module docstring)
S = 16


def T(a):
    return torch.from_numpy(np.array(a))


def _t_pool(a):
    """A JAX-layout pool [N, Hkv, D] in the port's layout [1, N, Hkv, D]."""
    return T(a)[None]


def _t_scales(s):
    """JAX-layout scales [N, Hkv] as the port's head-major [Hkv, N]."""
    return T(np.ascontiguousarray(np.asarray(s).T))


def _j_scales(s, n):
    """The port's scales [Hkv, N + 1] in the JAX layout [N, Hkv]."""
    return s[:, :n].numpy().T


# ---------------------------------------------------------------------------
# paged_decode_attention(_q): plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

DECODE_CASES = [(16, 1, 0), (16, 2, 0), (16, 4, 0), (80, 1, 0), (80, 2, 0), (80, 4, 0),
                (128, 1, 0), (128, 2, 0), (128, 4, 0), (16, 2, 7), (80, 4, 7), (128, 1, 7)]


@pytest.mark.parametrize("D,G,window", DECODE_CASES)
def test_plain_decode_attention_matches_pallas(D, G, window):
    """tests/test_paged_attention_kernel.py's inputs at head_dim 16, 80, 128."""
    q, k, v, tables, ctx = decode_setup(Hq=2 * G, Hkv=2, D=D, S=S, seed=D + G)
    scale = 1.0 / np.sqrt(D)
    want = j_decode(q, k, v, tables, ctx, S, scale, sliding_window=window, interpret=True)
    got = PA.paged_decode_attention(T(q), _t_pool(k), _t_pool(v), T(tables), T(ctx), S, scale,
                                    window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D", [16, 80])
def test_plain_decode_attention_empty_slot_is_zero_like_pallas(D):
    q, k, v, tables, ctx = decode_setup(B=3, Hq=4, Hkv=2, D=D, S=S)
    ctx, tables = np.array(ctx), np.array(tables)
    ctx[1] = 0
    tables[1] = -1
    want = j_decode(q, k, v, jnp.asarray(tables), jnp.asarray(ctx), S, 0.125, interpret=True)
    got = PA.paged_decode_attention(T(q), _t_pool(k), _t_pool(v), T(tables), T(ctx), S, 0.125)
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _quantized(D, G, B=4, seed=0):
    q, k, v, tables, ctx = decode_setup(B=B, Hq=2 * G, Hkv=2, D=D, S=S, seed=seed)
    (k_q, k_s), (v_q, v_s) = JP._quantize_rows(k), JP._quantize_rows(v)
    return q, k_q, v_q, k_s, v_s, np.array(tables), np.array(ctx)


@pytest.mark.parametrize("D,G,window", [(16, 2, 0), (16, 1, 7), (80, 4, 0), (80, 2, 7),
                                        (128, 1, 0), (128, 4, 7)])
def test_plain_decode_attention_q_matches_pallas(D, G, window):
    q, k_q, v_q, k_s, v_s, tables, ctx = _quantized(D, G, seed=D + G)
    scale = 1.0 / np.sqrt(D)
    want = j_decode_q(q, k_q, v_q, k_s, v_s, jnp.asarray(tables), jnp.asarray(ctx), S, scale,
                      sliding_window=window, interpret=True)
    got = PA.paged_decode_attention_q(T(q), _t_pool(k_q), _t_pool(v_q), _t_scales(k_s),
                                      _t_scales(v_s), T(tables), T(ctx), S, scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_plain_decode_attention_q_empty_slot_is_zero_like_pallas():
    q, k_q, v_q, k_s, v_s, tables, ctx = _quantized(80, 2, B=3)
    ctx[2] = 0
    tables[2] = -1
    want = j_decode_q(q, k_q, v_q, k_s, v_s, jnp.asarray(tables), jnp.asarray(ctx), S, 0.1,
                      interpret=True)
    got = PA.paged_decode_attention_q(T(q), _t_pool(k_q), _t_pool(v_q), _t_scales(k_s),
                                      _t_scales(v_s), T(tables), T(ctx), S, 0.1)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# the CUDA kernel's edges on its 64-token grid: one token, one whole tile,
# one token past it, and a context whose window starts mid-tile
EDGE_CTX = [1, 64, 65, 90]


def _edge_setup(D, G, seed):
    """4 sequences of EDGE_CTX on 2 KV heads (G query heads each), pages of
    16 in a shuffled table; tests/test_paged_attention_kernel.py's kind of
    inputs (fp32, unit variance)."""
    rng = np.random.RandomState(seed)
    ctx = np.array(EDGE_CTX, np.int32)
    maxp, P = 6, 32
    q = rng.randn(len(ctx), 2 * G, D).astype(np.float32)
    k, v = (rng.randn(P * S, 2, D).astype(np.float32) for _ in range(2))
    perm = rng.permutation(P)
    tables = np.full((len(ctx), maxp), -1, np.int32)
    o = 0
    for b, c in enumerate(ctx):
        n = -(-int(c) // S)
        tables[b, :n] = perm[o : o + n]
        o += n
    return q, k, v, tables, ctx


@pytest.mark.parametrize("window", [0, 40])  # 40: ctx 90 starts at token 50, mid-tile
@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("quantized", [False, True])
def test_plain_decode_attention_at_the_kernel_edges_matches_pallas(quantized, D, window):
    """Rows 10 and 13's plain versions at contexts 1, 64, 65 and a window
    starting mid-tile (G 4): the split and tile edges of the CUDA kernel."""
    q, k, v, tables, ctx = _edge_setup(D, 4, seed=D + window)
    scale = 1.0 / np.sqrt(D)
    jt, jc = jnp.asarray(tables), jnp.asarray(ctx)
    if quantized:
        (k_q, k_s), (v_q, v_s) = JP._quantize_rows(jnp.asarray(k)), JP._quantize_rows(jnp.asarray(v))
        want = j_decode_q(jnp.asarray(q), k_q, v_q, k_s, v_s, jt, jc, S, scale,
                          sliding_window=window, interpret=True)
        got = PA.paged_decode_attention_q(T(q), _t_pool(k_q), _t_pool(v_q), _t_scales(k_s),
                                          _t_scales(v_s), T(tables), T(ctx), S, scale, window)
    else:
        want = j_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jt, jc, S, scale,
                        sliding_window=window, interpret=True)
        got = PA.paged_decode_attention(T(q), _t_pool(k), _t_pool(v), T(tables), T(ctx), S,
                                        scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# the slot-major decode's split planner (ops/cuda/attn_headmajor.py
# decode_splits, split_shapes) at the serving heads: H2O-Danube-1.8B's 32 / 8
# of 80, Qwen2.5-14B's 40 / 8 of 128, batch 8
@pytest.mark.parametrize("max_ctx", [1, 64, 65, 3744])
@pytest.mark.parametrize("capacity", [64, 132, 396, 8448])
@pytest.mark.parametrize("Hq,Hkv,D", [(32, 8, 80), (40, 8, 128)])
def test_split_planner_fills_one_wave(Hq, Hkv, D, capacity, max_ctx):
    B, G = 8, Hq // Hkv
    blocks = B * Hkv * -(-G // 16)
    tiles = -(-max_ctx // 64)
    splits = A.decode_splits(B, Hkv, G, max_ctx, capacity)
    assert 1 <= splits <= min(64, tiles)
    if blocks <= capacity:  # one wave: every block fits, one more split would not
        assert splits * blocks <= capacity
        assert splits in (64, tiles) or (splits + 1) * blocks > capacity
    acc, ml, n = A.split_shapes(B, Hkv, G, D, splits)
    # the kernel's partial (b, head group, split) and ticket (b, head group)
    # indices stay inside what the wrapper allocates
    assert acc == (B, blocks // B, splits, 16, D) and ml == (B, blocks // B, splits, 2, 16)
    assert n == blocks


def test_decode_wrappers_take_the_plain_version_only_on_the_cpu():
    """Tensors on the meta device get no plain version and no kernel."""
    meta = dict(device="meta")
    q = torch.empty(3, 4, 80, **meta)
    pool = torch.empty(1, 64, 2, 80, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    tables, ctx = torch.empty(3, 4, **i32), torch.empty(3, **i32)
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention(q, pool, pool, tables, ctx, S, 0.1)
    sc = torch.empty(2, 65, **meta)
    with pytest.raises(NotImplementedError):
        PA.paged_decode_attention_q(q, pool, pool, sc, sc, tables, ctx, S, 0.1)
    rows = torch.empty(5, 2, 80, **meta)
    with pytest.raises(NotImplementedError):
        W.write_rows_pair(pool, pool, rows, rows, torch.empty(5, **i32))
    cos = torch.empty(5, 80, device="meta")
    with pytest.raises(NotImplementedError):
        W.rope_write_rows_pair(pool, pool, torch.empty(5, 4, 80, **meta), rows, rows, cos, cos,
                               True, torch.empty(5, **i32))


# ---------------------------------------------------------------------------
# paged_write_rows / write_rows_2d_pair: the one plain version against both Pallas writes
# ---------------------------------------------------------------------------

def _write_slots(rng, T_, N):
    """tests/test_kv_write_kernel.py's slot layouts: a decode step (T < 2S)
    puts each row mid-page on a page of its own, one row skipped; a chunk
    (T >= 2S, whole pages) fills page-aligned runs with a skipped tail."""
    slots = np.full(T_, -1, np.int32)
    if T_ < 2 * S:
        pages = rng.choice(N // S, size=T_, replace=False)
        slots[:] = pages * S + rng.randint(1, S, size=T_)
        if T_ > 1:
            slots[T_ // 2] = -1
    else:
        pages = rng.choice(N // S, size=T_ // S, replace=False)
        for i in range(T_ - 5):
            slots[i] = pages[i // S] * S + i % S
    return slots


@pytest.mark.parametrize("T_,H,D,dtype", [
    (1, 8, 80, np.float32), (5, 8, 80, np.float32), (32, 8, 80, np.float32),
    (5, 36, 64, np.float32), (32, 4, 64, np.float32), (5, 2, 16, np.int8),
])
def test_plain_pair_writes_match_pallas(T_, H, D, dtype):
    N = 256
    rng = np.random.RandomState(T_ + H + D)
    if dtype == np.int8:
        k_cache, v_cache, k_rows, v_rows = (
            rng.randint(-127, 128, size=shape).astype(np.int8)
            for shape in ((N, H, D), (N, H, D), (T_, H, D), (T_, H, D)))
    else:
        k_cache, v_cache, k_rows, v_rows = (
            rng.randn(*shape).astype(np.float32)
            for shape in ((N, H, D), (N, H, D), (T_, H, D), (T_, H, D)))
    slots = _write_slots(rng, T_, N)
    jargs = tuple(jnp.asarray(a) for a in (k_cache, v_cache, k_rows, v_rows, slots))
    for jfn, tfn in ((j_paged_write_rows, W.write_rows_pair),
                     (j_write_rows_2d_pair, W.write_rows_pair)):
        wk, wv = jfn(*jargs, S, interpret=True)
        gk, gv = tfn(_t_pool(k_cache), _t_pool(v_cache), T(k_rows), T(v_rows), T(slots))
        assert gk.shape == (1, N, H, D)
        np.testing.assert_array_equal(gk[0].numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv[0].numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# new_kv_cache / write_kv / gather_kv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("quantized", [False, True])
def test_cache_write_and_gather_bit_equal_to_jax(D, quantized):
    """Two writes (a chunk starting mid-page with a skipped row, then a decode
    step), then a gather through a shuffled page table with padding."""
    rng = np.random.RandomState(D)
    H, Pg = 2, 8
    jc = JP.new_kv_cache(1, Pg, S, H, D, jnp.float32, quantized=quantized)
    tc = TP.new_kv_cache(1, Pg, S, H, D, torch.float32, quantized=quantized, device="cpu")
    assert not jc.packed and not tc.packed and tc.quantized == quantized
    N = Pg * S
    assert (tc.num_slots, tc.num_pages, tc.num_layers) == (N, Pg, 1)
    want_dtype = torch.int8 if quantized else torch.float32
    assert [(tuple(a.shape), a.dtype) for a in (tc.k[0], tc.v[0])] == [((1, N, H, D), want_dtype)] * 2
    assert len(tc.arrays()) == (4 if quantized else 2)
    table = rng.permutation(Pg).astype(np.int32)
    for start, n in ((5, 20), (25, 1)):
        pos = np.arange(start, start + n)
        slots = (table[pos // S] * S + pos % S).astype(np.int32)
        if n > 1:
            slots[3] = -1
        k_new = rng.randn(n, H, D).astype(np.float32)
        v_new = rng.randn(n, H, D).astype(np.float32)
        jc = JP.write_kv(jc, 0, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots))
        tc = TP.write_kv(tc, 0, T(k_new), T(v_new), T(slots))
    np.testing.assert_array_equal(tc.k[0][0].numpy(), np.asarray(jc.k[0]))
    np.testing.assert_array_equal(tc.v[0][0].numpy(), np.asarray(jc.v[0]))
    if quantized:
        np.testing.assert_array_equal(_j_scales(tc.k_scale[0], N), np.asarray(jc.k_scale[0]))
        np.testing.assert_array_equal(_j_scales(tc.v_scale[0], N), np.asarray(jc.v_scale[0]))
    pages = np.array([[table[0], table[1], -1], [table[1], -1, -1]], np.int32)
    jk, jv = JP.gather_kv(jc, 0, jnp.asarray(pages))
    tk, tv = TP.gather_kv(tc, 0, T(pages))
    assert tk.dtype == (torch.bfloat16 if quantized else torch.float32)
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


def test_no_packed_kv_switch_gives_a_slot_major_pool(monkeypatch):
    assert TP.new_kv_cache(1, 4, S, 2, 64, torch.float32, device="cpu").packed
    monkeypatch.setenv("ZT_NO_PACKED_KV", "1")
    for quantized in (False, True):
        cache = TP.new_kv_cache(1, 4, S, 2, 64, torch.float32, quantized=quantized, device="cpu")
        assert not cache.packed and cache.k[0].shape == (1, 4 * S, 2, 64)


# ---------------------------------------------------------------------------
# model and serving stack
# ---------------------------------------------------------------------------

VOCAB, EOS = 64, 1


def _model(D):
    return dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=D,
                num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")


@pytest.fixture(scope="module", params=[16, 80])
def weights(request):
    """A tiny fp32 model at head_dim 16 or 80, the JAX package's weights in both."""
    jcfg = JModelConfig(**_model(request.param))
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, TModelConfig(**_model(request.param)), params_to_torch(
        jax.device_get(jparams), "cpu")


def _prefill_then_decode(side, cfg, params, cache, n, table, PS, rng):
    """A 13-token prefill through a shuffled page table, then a decode step
    of the prefill's argmax; returns both logits and the cache."""
    mod, PrefillMeta, DecodeMeta, arr, scalar = side
    toks = np.zeros(16, np.int32)
    toks[:n] = rng.randint(2, VOCAB, size=n)
    pos = np.zeros(16, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(16, -1, np.int32)
    slots[:n] = table[pos[:n] // PS] * PS + pos[:n] % PS
    rope = mod.build_rope(cfg)
    meta = PrefillMeta(arr(pos), arr(slots), arr(table), scalar(0), scalar(n))
    first, cache = mod.forward_prefill(params, cfg, rope, arr(toks), meta, cache)
    dslot = np.array([table[n // PS] * PS + n % PS], np.int32)
    meta = DecodeMeta(arr(np.array([n], np.int32)), arr(dslot), arr(table[None].copy()),
                      arr(np.array([n + 1], np.int32)))
    tok = np.array([int(np.argmax(np.asarray(first)))], np.int32)
    step, cache = mod.forward_decode(params, cfg, rope, arr(tok), meta, cache)
    return np.asarray(first), np.asarray(step), cache


JAX_SIDE = (JL, JPrefillMeta, JDecodeMeta, jnp.asarray, jnp.int32)
TORCH_SIDE = (TL, TPrefillMeta, TDecodeMeta, T, lambda x: torch.tensor(x, dtype=torch.int32))


@pytest.mark.parametrize("quantized", [False, True])
def test_model_prefill_then_decode_matches_jax(weights, quantized):
    jcfg, jp, tcfg, tp = weights
    PS, PAGES, MAXP, n = 4, 12, 6, 13
    table = np.full(MAXP, -1, np.int32)
    table[:4] = np.random.RandomState(4).permutation(PAGES)[:4]
    D = tcfg.dim_head
    jc = JP.new_kv_cache(2, PAGES, PS, 2, D, jnp.float32, quantized=quantized)
    tc = TP.new_kv_cache(2, PAGES, PS, 2, D, torch.float32, quantized=quantized, device="cpu")
    jf, js, jc = _prefill_then_decode(JAX_SIDE, jcfg, jp, jc, n, table, PS, np.random.RandomState(5))
    tf, ts, tc = _prefill_then_decode(TORCH_SIDE, tcfg, tp, tc, n, table, PS,
                                      np.random.RandomState(5))
    if quantized:
        for got, want in ((tf, jf), (ts, js)):
            assert np.abs(got - want).max() < LOGIT_TOL * np.abs(want).max()
        # layer 0 sees the same inputs on both sides: the same int8 rows
        np.testing.assert_array_equal(tc.k[0][0].numpy(), np.asarray(jc.k[0]))
    else:
        np.testing.assert_allclose(tf, jf, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tc.v[1][0].numpy(), np.asarray(jc.v[1]), rtol=RTOL, atol=ATOL)


def test_no_packed_kv_logits_match_the_packed_pool(monkeypatch):
    """head_dim 64 under ZT_NO_PACKED_KV=1: the slot-major pools give the
    packed pool's logits."""
    cfg = TModelConfig(**_model(64))
    params = TL.init_params(cfg, seed=0, device="cpu")
    PS, PAGES, MAXP, n = 4, 12, 6, 13
    table = np.full(MAXP, -1, np.int32)
    table[:4] = np.random.RandomState(6).permutation(PAGES)[:4]
    out = {}
    for switch in ("0", "1"):
        monkeypatch.setenv("ZT_NO_PACKED_KV", switch)
        cache = TP.new_kv_cache(2, PAGES, PS, 2, 64, torch.float32, device="cpu")
        assert cache.packed == (switch == "0")
        out[switch] = _prefill_then_decode(TORCH_SIDE, cfg, params, cache, n, table, PS,
                                           np.random.RandomState(7))[:2]
    for got, want in zip(out["1"], out["0"]):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_pool_bytes_per_token_match_the_slot_major_arrays(weights, kv_dtype):
    """A GPU pool is sized by _kv_bytes_per_token, whatever the layout: it is
    what the slot-major arrays hold per slot (the int8 scales' spare column
    aside). At H2O-Danube-1.8B's geometry (24 layers, 8 KV heads of 80): 61,440
    bytes a token in bf16, 32,256 in int8 with scales."""
    from types import SimpleNamespace

    from zhilight_tpu_torch.config import adapt_hf_config
    from zhilight_tpu_torch.engine.engine import ModelExecutor

    _, _, tcfg, tp = weights
    ex = TLLM(model_config=tcfg, params=tp, device="cpu", engine_config=TEngineConfig(
        max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=16, kv_dtype=kv_dtype),
        scheduler=TSchedulerConfig(**SCHED))).executor
    total = sum(a.numel() * a.element_size() for arrays in ex.cache.arrays() for a in arrays)
    spare = 2 * tcfg.num_layers * tcfg.num_kv_heads * 4 if kv_dtype == "int8" else 0
    assert not ex.cache.packed and total == ex.cache.num_slots * ex._kv_bytes_per_token() + spare
    danube = adapt_hf_config(dict(
        model_type="mistral", hidden_size=2560, intermediate_size=6912, num_hidden_layers=24,
        num_attention_heads=32, num_key_value_heads=8, vocab_size=32000, rms_norm_eps=1e-5,
        rope_theta=10000.0, sliding_window=4096, torch_dtype="bfloat16"))
    assert (danube.dim_head, danube.sliding_window) == (80, 4096)
    per = ModelExecutor._kv_bytes_per_token(SimpleNamespace(
        cfg=danube, cache_cfg=TCacheConfig(kv_dtype="int8" if kv_dtype == "int8" else "bfloat16")))
    assert per == (32256 if kv_dtype == "int8" else 61440)


SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)


def _engines(weights, kv_dtype, sched=SCHED, num_pages=64):
    jcfg, jp, tcfg, tp = weights
    jllm = JLLM(model_config=jcfg, params=jp, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=num_pages, kv_dtype=kv_dtype),
        scheduler=JSchedulerConfig(**sched)))
    tllm = TLLM(model_config=tcfg, params=tp, device="cpu", engine_config=TEngineConfig(
        max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=num_pages, kv_dtype=kv_dtype),
        scheduler=TSchedulerConfig(**sched)))
    assert not jllm.executor.cache.packed and not tllm.executor.cache.packed
    return jllm, tllm


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_engine_greedy_tokens_match_jax_engine(weights, kv_dtype):
    """Four concurrent requests crossing the page (4) and chunk (16) sizes,
    4-step decode windows and a packed prefill group, then a long request
    alone (a chunk chain)."""
    jllm, tllm = _engines(weights, kv_dtype)
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in (3, 9, 18, 37)]
    long_prompt = list(rng.randint(2, VOCAB, size=50))
    got = {}
    for llm, gen_cls, arg_cls in ((jllm, JGenerator, JGeneratorArg),
                                  (tllm, TGenerator, TGeneratorArg)):
        with gen_cls(llm) as gen:
            res = gen.batch_generate(prompts, [arg_cls(max_length=10) for _ in prompts],
                                     timeout=300)
            res.append(gen.generate(long_prompt, arg_cls(max_length=10), timeout=300))
            stats = (gen.scheduler.num_packed_prefills, gen.scheduler.num_chunk_chains)
        got[gen_cls] = ([r.outputs[0].token_ids for r in res], stats)
    assert got[TGenerator] == got[JGenerator]
    tokens, (packed, chains) = got[TGenerator]
    assert sum(map(len, tokens)) > len(tokens) and packed >= 1 and chains >= 1
    if kv_dtype == "int8":
        assert any(s.any() for s in tllm.executor.cache.k_scale)


def test_beam_request_matches_jax_engine(weights):
    jllm, tllm = _engines(weights, "float32")
    prompt = list(np.random.RandomState(4).randint(2, VOCAB, size=7))
    kw = dict(beam_size=3, num_results=2, max_length=8)
    with JGenerator(jllm) as gen:
        want = [(o.token_ids, o.score) for o in gen.generate(prompt, JGeneratorArg(**kw)).outputs]
    with TGenerator(tllm) as gen:
        got = [(o.token_ids, o.score) for o in gen.generate(prompt, TGeneratorArg(**kw)).outputs]
    assert len(got) == len(want) == 2
    for (gt, gs), (wt, ws) in zip(got, want):
        assert gt == wt and abs(gs - ws) < 1e-3


def test_swap_preemption_gives_the_unpreempted_outputs(weights):
    """8 pages x 4 = 32 KV tokens for two requests that need 54: the newer is
    swapped out (its K and V rows to the host) and back; both return the JAX
    engine's tokens with room for both."""
    rng = np.random.RandomState(21)
    prompts = [list(rng.randint(2, VOCAB, size=7)) for _ in range(2)]
    sched = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                 ignore_eos=True, admission_reserve=0.2, preempt_mode="swap", session_ttl=0.0)
    jllm, _ = _engines(weights, "float32", dict(sched, admission_reserve=1.0))
    _, tllm = _engines(weights, "float32", sched, num_pages=8)
    with JGenerator(jllm) as gen:
        want = [r.outputs[0].token_ids
                for r in gen.batch_generate(prompts, JGeneratorArg(max_length=20, ignore_eos=True))]
    with TGenerator(tllm) as gen:
        got = [r.outputs[0].token_ids
               for r in gen.batch_generate(prompts, TGeneratorArg(max_length=20))]
        assert gen.scheduler.num_preemptions >= 1
    assert got == want and all(len(t) == 20 for t in got)


def test_verify_recipe_checkpoint_serves_like_jax(tmp_path):
    """tools/make_tiny_model.py's checkpoint (hidden 64, 4 heads: head_dim 16)
    through LLM(model_path=...) on token ids, greedy, as the JAX package."""
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    path = Path(__file__).resolve().parents[1] / "tools" / "make_tiny_model.py"
    spec = importlib.util.spec_from_file_location("make_tiny_model", path)
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    maker.make(str(tmp_path))
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18]]
    tllm = TLLM(model_path=str(tmp_path), device="cpu")
    assert tllm.model_config.dim_head == 16 and not tllm.executor.cache.packed
    with TGenerator(tllm) as gen:
        got = [r.outputs[0].token_ids for r in gen.batch_generate(prompts, TGeneratorArg(max_length=8))]
    with JGenerator(JLLM(model_path=str(tmp_path))) as gen:
        want = [r.outputs[0].token_ids for r in gen.batch_generate(prompts, JGeneratorArg(max_length=8))]
    assert got == want and all(len(t) > 0 for t in got)
