"""The port's int8 KV cache against the JAX package on the CPU.

Row quantization, the quantized ``write_kv`` and ``gather_kv`` are held
bit-equal to ``zhilight_tpu.kvcache.paged``; the plain versions of the two
int8 attention kernels to the Pallas kernels run in interpret mode (fp32,
rtol = atol = 1e-4: an online softmax against a full one); the model and the
serving stack with ``kv_dtype="int8"`` to the JAX model and engine.

Layouts: the port keeps the scales head-major ``[Hkv, N + 1]`` (last column a
spare for skipped rows), the JAX package slot-major ``[N, Hkv]``; ``_t_scales``
and ``_j_scales`` convert.

One difference is pinned here. Off the TPU the JAX model attends over
``gather_kv``'s rows, which it dequantizes and rounds to bf16 even in an fp32
model; its Pallas kernels, and the port, fold the fp32 scales into scores and
probabilities and round nothing. Model logits therefore agree only to
``LOGIT_TOL`` of the largest logit, while layer 0's int8 rows agree exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_int8_headmajor import _quant, _setup as decode_setup
from test_prefill_kernel import _setup as prefill_setup
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
from zhilight_tpu.ops.pallas.attn_headmajor import paged_decode_attention_hm_q as j_decode_q
from zhilight_tpu.ops.pallas.prefill_attention import (
    paged_prefill_attention_hm_packed_q as j_prefill_packed_q,
)
from zhilight_tpu.ops.pallas.prefill_attention import paged_prefill_attention_hm_q as j_prefill_q
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
from zhilight_tpu_torch.ops.cuda import prefill_attention as P
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
# bf16 rounding of the JAX model's dequantized rows (8 bits of mantissa, two
# layers) against the port's fp32 folds; measured 5.8e-3 (prefill) and 4.5e-3
# (decode step) of the largest logit
LOGIT_TOL = 1e-2
S = 16
T = torch.from_numpy


def _t_scales(s):
    """JAX-layout scales [N, Hkv] as the port's head-major [Hkv, N]."""
    return T(np.ascontiguousarray(np.asarray(s).T))


def _j_scales(s, n):
    """The port's scales [Hkv, N + 1] in the JAX layout [N, Hkv]."""
    return s[:, :n].numpy().T


def _pool(k_q, v_q):
    return np.concatenate([k_q, v_q], axis=-1).transpose(1, 0, 2).copy()  # [Hkv, N, 2D]


# ---------------------------------------------------------------------------
# quantization, write, gather
# ---------------------------------------------------------------------------

def test_quantize_rows_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(12, 3, 64) * rng.uniform(0.01, 30, size=(12, 3, 1))).astype(np.float32)
    x[2, 1] = 0.0                      # an all-zero row: the 1e-8 scale floor
    x[5, 0] = 0.0                      # a row whose scale is exactly 1 ...
    x[5, 0, 0] = 127.0
    x[5, 0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]  # ... and ties
    want_q, want_s = JP._quantize_rows(jnp.asarray(x))
    got_q, got_s = TP._quantize_rows(T(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[2, 1].item() == np.float32(1e-8)
    np.testing.assert_array_equal(got_q[5, 0, 1:9].numpy(), [0, 2, 2, 0, -2, -2, 126, -126])


def test_quantized_write_and_gather_bit_equal_to_jax():
    """A write with a skipped row into an int8 cache, then a gather of every
    page (the inputs of tests/test_int8_headmajor.py's round trip)."""
    rng = np.random.RandomState(1)
    H, D, Pg, n = 2, 64, 8, 10
    k_new = rng.randn(n, H, D).astype(np.float32)
    v_new = rng.randn(n, H, D).astype(np.float32)
    slots = np.arange(n, dtype=np.int32)
    slots[3] = -1
    pages = np.arange(Pg, dtype=np.int32)

    jc = JP.new_kv_cache(1, Pg, S, H, D, jnp.bfloat16, quantized=True)
    jc = JP.write_kv(jc, 0, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots))
    tc = TP.new_kv_cache(1, Pg, S, H, D, torch.bfloat16, quantized=True, device="cpu")
    assert tc.quantized and tc.k[0].dtype == torch.int8
    tc = TP.write_kv(tc, 0, T(k_new), T(v_new), T(slots))

    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
    np.testing.assert_array_equal(_j_scales(tc.k_scale[0], Pg * S), np.asarray(jc.k_scale[0]))
    np.testing.assert_array_equal(_j_scales(tc.v_scale[0], Pg * S), np.asarray(jc.v_scale[0]))
    assert not tc.k[0][:, 3].any() and not tc.k_scale[0][:, 3].any()  # the skipped row

    jk, jv = JP.gather_kv(jc, 0, jnp.asarray(pages))
    tk, tv = TP.gather_kv(tc, 0, T(pages))
    assert tk.dtype == torch.bfloat16
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv, np.float32))


# ---------------------------------------------------------------------------
# paged_decode_attention_hm_q
# ---------------------------------------------------------------------------

def _decode_q_case(hkv, hq, B=4):
    q, k, v, tables, ctx = decode_setup(B=B, Hq=hq, Hkv=hkv)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v)
    return q, _pool(k_q, v_q), k_s, v_s, tables, ctx


@pytest.mark.parametrize("hkv,hq", [(2, 8), (8, 8)])
@pytest.mark.parametrize("sliding_window", [0, 24])
def test_decode_attention_q_matches_pallas(hkv, hq, sliding_window):
    q, pool, k_s, v_s, tables, ctx = _decode_q_case(hkv, hq)
    scale = 1.0 / np.sqrt(q.shape[-1])
    want = j_decode_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                      jnp.asarray(tables), jnp.asarray(ctx), S, scale,
                      sliding_window=sliding_window, interpret=True)
    got = A.paged_decode_attention_hm_q(T(q), T(pool), _t_scales(k_s), _t_scales(v_s),
                                        T(tables), T(ctx), S, scale, sliding_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_decode_attention_q_empty_slot_is_zero_like_pallas():
    q, pool, k_s, v_s, tables, ctx = _decode_q_case(2, 8, B=3)
    ctx[1] = 0
    tables[1] = -1
    want = j_decode_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                      jnp.asarray(tables), jnp.asarray(ctx), S, 0.125, interpret=True)
    got = A.paged_decode_attention_hm_q(T(q), T(pool), _t_scales(k_s), _t_scales(v_s),
                                        T(tables), T(ctx), S, 0.125)
    assert not torch.isnan(got).any()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hkv,hq,D,window", [(2, 8, 192, 0), (2, 8, 256, 0), (8, 16, 256, 24),
                                             (1, 16, 128, 0)])
def test_decode_attention_q_wide_heads_match_pallas(hkv, hq, D, window):
    """Head dims 192 and 256, which the reference packs into an int8 pool
    too, and a group of 16 at head_dim 128: the shapes the int8 CUDA decode
    kernel takes since its redesign, its plain version against the Pallas
    kernel."""
    q, k, v, tables, ctx = decode_setup(Hq=hq, Hkv=hkv, D=D, seed=D + hq)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v)
    pool = _pool(k_q, v_q)
    scale = 1.0 / np.sqrt(D)
    want = j_decode_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                      jnp.asarray(tables), jnp.asarray(ctx), S, scale,
                      sliding_window=window, interpret=True)
    got = A.paged_decode_attention_hm_q(T(q), T(pool), _t_scales(k_s), _t_scales(v_s),
                                        T(tables), T(ctx), S, scale, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the twins: plain versions in the kernels' rounding order, on bf16 inputs
# ---------------------------------------------------------------------------

# max |twin - Pallas| / max |Pallas| on bf16 inputs. Twin and kernel round
# p * v_scale at the same place and divide by l last; what differs is the
# order of the fp32 sums and, in prefill, the Pallas kernel's running max over
# its key blocks (measured at most 2^-10 on these inputs). The existing plain
# versions round softmax * v_scale instead, which costs up to one bf16 ulp of
# the output: on the (seed 0, V x 6) case, with outputs in [4, 16), more than
# this bound.
TWIN_TOL = 2.0 ** -8


def _bf16_np(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16()


def _twin_errors(got_twin, got_plain, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    top = np.abs(want).max()
    return (np.abs(got_twin.float().numpy() - want).max() / top,
            np.abs(got_plain.float().numpy() - want).max() / top)


@pytest.mark.parametrize("seed,v_mul", [(0, 1.0), (1, 1.0), (0, 6.0)])
def test_decode_attention_q_twin_matches_pallas_on_bf16(seed, v_mul):
    """paged_decode_attention_hm_q_twin against the Pallas kernel on bf16 q;
    the plain version is further off, and on (0, 6.0) outside the bound."""
    q, k, v, tables, ctx = decode_setup(B=4, Hq=8, Hkv=2, D=64, seed=seed)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v * v_mul)
    pool = _pool(k_q, v_q)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = j_decode_q(qb, jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                      jnp.asarray(tables), jnp.asarray(ctx), S, 0.125, interpret=True)
    args = (_bf16_np(np.asarray(qb, np.float32)), T(pool), _t_scales(k_s), _t_scales(v_s),
            T(tables), T(ctx), S, 0.125)
    twin, plain = _twin_errors(A.paged_decode_attention_hm_q_twin(*args),
                               A.paged_decode_attention_hm_q_plain(*args), want)
    assert twin <= TWIN_TOL and twin <= plain
    if v_mul > 1:
        assert plain > TWIN_TOL


@pytest.mark.parametrize("seed,v_mul", [(0, 1.0), (1, 1.0), (0, 6.0)])
def test_prefill_attention_q_twin_matches_pallas_on_bf16(seed, v_mul):
    """paged_prefill_attention_hm_packed_q_twin against the Pallas kernel on
    bf16 q: a 50-token chunk at cache 40."""
    n, cache_len, q_len, D = 64, 40, 50, 64
    q, k, v, pages, _ = prefill_setup(n, cache_len + q_len, 8, 2, D, seed=seed)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v * v_mul)
    pool = _pool(k_q, v_q)
    qb = jnp.asarray(q, jnp.bfloat16)
    want = j_prefill_q(qb, jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                       jnp.asarray(pages), jnp.int32(cache_len), jnp.int32(q_len), S, 0.125,
                       interpret=True)[:q_len]
    args = (_bf16_np(np.asarray(qb, np.float32)), T(pool), _t_scales(k_s), _t_scales(v_s),
            T(pages)[None], torch.tensor([cache_len], dtype=torch.int32),
            torch.tensor([q_len], dtype=torch.int32), S, 0.125)
    twin, plain = _twin_errors(P.paged_prefill_attention_hm_packed_q_twin(*args)[:q_len],
                               P.paged_prefill_attention_hm_packed_q_plain(*args)[:q_len], want)
    assert twin <= TWIN_TOL and twin <= plain
    if v_mul > 1:
        assert plain > TWIN_TOL


# ---------------------------------------------------------------------------
# paged_prefill_attention_hm(_packed)_q
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "hkv,hq,cache_len,window", [(2, 8, 0, 0), (8, 8, 40, 0), (4, 4, 7, 0), (2, 8, 40, 24)]
)
def test_prefill_attention_q_matches_pallas(hkv, hq, cache_len, window):
    n, q_len, D = 64, 50, 64
    q, k, v, pages, _ = prefill_setup(n, cache_len + q_len, hq, hkv, D, seed=3)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v)
    pool = _pool(k_q, v_q)
    scale = 1.0 / np.sqrt(D)
    want = j_prefill_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                       jnp.asarray(pages), jnp.int32(cache_len), jnp.int32(q_len), S, scale,
                       sliding_window=window, interpret=True)
    got = P.paged_prefill_attention_hm_q(T(q), T(pool), _t_scales(k_s), _t_scales(v_s), T(pages),
                                         torch.tensor(cache_len), torch.tensor(q_len), S, scale,
                                         window)
    np.testing.assert_allclose(got[:q_len].numpy(), np.asarray(want)[:q_len], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hkv,hq,D,window", [(2, 8, 192, 0), (2, 8, 256, 0), (8, 16, 256, 24)])
def test_prefill_attention_q_wide_heads_match_pallas(hkv, hq, D, window):
    """Head dims 192 and 256, which the reference packs into an int8 pool
    too: a 50-token chunk at cache 40."""
    n, cache_len, q_len = 64, 40, 50
    q, k, v, pages, _ = prefill_setup(n, cache_len + q_len, hq, hkv, D, seed=3)
    k_q, k_s = _quant(k)
    v_q, v_s = _quant(v)
    pool = _pool(k_q, v_q)
    scale = 1.0 / np.sqrt(D)
    want = j_prefill_q(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
                       jnp.asarray(pages), jnp.int32(cache_len), jnp.int32(q_len), S, scale,
                       sliding_window=window, interpret=True)
    got = P.paged_prefill_attention_hm_q(T(q), T(pool), _t_scales(k_s), _t_scales(v_s), T(pages),
                                         torch.tensor(cache_len), torch.tensor(q_len), S, scale,
                                         window)
    np.testing.assert_allclose(got[:q_len].numpy(), np.asarray(want)[:q_len], rtol=RTOL, atol=ATOL)


def test_packed_prefill_attention_q_matches_pallas():
    """Two packed segments, one with cached context and one short
    (tests/test_prefill_kernel.py's int8 packed case)."""
    rng = np.random.RandomState(5)
    NS, TC, Hq, Hkv, D, Pg, maxp = 2, 32, 8, 4, 64, 16, 5
    cache_lens = np.asarray([20, 0], np.int32)
    q_lens = np.asarray([32, 17], np.int32)
    k_q, k_s = _quant(rng.randn(Pg * S, Hkv, D).astype(np.float32))
    v_q, v_s = _quant(rng.randn(Pg * S, Hkv, D).astype(np.float32))
    pool = _pool(k_q, v_q)
    q = rng.randn(NS * TC, Hq, D).astype(np.float32)
    tables = np.full((NS, maxp), -1, np.int32)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :2] = [0, 5]
    scale = 1.0 / np.sqrt(D)
    want = np.asarray(j_prefill_packed_q(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(k_s), jnp.asarray(v_s),
        jnp.asarray(tables), jnp.asarray(cache_lens), jnp.asarray(q_lens), S, scale,
        interpret=True))
    got = P.paged_prefill_attention_hm_packed_q(
        T(q), T(pool), _t_scales(k_s), _t_scales(v_s), T(tables), T(cache_lens), T(q_lens),
        S, scale).numpy()
    assert np.all(np.isfinite(got))
    for s in range(NS):
        rows = slice(s * TC, s * TC + int(q_lens[s]))
        np.testing.assert_allclose(got[rows], want[rows], rtol=RTOL, atol=ATOL)


def test_q_wrappers_take_the_plain_version_only_on_the_cpu():
    """Tensors on the meta device get no plain version and no kernel."""
    meta = dict(device="meta")
    pool = torch.empty(2, 64, 128, dtype=torch.int8, **meta)
    sc = torch.empty(2, 65, **meta)
    q = torch.empty(3, 4, 64, **meta)
    i32 = dict(dtype=torch.int32, **meta)
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm_q(q, pool, sc, sc, torch.empty(3, 4, **i32),
                                      torch.empty(3, **i32), S, 0.125)
    with pytest.raises(NotImplementedError):
        P.paged_prefill_attention_hm_packed_q(q, pool, sc, sc, torch.empty(1, 4, **i32),
                                              torch.empty(1, **i32), torch.empty(1, **i32),
                                              S, 0.125)


def test_decode_attention_q_emit_partial_raises():
    """The flash-partial mode takes its plain version only on the CPU (held
    to the Pallas kernel in tests/test_torch_window.py): tensors on the meta
    device get no plain version and no kernel, and raise."""
    q, pool, k_s, v_s, tables, ctx = _decode_q_case(2, 8, B=2)
    args = (T(q), T(pool), _t_scales(k_s), _t_scales(v_s), T(tables), T(ctx), S, 0.125)
    got = A.paged_decode_attention_hm_q(*args, emit_partial=True)
    want = A.paged_decode_attention_hm_q_partial_plain(*args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(NotImplementedError):
        A.paged_decode_attention_hm_q(*(a.to("meta") for a in args[:6]), S, 0.125,
                                      emit_partial=True)


# ---------------------------------------------------------------------------
# model and serving stack
# ---------------------------------------------------------------------------

VOCAB, EOS = 64, 1
MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")


@pytest.fixture(scope="module")
def weights():
    """The tiny model of tests/test_int8_headmajor.py's engine test."""
    jcfg = JModelConfig(**MODEL)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, TModelConfig(**MODEL), params_to_torch(jax.device_get(jparams), "cpu")


def test_model_prefill_then_decode_matches_jax(weights):
    """A 13-token prefill through a shuffled page table (page size 4), then a
    decode step, over int8 caches. The pools must hold the same int8 rows;
    the logits differ by the JAX side's bf16 rounding (module docstring)."""
    jcfg, jp, tcfg, tp = weights
    jrope, trope = JL.build_rope(jcfg), TL.build_rope(tcfg)
    PS, PAGES, MAXP, n = 4, 12, 6, 13
    rng = np.random.RandomState(4)
    jc = JP.new_kv_cache(2, PAGES, PS, 2, 64, jnp.float32, quantized=True)
    tc = TP.new_kv_cache(2, PAGES, PS, 2, 64, torch.float32, quantized=True, device="cpu")
    table = np.full(MAXP, -1, np.int32)
    table[:4] = rng.permutation(PAGES)[:4]
    toks = np.zeros(16, np.int32)
    toks[:n] = rng.randint(2, VOCAB, size=n)
    pos = np.zeros(16, np.int32)
    pos[:n] = np.arange(n)
    slots = np.full(16, -1, np.int32)
    slots[:n] = table[pos[:n] // PS] * PS + pos[:n] % PS
    jm = JPrefillMeta(jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(table),
                      jnp.int32(0), jnp.int32(n))
    tm = TPrefillMeta(T(pos), T(slots), T(table), torch.tensor(0, dtype=torch.int32),
                      torch.tensor(n, dtype=torch.int32))
    jl, jc = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jc)
    tl, tc = TL.forward_prefill(tp, tcfg, trope, T(toks), tm, tc)

    def rel(got, want):
        want = np.asarray(want)
        return np.abs(got.numpy() - want).max() / np.abs(want).max()

    assert rel(tl, jl) < LOGIT_TOL
    dpos = np.array([n], np.int32)
    dslot = np.array([table[n // PS] * PS + n % PS], np.int32)
    dtok = np.array([int(np.argmax(np.asarray(jl)))], np.int32)
    dctx = np.array([n + 1], np.int32)
    jm = JDecodeMeta(jnp.asarray(dpos), jnp.asarray(dslot), jnp.asarray(table[None]),
                     jnp.asarray(dctx))
    tm = TDecodeMeta(T(dpos), T(dslot), T(table[None].copy()), T(dctx))
    jl, jc = JL.forward_decode(jp, jcfg, jrope, jnp.asarray(dtok), jm, jc)
    tl, tc = TL.forward_decode(tp, tcfg, trope, T(dtok), tm, tc)
    assert rel(tl, jl) < LOGIT_TOL

    # layer 0 sees the same inputs on both sides: its int8 rows are those of
    # the JAX cache. Its scales are amax / 127 of K and V rows that the two
    # frameworks sum in another order, so they agree to an fp32 ulp (measured
    # 3.0e-7 relative), not bit for bit as the same rows do through
    # _quantize_rows above
    N = PAGES * PS
    np.testing.assert_array_equal(tc.k[0].numpy(), np.asarray(jc.k[0]))
    for got, want in ((tc.k_scale[0], jc.k_scale[0]), (tc.v_scale[0], jc.v_scale[0])):
        np.testing.assert_allclose(_j_scales(got, N), np.asarray(want), rtol=1e-6, atol=0)
    # layer 1's inputs carry the rounding difference: rows within one step
    diff = np.abs(tc.k[1].numpy().astype(np.int32) - np.asarray(jc.k[1]).astype(np.int32))
    assert diff.max() <= 1


def test_int8_engine_greedy_tokens_match_jax_engine(weights):
    """LLM + DynamicBatchGenerator with kv_dtype="int8" (the model, prompts
    and settings of tests/test_int8_headmajor.py's engine test)."""
    jcfg, jp, tcfg, tp = weights
    rng = np.random.RandomState(7)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in (5, 11, 19)]
    sched = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS)

    jllm = JLLM(model_config=jcfg, params=jp, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=64, kv_dtype="int8"),
        scheduler=JSchedulerConfig(**sched)))
    assert jllm.executor.cache.packed and jllm.executor.cache.quantized
    with JGenerator(jllm) as gen:
        want = [r.outputs[0].token_ids
                for r in gen.batch_generate(prompts, JGeneratorArg(max_length=8))]

    tllm = TLLM(model_config=tcfg, params=tp, device="cpu", engine_config=TEngineConfig(
        max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=64, kv_dtype="int8"),
        scheduler=TSchedulerConfig(**sched)))
    ex = tllm.executor
    assert ex.cache.quantized and ex.cache.k[0].dtype == torch.int8
    with TGenerator(tllm) as gen:
        got = [r.outputs[0].token_ids
               for r in gen.batch_generate(prompts, TGeneratorArg(max_length=8))]
    assert got == want
    assert all(len(t) > 0 for t in got)
    assert any(s.any() for s in ex.cache.k_scale), "the int8 pool was never written"


def test_int8_engine_head_dim_256_matches_jax_engine():
    """A model at Gemma-2-9B's attention shape cut to size (2 layers, 4 / 2
    heads of 256, narrow width) served over an int8 pool: the reference packs
    head_dim 256 into the head-major int8 pool, and the port decodes it with
    the same kernels on the card (the CPU runs their plain versions here).
    Greedy tokens equal the JAX engine's."""
    model = dict(MODEL, num_heads=4, num_kv_heads=2, dim_head=256)
    jcfg = JModelConfig(**model)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tparams = params_to_torch(jax.device_get(jparams), "cpu")
    rng = np.random.RandomState(11)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in (6, 13)]
    sched = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16), eos_id=EOS)
    cache = dict(page_size=4, num_pages=32, kv_dtype="int8")

    jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=32, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**sched)))
    assert jllm.executor.cache.packed and jllm.executor.cache.quantized
    with JGenerator(jllm) as gen:
        want = [r.outputs[0].token_ids
                for r in gen.batch_generate(prompts, JGeneratorArg(max_length=6))]

    tllm = TLLM(model_config=TModelConfig(**model), params=tparams, device="cpu",
                engine_config=TEngineConfig(max_model_len=32, cache=TCacheConfig(**cache),
                                            scheduler=TSchedulerConfig(**sched)))
    ex = tllm.executor
    assert ex.cache.packed and ex.cache.k[0].shape[-1] == 512 and ex.cache.k[0].dtype == torch.int8
    with TGenerator(tllm) as gen:
        got = [r.outputs[0].token_ids
               for r in gen.batch_generate(prompts, TGeneratorArg(max_length=6))]
    assert got == want and all(len(t) > 0 for t in got)


def test_llm_int8_without_device_raises_without_gpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: LLM would run on it")
    _, _, tcfg, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLLM(model_config=tcfg, params=tp, engine_config=TEngineConfig(
            max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=64, kv_dtype="int8")))


def test_other_kv_dtypes_still_raise(weights):
    _, _, tcfg, tp = weights
    with pytest.raises(NotImplementedError, match="KV dtype"):
        TLLM(model_config=tcfg, params=tp, device="cpu", engine_config=TEngineConfig(
            max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=64, kv_dtype="float8")))


def test_int8_pool_is_sized_from_its_own_bytes_per_token(weights, monkeypatch):
    """The automatic page count of a GPU executor divides the free device
    memory by the pool's bytes per token: int8 elements plus two fp32 scales
    per (layer, KV head), not the model dtype's."""
    from zhilight_tpu_torch.engine.engine import ModelExecutor

    _, _, tcfg, tp = weights
    per_int8 = 2 * 2 * 2 * 64 + 2 * 2 * 2 * 4      # layers * (K, V) * Hkv * (D + 4)
    per_fp32 = 2 * 2 * 2 * 64 * 4
    free = 1000 * per_fp32
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free, free))
    pages = {}
    for kvd in ("int8", "float32"):
        ecfg = TEngineConfig(
            max_model_len=4096,
            cache=TCacheConfig(page_size=4, kv_dtype=kvd, hbm_utilization=1.0, reserved_hbm_mb=0),
            scheduler=TSchedulerConfig(max_batch=64, chunk_size=8, prefill_buckets=(8,)))
        ex = ModelExecutor(tcfg, tp, ecfg, "cpu")
        assert ex._kv_bytes_per_token() == (per_int8 if kvd == "int8" else per_fp32)
        ex.device = torch.device("cuda")   # only the sizing rule reads it here
        pages[kvd] = ex._decide_num_pages()
    assert pages["float32"] == 1000 // 4
    assert pages["int8"] == (free // per_int8) // 4
