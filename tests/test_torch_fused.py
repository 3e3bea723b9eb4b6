"""Fused decode write + attend (``ZT_FUSED_KV=1``): the port against the JAX
package on the CPU, in fp32, from the same inputs.

Off the TPU the JAX model never takes its fused branch (it asks
``_use_pallas_decode`` / ``_use_pallas_mla``, true only on a TPU), and its
fused calls pass no ``interpret``. Where the JAX side must run its fused
kernel, two monkeypatches force it: the switch returns True and the Pallas
function is wrapped with ``interpret=True``. Every case that should run the
fused kernel shows on both sides that it did.

- **Kernels**: the plain ``paged_decode_attention_fused`` (two pools and the
  packed single pool) and ``paged_mla_decode_fused`` (latent pool) against the
  Pallas kernel in interpret mode, on tests/test_fused_decode_attention.py's
  inputs with a frozen slot (not written, attends to its new row), a context
  of 1 and an empty context with a valid slot (gives its new V row, not
  written): outputs within 1e-4 on every row, pools after the call bit-equal
  (latent: the first ``latent_dim`` columns of the reference's lane-padded
  pool); and against the port's own write-then-attend on the active rows.
- **Model**: one ``forward_decode`` step with ``DecodeMeta.fused`` on tiny
  models (slot-major at head_dim 16 and 80, MLA): logits within 1e-4 of the
  JAX model's forced fused branch, pools bit-equal.
- **Engine**: greedy tokens of the port's ``LLM`` built under ``ZT_FUSED_KV=1``
  equal the JAX ``LLM``'s with its fused route forced (dense slot-major,
  sliding window, MLA, MLA + MoE, prefix caching, beam search, swap
  preemption), the port's fused kernel called and its unfused decode never;
  and where the mode stays off (the packed head-major pool, an int8 pool, a
  latent pool under ``ZT_WINDOW_KV=1``, whose side-buffer windows come first)
  the fused kernel is never called and the tokens still equal the JAX
  engine's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_fused_decode_attention import _setup
from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import MLAConfig as JMLAConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config
from zhilight_tpu.config.model_config import MoEConfig as JMoEConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import paged as JP
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models import mla as JM
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.ops.pallas import paged_attention as JPA
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, MLAConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt_hf_config
from zhilight_tpu_torch.config.model_config import MoEConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.kvcache import paged as TP
from zhilight_tpu_torch.kvcache.allocator import PageAllocator
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models import mla as TM
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.ops.cuda import kv_write as W
from zhilight_tpu_torch.ops.cuda import paged_attention as PA
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
S = 16


def T(a):
    return torch.from_numpy(np.array(a))


def _edges(page_tables, context_lens, slots):
    """Slot 1 frozen (not written), slot 2 a context of 1 (only its new row),
    slot 3 an empty context with a valid slot (its new V row; not written)."""
    slots, context_lens = slots.copy(), context_lens.copy()
    slots[1] = -1
    context_lens[2] = 1
    slots[2] = page_tables[2, 0] * S
    context_lens[3] = 0
    return context_lens, slots


# ---------------------------------------------------------------------------
# kernels: plain versions against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("hkv", [2, 12])
def test_plain_fused_decode_matches_pallas(hkv, packed, window):
    q, k_pages, v_pages, k_new, v_new, tables, ctx, slots = _setup(B=6, Hq=hkv * 4, Hkv=hkv)
    ctx, slots = _edges(tables, ctx, slots)
    D = q.shape[-1]
    scale = 1.0 / np.sqrt(D)
    j_args = (jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots), jnp.asarray(tables),
              jnp.asarray(ctx), S, scale, window)
    t_args = (T(k_new), T(v_new), T(slots), T(tables), T(ctx), S, scale, window)
    if packed:
        pool = np.concatenate([k_pages, v_pages], -1)
        want, jk, _ = JPA.paged_decode_attention_fused(jnp.asarray(q), jnp.asarray(pool), None,
                                                       *j_args, interpret=True)
        t_pool = T(pool)[None]
        got = PA.paged_decode_attention_fused_plain(T(q), t_pool, None, *t_args)
        pools = [(t_pool[0], jk)]
    else:
        want, jk, jv = JPA.paged_decode_attention_fused(
            jnp.asarray(q), jnp.asarray(k_pages), jnp.asarray(v_pages), *j_args, interpret=True)
        tk, tv = T(k_pages)[None], T(v_pages)[None]
        got = PA.paged_decode_attention_fused_plain(T(q), tk, tv, *t_args)
        pools = [(tk[0], jk), (tv[0], jv)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for t_pool, j_pool in pools:
        assert np.array_equal(t_pool.numpy(), np.asarray(j_pool))

    # the port's own write-then-attend gives the same output where a row is
    # written and attended (frozen and empty slots differ by design)
    kp, vp = T(k_pages)[None], T(v_pages)[None]
    W.write_rows_pair_plain(kp, vp, T(k_new), T(v_new), T(np.where(ctx > 0, slots, -1)))
    ref = PA.paged_decode_attention_plain(T(q), kp, vp, T(tables), T(ctx), S, scale, window)
    active = (slots >= 0) & (ctx > 0)
    np.testing.assert_allclose(got.numpy()[active], ref.numpy()[active], rtol=RTOL, atol=ATOL)
    # frozen and empty slots attend to their new rows; the empty one is its V row
    np.testing.assert_allclose(got.numpy()[3], np.repeat(v_new[3], 4, axis=0), rtol=RTOL,
                               atol=ATOL)


# the CUDA kernel's edges on its 64-token grid, counting the new token: no
# pool token, a whole tile of pool tokens (64), one past it (65), and a
# window that starts mid-tile (ctx 90, window 40: tokens 50 to 88)
FUSED_EDGE_CTX = [1, 65, 66, 90]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("D", [16, 80])
def test_plain_fused_decode_at_the_kernel_edges_matches_pallas(D, packed, window):
    """Row 16's plain version at the CUDA kernel's split and tile edges (G 4,
    2 KV heads): outputs within 1e-4 of the Pallas kernel, pools bit-equal."""
    q, k_pages, v_pages, k_new, v_new, tables, ctx, slots = _setup(B=4, Hq=8, Hkv=2, D=D,
                                                                   seed=D + window)
    rng = np.random.RandomState(D)
    ctx = np.array(FUSED_EDGE_CTX, np.int32)
    tables = np.full_like(tables, -1)
    perm, o = rng.permutation(k_pages.shape[0] // S), 0
    for b, c in enumerate(ctx):
        n = -(-int(c) // S)
        tables[b, :n] = perm[o : o + n]
        o += n
    slots = np.array([tables[b, (c - 1) // S] * S + (c - 1) % S for b, c in enumerate(ctx)],
                     np.int32)
    scale = 1.0 / np.sqrt(D)
    j_args = (jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots), jnp.asarray(tables),
              jnp.asarray(ctx), S, scale, window)
    t_args = (T(k_new), T(v_new), T(slots), T(tables), T(ctx), S, scale, window)
    if packed:
        pool = np.concatenate([k_pages, v_pages], -1)
        want, jk, _ = JPA.paged_decode_attention_fused(jnp.asarray(q), jnp.asarray(pool), None,
                                                       *j_args, interpret=True)
        t_pool = T(pool)[None]
        got = PA.paged_decode_attention_fused_plain(T(q), t_pool, None, *t_args)
        pools = [(t_pool[0], jk)]
    else:
        want, jk, jv = JPA.paged_decode_attention_fused(
            jnp.asarray(q), jnp.asarray(k_pages), jnp.asarray(v_pages), *j_args, interpret=True)
        tk, tv = T(k_pages)[None], T(v_pages)[None]
        got = PA.paged_decode_attention_fused_plain(T(q), tk, tv, *t_args)
        pools = [(tk[0], jk), (tv[0], jv)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    for t_pool, j_pool in pools:
        assert np.array_equal(t_pool.numpy(), np.asarray(j_pool))


def _latent_inputs(edges):
    """tests/test_fused_decode_attention.py::test_fused_mla_latent's inputs: 4
    sequences, 8 heads, latent rows of 128 + 64 in a pool padded to 256."""
    rng = np.random.RandomState(7)
    B, H, lora, rope_d, P, maxp = 4, 8, 128, 64, 32, 6
    stored = ((lora + rope_d) + 127) // 128 * 128
    q_eff = rng.randn(B, H, lora + rope_d).astype(np.float32)
    pool = rng.randn(P * S, stored).astype(np.float32)
    latent_new = rng.randn(B, lora + rope_d).astype(np.float32)
    ctx = rng.randint(1, maxp * S, size=B).astype(np.int32)
    tables = np.full((B, maxp), -1, np.int32)
    used = set()
    for b in range(B):
        for i in range((ctx[b] + S - 1) // S):
            while True:
                p = rng.randint(0, P)
                if p not in used:
                    used.add(p)
                    break
            tables[b, i] = p
    slots = np.array([tables[b, (ctx[b] - 1) // S] * S + (ctx[b] - 1) % S for b in range(B)],
                     np.int32)
    if edges:
        ctx, slots = _edges(tables, ctx, slots)
    return q_eff, pool, latent_new, slots, tables, ctx, 1.0 / np.sqrt(lora + rope_d), lora


@pytest.mark.parametrize("edges", [False, True])
def test_plain_fused_latent_decode_matches_pallas(edges):
    q_eff, pool, latent_new, slots, tables, ctx, scale, v_dim = _latent_inputs(edges)
    L = latent_new.shape[1]
    want, j_pool = JPA.paged_mla_decode_fused(
        jnp.asarray(q_eff), jnp.asarray(pool), jnp.asarray(latent_new), jnp.asarray(slots),
        jnp.asarray(tables), jnp.asarray(ctx), S, scale, v_dim=v_dim, interpret=True)
    t_pool = T(pool[:, :L])[None]  # the port's pool is [1, N, latent_dim]
    got = PA.paged_mla_decode_fused_plain(T(q_eff), t_pool, T(latent_new), T(slots), T(tables),
                                          T(ctx), S, scale, v_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.array_equal(t_pool[0].numpy(), np.asarray(j_pool)[:, :L])


@pytest.mark.parametrize("ctx", [1, 16, 64, 65])
def test_plain_fused_latent_decode_at_tile_edges_matches_pallas(ctx):
    """The fused latent mode at a context (the new token included) of 1, a
    whole page, a whole 64-token tile and one token past, beside two other
    contexts: the new row written at row ctx - 1, the pools equal."""
    rng = np.random.RandomState(ctx)
    B, H, lora, rope_d, maxp = 3, 8, 128, 64, 6
    L = lora + rope_d
    ctx_b = np.array([ctx, 9, 50], np.int32)
    tables = rng.permutation(B * maxp).astype(np.int32).reshape(B, maxp)
    slots = np.array([tables[b, (c - 1) // S] * S + (c - 1) % S for b, c in enumerate(ctx_b)],
                     np.int32)
    q_eff = rng.randn(B, H, L).astype(np.float32)
    pool = rng.randn(B * maxp * S, L).astype(np.float32)
    latent_new = rng.randn(B, L).astype(np.float32)
    scale = 1.0 / np.sqrt(L)
    want, j_pool = JPA.paged_mla_decode_fused(
        jnp.asarray(q_eff), jnp.asarray(pool), jnp.asarray(latent_new), jnp.asarray(slots),
        jnp.asarray(tables), jnp.asarray(ctx_b), S, scale, v_dim=lora, interpret=True)
    t_pool = T(pool.copy())[None]
    got = PA.paged_mla_decode_fused(T(q_eff), t_pool, T(latent_new), T(slots), T(tables),
                                    T(ctx_b), S, scale, lora)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert np.array_equal(t_pool[0].numpy(), np.asarray(j_pool))


def test_fused_wrappers_take_the_plain_version_only_on_the_cpu():
    """CPU tensors run the plain version (no launch counted); a tensor on a
    device without a kernel raises instead of falling back."""
    q, k_pages, v_pages, k_new, v_new, tables, ctx, slots = _setup(B=2)
    args = (T(k_new), T(v_new), T(slots), T(tables), T(ctx), S, 0.125)
    before = PA.paged_decode_attention_fused.launches
    out = PA.paged_decode_attention_fused(T(q), T(k_pages), T(v_pages), *args)
    assert out.shape == q.shape and PA.paged_decode_attention_fused.launches == before
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(NotImplementedError, match="no kernel"):
        PA._launch_fused(meta, T(k_pages), T(v_pages), *args, 0)
    with pytest.raises(NotImplementedError, match="no kernel"):
        PA._launch_mla_fused(torch.empty(2, 4, 576, device="meta"), torch.zeros(64, 576),
                             torch.zeros(2, 576), T(slots), T(tables), T(ctx), S, 0.1, 512)


# ---------------------------------------------------------------------------
# model: one decode step with the fused flag against the JAX fused branch
# ---------------------------------------------------------------------------

def _force_jax_fused(monkeypatch, calls):
    """Make the JAX models take their fused decode branch on the CPU: the
    Pallas switches on, ZT_FUSED_KV=1, the fused kernels in interpret mode
    (counted in ``calls["jax"]``)."""
    monkeypatch.setenv("ZT_FUSED_KV", "1")
    monkeypatch.setattr(JL, "_use_pallas_decode", lambda *a, **kw: True)
    monkeypatch.setattr(JM, "_use_pallas_mla", lambda: True)
    inside = []  # the latent function calls the other one: count the outer call

    for name in ("paged_decode_attention_fused", "paged_mla_decode_fused"):
        fn = getattr(JPA, name)

        def interpret(*a, _fn=fn, **kw):
            calls["jax"] += not inside
            inside.append(1)
            try:
                return _fn(*a, **dict(kw, interpret=True))
            finally:
                inside.pop()

        monkeypatch.setattr(JPA, name, interpret)


def _spy(monkeypatch, module, name, calls, key):
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls[key] += 1
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)


def _spy_port(monkeypatch, calls):
    """Count the port's fused calls and its unfused decode calls."""
    for name in ("paged_decode_attention_fused", "paged_mla_decode_fused"):
        _spy(monkeypatch, PA, name, calls, "fused")
    for module, name in ((PA, "paged_decode_attention"), (PA, "paged_decode_attention_q"),
                         (A, "paged_decode_attention_hm"), (A, "paged_decode_attention_hm_q"),
                         (A, "paged_mla_decode"), (TM, "_mla_decode")):
        _spy(monkeypatch, module, name, calls, "unfused")


MB, MAXP_M = 4, 4
CTX_M = np.array([13, 16, 31, 3], np.int32)
TABLES_M = np.arange(MB * MAXP_M, dtype=np.int32).reshape(MB, MAXP_M)


def _slot_major_model(D):
    model = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=D,
                 num_kv_heads=2, dim_ff=128, vocab_size=64, dtype="float32")
    jcfg = JModelConfig(**model)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, ModelConfig(**model), params_to_torch(jax.device_get(jparams), "cpu")


def _mla_model():
    from test_torch_mla import deepseek_v2_cfg

    hf = deepseek_v2_cfg()
    jcfg = j_adapt_hf_config(hf).replace(dtype="float32")
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return (jcfg, jparams, t_adapt_hf_config(hf).replace(dtype="float32"),
            params_to_torch(jax.device_get(jparams), "cpu"))


def _random_caches(jcfg, rng):
    """The same random pools in both packages' layouts: slot-major [N, Hkv, D]
    (the port's [1, N, Hkv, D]) or latent (the reference pads rows to 128)."""
    N, L = MB * MAXP_M * S, jcfg.num_layers
    if jcfg.mla.enabled:
        lat = [rng.randn(N, jcfg.mla.latent_dim).astype(np.float32) for _ in range(L)]
        pad = -jcfg.mla.latent_dim % 128
        return (JP.KVCache(latent=tuple(jnp.asarray(np.pad(x, ((0, 0), (0, pad)))) for x in lat),
                           page_size=S),
                TP.KVCache(latent=[T(x)[None] for x in lat], page_size=S))
    Hkv, D = jcfg.num_kv_heads, jcfg.dim_head
    k = [rng.randn(N, Hkv, D).astype(np.float32) for _ in range(L)]
    v = [rng.randn(N, Hkv, D).astype(np.float32) for _ in range(L)]
    return (JP.KVCache(k=tuple(map(jnp.asarray, k)), v=tuple(map(jnp.asarray, v)), page_size=S),
            TP.KVCache(k=[T(x)[None] for x in k], v=[T(x)[None] for x in v], page_size=S))


def _pool_arrays(cache, latent_dim=0):
    """Every pool of a cache as numpy in the JAX package's layout; a JAX
    latent pool cut to its first ``latent_dim`` columns."""
    if isinstance(cache, JP.KVCache):
        if cache.latent is not None:
            return [np.asarray(a)[:, :latent_dim] for a in cache.latent]
        return [np.asarray(a) for a in cache.k + cache.v]
    return [a[0].numpy() for a in (cache.latent if cache.is_latent else cache.k + cache.v)]


@pytest.mark.parametrize("kind", ["slot_major_16", "slot_major_80", "mla"])
def test_fused_decode_step_matches_jax(kind, monkeypatch):
    """Logits within 1e-4 of JAX's. The pools: every row but the three written
    ones bit-equal to JAX's; the written rows within 1e-4 of JAX's (the rows
    come from fp32 projections and rope that round differently in the two
    frameworks, by up to 2e-6 here) and, in layer 0, whose inputs are the
    same on both paths, bit-equal to what the port's unfused step writes."""
    calls = dict(jax=0, fused=0, unfused=0)
    _force_jax_fused(monkeypatch, calls)
    jcfg, jparams, tcfg, tparams = (_mla_model() if kind == "mla"
                                    else _slot_major_model(int(kind.rsplit("_", 1)[1])))
    jcache, tcache = _random_caches(jcfg, np.random.RandomState(0))
    _, unfused_cache = _random_caches(jcfg, np.random.RandomState(0))
    assert not tcache.packed
    pos = CTX_M
    slots = TABLES_M[np.arange(MB), pos // S] * S + pos % S
    slots[2] = -1  # a frozen slot: not written, attends to its new row
    arrays = (pos, slots.astype(np.int32), TABLES_M, pos + 1)
    tokens = np.array([5, 7, 11, 13], np.int32)
    jl, jcache = JL.forward_decode(jparams, jcfg, JL.build_rope(jcfg), jnp.asarray(tokens),
                                   JDecodeMeta(*map(jnp.asarray, arrays)), jcache)
    rope = TL.build_rope(tcfg)
    with torch.no_grad():
        TL.forward_decode(tparams, tcfg, rope, T(tokens), TDecodeMeta(*map(T, arrays)),
                          unfused_cache)
        _spy_port(monkeypatch, calls)
        tl, tcache = TL.forward_decode(tparams, tcfg, rope, T(tokens),
                                       TDecodeMeta(*map(T, arrays), fused=True), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    written = slots[slots >= 0]
    kept = np.setdiff1d(np.arange(MB * MAXP_M * S), written)
    latent_dim = tcfg.mla.latent_dim if kind == "mla" else 0
    for i, (got, want, unfused) in enumerate(zip(_pool_arrays(tcache),
                                                 _pool_arrays(jcache, latent_dim),
                                                 _pool_arrays(unfused_cache))):
        assert np.array_equal(got[kept], want[kept])
        np.testing.assert_allclose(got[written], want[written], rtol=RTOL, atol=ATOL)
        if i % jcfg.num_layers == 0:  # layer 0's rows come from the same inputs
            assert np.array_equal(got, unfused)
    assert calls == dict(jax=jcfg.num_layers, fused=jcfg.num_layers, unfused=0), calls


# ---------------------------------------------------------------------------
# engine: greedy tokens with ZT_FUSED_KV=1
# ---------------------------------------------------------------------------

VOCAB, EOS = 64, 1
SLOT_MAJOR = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=16,
                  num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
MLA_TINY = dict(model_type="deepseek_v2", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
                num_kv_heads=4, dim_ff=64, vocab_size=VOCAB, dtype="float32",
                mla=dict(q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
                         qk_rope_head_dim=4, v_head_dim=8))
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)
_rng = np.random.RandomState(11)
PREFIX = list(_rng.randint(2, VOCAB, size=24))
PROMPTS = [list(_rng.randint(2, VOCAB, size=n)) for n in (5, 13, 21)]
SWAP_PROMPTS = [list(_rng.randint(2, VOCAB, size=7)) for _ in range(2)]
SWAP_SCHED = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                  ignore_eos=True, session_ttl=0.0)

# name -> model, cache, scheduler, rounds of prompts, request arguments; the
# port's scheduler and pool where they differ from the JAX engine's
FUSED_CASES = {
    "slot_major": dict(model=SLOT_MAJOR, arg=dict(max_length=10)),
    "sliding_window": dict(model=dict(SLOT_MAJOR, model_type="mistral", sliding_window=8),
                           arg=dict(max_length=12)),
    "mla": dict(model=MLA_TINY, arg=dict(max_length=10)),
    "mla_moe": dict(model=dict(MLA_TINY, moe=dict(num_experts=4, top_k=2, intermediate_size=16,
                                                  shared_expert_intermediate_size=16,
                                                  first_k_dense_replace=1)),
                    arg=dict(max_length=10)),
    "prefix_caching": dict(model=SLOT_MAJOR, cache=dict(enable_prefix_caching=True),
                           rounds=[[PREFIX + [7, 9, 11]], [PREFIX + [13, 2, 5, 8], PREFIX + [30]]],
                           arg=dict(max_length=8)),
    "beam": dict(model=SLOT_MAJOR, rounds=[PROMPTS[1:2]],
                 arg=dict(max_length=8, beam_size=3, num_results=2)),
    # 8 pages x 4 rows for two requests that need 54: the port swaps the newer
    # one out and back; the JAX engine, admitting pessimistically, never does
    "swap": dict(model=SLOT_MAJOR, rounds=[SWAP_PROMPTS], arg=dict(max_length=20),
                 sched=dict(SWAP_SCHED, admission_reserve=1.0),
                 t_sched=dict(SWAP_SCHED, admission_reserve=0.2, preempt_mode="swap"),
                 t_cache=dict(num_pages=8)),
}
OFF_CASES = {
    "packed_pool": dict(model=dict(SLOT_MAJOR, dim_head=64), arg=dict(max_length=10)),
    "int8_pool": dict(model=SLOT_MAJOR, cache=dict(kv_dtype="int8"), arg=dict(max_length=10)),
    # every decode window takes the side buffers (2 to page_size steps)
    "latent_pool_window_kv": dict(model=MLA_TINY, cache=dict(page_size=16, num_pages=16),
                                  window_kv=True, arg=dict(max_length=10)),
}


def _configs(model):
    model = dict(model)
    mla, moe = model.pop("mla", None), model.pop("moe", None)
    jcfg = JModelConfig(**model, **({"mla": JMLAConfig(**mla)} if mla else {}),
                        **({"moe": JMoEConfig(**moe)} if moe else {}))
    tcfg = ModelConfig(**model, **({"mla": MLAConfig(**mla)} if mla else {}),
                       **({"moe": MoEConfig(**moe)} if moe else {}))
    return jcfg, tcfg


def _serve(llm, gen_cls, arg_cls, rounds, arg):
    out = []
    with gen_cls(llm) as gen:
        for prompts in rounds:
            for r in gen.batch_generate(prompts, [arg_cls(**arg) for _ in prompts], timeout=300):
                out.append([(o.token_ids, o.score) for o in r.outputs])
        preempted = getattr(gen.scheduler, "num_preemptions", 0)
    return out, preempted


def _serve_both(spec, monkeypatch, force_jax: bool):
    calls = dict(jax=0, fused=0, unfused=0)
    jcfg, tcfg = _configs(spec["model"])
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    cache = dict(dict(page_size=4, num_pages=64), **spec.get("cache", {}))
    sched = spec.get("sched", SCHED)
    rounds = spec.get("rounds", [PROMPTS])
    with monkeypatch.context() as m:
        if force_jax:
            _force_jax_fused(m, calls)
        else:
            m.setenv("ZT_FUSED_KV", "1")
        if spec.get("window_kv"):
            m.setenv("ZT_WINDOW_KV", "1")
            m.setenv("ZT_PALLAS_INTERPRET", "1")
        jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
            max_model_len=64, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**sched)))
        want, _ = _serve(jllm, JGenerator, JGeneratorArg, rounds, spec["arg"])
    hits = []
    match = PageAllocator.match_prefix

    def spy_match(self, tokens):
        pages, cached = match(self, tokens)
        hits.append(cached)
        return pages, cached

    with monkeypatch.context() as m:
        m.setattr(PageAllocator, "match_prefix", spy_match)
        _spy_port(m, calls)
        m.setenv("ZT_FUSED_KV", "1")
        if spec.get("window_kv"):
            m.setenv("ZT_WINDOW_KV", "1")
        tllm = LLM(model_config=tcfg, params=params_to_torch(jax.device_get(jparams), "cpu"),
                   device="cpu", engine_config=EngineConfig(
                       max_model_len=64, cache=CacheConfig(**dict(cache, **spec.get("t_cache", {}))),
                       scheduler=SchedulerConfig(**spec.get("t_sched", sched))))
        assert tllm.executor.fused_kv
        got, preempted = _serve(tllm, DynamicBatchGenerator, GeneratorArg, rounds, spec["arg"])
    return got, want, calls, dict(hits=hits, preempted=preempted)


def _assert_same(got, want, int8=False):
    """Identical tokens; scores within 1e-3 (fp32 sums in another order), over
    an int8 pool within 1e-2 of their size (tests/test_torch_engine_parity.py:
    off the TPU the JAX engine rounds dequantized rows to bf16)."""
    tol = (lambda w: 1e-2 * max(1.0, abs(w))) if int8 else (lambda w: 1e-3)
    assert len(got) == len(want) > 0
    for g_outs, w_outs in zip(got, want):
        assert [t for t, _ in g_outs] == [t for t, _ in w_outs]
        assert all(abs(gs - ws) < tol(ws) for (_, gs), (_, ws) in zip(g_outs, w_outs))
    assert any(len(t) > 1 for outs in got for t, _ in outs)


@pytest.mark.parametrize("name", list(FUSED_CASES))
def test_engine_fused_tokens_match_jax(name, monkeypatch):
    spec = FUSED_CASES[name]
    got, want, calls, seen = _serve_both(spec, monkeypatch, force_jax=True)
    _assert_same(got, want)
    assert calls["jax"] > 0, "the JAX engine never took its fused branch"
    assert calls["fused"] > 0 and calls["unfused"] == 0, calls
    if name == "prefix_caching":
        assert max(seen["hits"]) >= 24 - 4, "the second round never hit the prefix cache"
    if name == "swap":
        assert seen["preempted"] >= 1, "pool pressure never triggered a preemption"
        assert all(len(outs[0][0]) == 20 for outs in got)
    if name == "beam":
        assert len(got[0]) == 2


@pytest.mark.parametrize("name", list(OFF_CASES))
def test_engine_fused_mode_stays_off(name, monkeypatch):
    spec = OFF_CASES[name]
    got, want, calls, _ = _serve_both(spec, monkeypatch, force_jax=False)
    _assert_same(got, want, int8=spec.get("cache", {}).get("kv_dtype") == "int8")
    assert calls["fused"] == 0 and calls["jax"] == 0, calls
