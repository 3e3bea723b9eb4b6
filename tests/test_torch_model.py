"""The port's dense model (zhilight_tpu_torch.models.llama) against the JAX
reference (zhilight_tpu.models.llama) on the CPU, in fp32, with the same
weights (carried across by zhilight_tpu_torch.utils.convert).

Tiny configurations with head_dim 64, so both packages hold the packed
head-major pool (2*head_dim % 128 == 0): a MiniCPM ("cpm_dragonfly": scale_emb,
depth-scaled residual, dim_model_base logits, tied head) and a GQA llama with
llama3 rope. Prefill chunks (the second one starts mid-page), a packed group
and a decode step are compared on logits and on the pool contents.
Tolerance: fp32 rtol = atol = 1e-4 (both sides compute in fp32; only the
order of sums differs).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import RopeConfig as JRopeConfig
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PackedPrefillMeta as JPackedPrefillMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import RopeConfig as TRopeConfig
from zhilight_tpu_torch.kvcache import new_kv_cache as t_new_kv_cache
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.models.base import PackedPrefillMeta as TPackedPrefillMeta
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
S = 4        # page size
PAGES = 24   # pool pages
MAXP = 12    # page-table width

COMMON = dict(num_layers=2, dim_model=64, num_heads=4, dim_head=64, dim_ff=128,
              vocab_size=101, dtype="float32")
CONFIGS = {
    "cpm_dragonfly": dict(model_type="cpm_dragonfly", num_kv_heads=4, scale_emb=12.0,
                          scale_depth=1.4, dim_model_base=16, tie_lm_head=True),
    "llama_gqa": dict(model_type="llama", num_kv_heads=2, rope="llama3"),
}


def _configs(name):
    kw = dict(COMMON, **CONFIGS[name])
    rope = kw.pop("rope", None)
    jkw, tkw = dict(kw), dict(kw)
    if rope == "llama3":
        r = dict(type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                 original_max_position=64)
        jkw["rope"], tkw["rope"] = JRopeConfig(**r), TRopeConfig(**r)
    return JModelConfig(**jkw), TModelConfig(**tkw)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    jcfg, tcfg = _configs(request.param)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = params_to_torch(jax.device_get(jparams), "cpu")
    return jcfg, jparams, JL.build_rope(jcfg), tcfg, tparams, TL.build_rope(tcfg)


def _caches(jcfg, tcfg):
    j = j_new_kv_cache(jcfg.num_layers, PAGES, S, jcfg.num_kv_heads, jcfg.dim_head, jnp.float32)
    t = t_new_kv_cache(tcfg.num_layers, PAGES, S, tcfg.num_kv_heads, tcfg.dim_head,
                       torch.float32, device="cpu")
    return j, t


def _prefill_metas(positions, slots, table, cache_len, q_len):
    j = JPrefillMeta(jnp.asarray(positions), jnp.asarray(slots), jnp.asarray(table),
                     jnp.int32(cache_len), jnp.int32(q_len))
    t = TPrefillMeta(torch.from_numpy(positions), torch.from_numpy(slots),
                     torch.from_numpy(table), torch.tensor(cache_len, dtype=torch.int32),
                     torch.tensor(q_len, dtype=torch.int32))
    return j, t


def _chunk(table, start, n, bucket):
    pos = np.zeros(bucket, np.int32)
    pos[:n] = np.arange(start, start + n)
    slots = np.full(bucket, -1, np.int32)
    p = np.arange(start, start + n)
    slots[:n] = table[p // S] * S + p % S
    return pos, slots


def _assert_pools(jcache, tcache):
    for layer in range(len(tcache.k)):
        np.testing.assert_allclose(
            tcache.k[layer].numpy(), np.asarray(jcache.k[layer]), rtol=RTOL, atol=ATOL
        )


def _prompt(rng, jcfg, n):
    return rng.randint(2, jcfg.vocab_size, size=n).astype(np.int32)


def test_prefill_chunks_match_jax(model):
    """Two chunks of one sequence through a shuffled page table; the second
    starts mid-page (cache_len 13, page size 4)."""
    jcfg, jp, jrope, tcfg, tp, trope = model
    rng = np.random.RandomState(1)
    jcache, tcache = _caches(jcfg, tcfg)
    table = np.full(MAXP, -1, np.int32)
    table[:6] = rng.permutation(PAGES)[:6]
    prompt = _prompt(rng, jcfg, 22)
    start = 0
    for n in (13, 9):
        pos, slots = _chunk(table, start, n, 16)
        toks = np.zeros(16, np.int32)
        toks[:n] = prompt[start : start + n]
        jm, tm = _prefill_metas(pos, slots, table, start, n)
        jl, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache)
        tl, tcache = TL.forward_prefill(tp, tcfg, trope, torch.from_numpy(toks), tm, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        start += n
    _assert_pools(jcache, tcache)


def test_packed_prefill_matches_jax(model):
    """Two segments (one with cached context) and an empty padded segment."""
    jcfg, jp, jrope, tcfg, tp, trope = model
    rng = np.random.RandomState(2)
    jcache, tcache = _caches(jcfg, tcfg)
    perm = rng.permutation(PAGES)
    tables = np.full((3, MAXP), -1, np.int32)
    tables[0, :3] = perm[:3]
    tables[1, :5] = perm[3:8]
    # segment 1 has 6 tokens already cached: write them first
    ctx1 = _prompt(rng, jcfg, 6)
    pos, slots = _chunk(tables[1], 0, 6, 8)
    toks = np.zeros(8, np.int32)
    toks[:6] = ctx1
    jm, tm = _prefill_metas(pos, slots, tables[1], 0, 6)
    _, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache)
    _, tcache = TL.forward_prefill(tp, tcfg, trope, torch.from_numpy(toks), tm, tcache)

    TC = 16
    cache_lens = np.array([0, 6, 0], np.int32)
    q_lens = np.array([10, 13, 0], np.int32)
    tokens = np.zeros(3 * TC, np.int32)
    positions = np.zeros(3 * TC, np.int32)
    slot_map = np.full(3 * TC, -1, np.int32)
    for s in range(2):
        n, c = q_lens[s], cache_lens[s]
        tokens[s * TC : s * TC + n] = _prompt(rng, jcfg, n)
        positions[s * TC : s * TC + TC], slot_map[s * TC : s * TC + TC] = _chunk(tables[s], c, n, TC)
    jm = JPackedPrefillMeta(*(jnp.asarray(a) for a in (positions, slot_map, tables, cache_lens, q_lens)))
    tm = TPackedPrefillMeta(*(torch.from_numpy(a) for a in (positions, slot_map, tables, cache_lens, q_lens)))
    jl, jcache = JL.forward_prefill_packed(jp, jcfg, jrope, jnp.asarray(tokens), jm, jcache)
    tl, tcache = TL.forward_prefill_packed(tp, tcfg, trope, torch.from_numpy(tokens), tm, tcache)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=RTOL, atol=ATOL)
    _assert_pools(jcache, tcache)


def test_decode_step_matches_jax(model):
    """A decode step over three slots after their prefills, one slot idle."""
    jcfg, jp, jrope, tcfg, tp, trope = model
    rng = np.random.RandomState(3)
    jcache, tcache = _caches(jcfg, tcfg)
    perm = rng.permutation(PAGES)
    B = 3
    lens = [9, 14, 0]
    tables = np.full((B, MAXP), -1, np.int32)
    for b, n in enumerate(lens):
        if n:
            tables[b, :5] = perm[5 * b : 5 * b + 5]
            pos, slots = _chunk(tables[b], 0, n, 16)
            toks = np.zeros(16, np.int32)
            toks[:n] = _prompt(rng, jcfg, n)
            jm, tm = _prefill_metas(pos, slots, tables[b], 0, n)
            _, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache)
            _, tcache = TL.forward_prefill(tp, tcfg, trope, torch.from_numpy(toks), tm, tcache)
    positions = np.array([9, 14, 0], np.int32)
    slot_map = np.array([tables[0, 9 // S] * S + 9 % S, tables[1, 14 // S] * S + 14 % S, -1], np.int32)
    context_lens = np.array([10, 15, 0], np.int32)
    tokens = _prompt(rng, jcfg, B)
    jm = JDecodeMeta(*(jnp.asarray(a) for a in (positions, slot_map, tables, context_lens)))
    tm = TDecodeMeta(*(torch.from_numpy(a) for a in (positions, slot_map, tables, context_lens)))
    jl, jcache = JL.forward_decode(jp, jcfg, jrope, jnp.asarray(tokens), jm, jcache)
    tl, tcache = TL.forward_decode(tp, tcfg, trope, torch.from_numpy(tokens), tm, tcache)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], rtol=RTOL, atol=ATOL)
    _assert_pools(jcache, tcache)
