"""The port's MLA path against the JAX package on the CPU, in fp32, from the
same weights: the latent cache, the plain latent decode against the Pallas
kernel (interpret mode), ``mla_attention_layer`` (prefill chunks, a packed
group, a decode step; with and without ``q_lora_rank``), whole-model logits
for the DeepSeek-V2-Lite, q-lora and V3-style cases of
tests/test_deepseek_parity.py (MLA + MoE), and the serving stack (``LLM`` +
``DynamicBatchGenerator``: greedy tokens, beam search, swap preemption on the
latent pool) against the JAX engine.

The JAX package pads a latent row to a multiple of 128 lanes; the port
stores ``latent_dim`` elements, so pools are compared on their first
``latent_dim`` columns. Tolerance: fp32 rtol = atol = 1e-4 (sums in another
order); tokens identical.
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
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import paged as JP
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models import mla as JM
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PackedPrefillMeta as JPackedPrefillMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.ops.pallas.paged_attention import paged_mla_decode as j_paged_mla_decode
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, MLAConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt_hf_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.kvcache import paged as TP
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models import mla as TM
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.models.base import PackedPrefillMeta as TPackedPrefillMeta
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.ops.cuda import attn_headmajor as A
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
S = 4        # page size
PAGES = 24   # pool pages
MAXP = 12    # page-table width
T = torch.from_numpy


def deepseek_v2_cfg(**kw):
    """tests/test_deepseek_parity.py's tiny DeepSeek-V2 HF config."""
    base = dict(
        model_type="deepseek_v2", num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
        num_key_value_heads=4, intermediate_size=96, moe_intermediate_size=48, vocab_size=128,
        rms_norm_eps=1e-6, max_position_embeddings=256, rope_theta=10000.0,
        torch_dtype="float32", hidden_act="silu", tie_word_embeddings=False,
        q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, qk_head_dim=24,
        n_routed_experts=4, n_shared_experts=1, num_experts_per_tok=2,
        routed_scaling_factor=1.0, n_group=2, topk_group=1,
        topk_method="group_limited_greedy", scoring_func="softmax", norm_topk_prob=False,
        first_k_dense_replace=1, moe_layer_freq=1, attention_bias=False,
    )
    base.update(kw)
    return base


CASES = {
    "v2-lite-style": dict(),
    "v2-qlora": dict(q_lora_rank=24),
    "v3-style": dict(model_type="deepseek_v3", q_lora_rank=24, topk_method="noaux_tc",
                     scoring_func="sigmoid", norm_topk_prob=True, routed_scaling_factor=2.5),
    # DeepSeek's YaRN: the softmax scale carries mscale_all_dim
    "v2-yarn": dict(rope_scaling=dict(type="yarn", factor=40.0, beta_fast=32, beta_slow=1,
                                      mscale=0.707, mscale_all_dim=0.707,
                                      original_max_position_embeddings=64)),
}


# ---------------------------------------------------------------------------
# the latent cache
# ---------------------------------------------------------------------------

def test_latent_cache_write_and_gather_match_jax():
    rng = np.random.RandomState(0)
    L, latent_dim = 2, 20
    jcache = JP.new_latent_cache(L, PAGES, S, latent_dim, jnp.float32)
    tcache = TP.new_latent_cache(L, PAGES, S, latent_dim, torch.float32, device="cpu")
    assert tcache.is_latent and not tcache.quantized
    assert (tcache.num_layers, tcache.num_slots, tcache.num_pages) == (L, PAGES * S, PAGES)
    # every array of the cache keeps its slots on dim 1
    assert [a.shape for arrays in tcache.arrays() for a in arrays] == [(1, PAGES * S, latent_dim)] * L
    rows = rng.randn(9, latent_dim).astype(np.float32)
    slots = rng.permutation(PAGES * S)[:9].astype(np.int32)
    slots[4] = -1
    jcache = JP.write_latent(jcache, 1, jnp.asarray(rows), jnp.asarray(slots))
    assert TP.write_latent(tcache, 1, T(rows), T(slots)) is tcache
    for layer in range(L):
        np.testing.assert_array_equal(tcache.latent[layer][0].numpy(),
                                      np.asarray(jcache.latent[layer])[:, :latent_dim])
    pages = np.array([[3, 7, -1], [0, 1, 2]], np.int32)
    np.testing.assert_array_equal(
        TP.gather_latent(tcache, 1, T(pages)).numpy(),
        np.asarray(JP.gather_latent(jcache, 1, jnp.asarray(pages)))[..., :latent_dim])


def test_softmax_scale_matches_jax():
    for case in CASES.values():
        hf = deepseek_v2_cfg(**case)
        assert TM.mla_softmax_scale(t_adapt_hf_config(hf)) == JM.mla_softmax_scale(j_adapt_hf_config(hf))


# ---------------------------------------------------------------------------
# the latent decode: plain version vs the Pallas kernel and the absorbed path
# ---------------------------------------------------------------------------

def _latent_decode_inputs():
    """tests/test_deepseek_parity.py::test_mla_pallas_decode_matches_jnp's inputs."""
    rng = np.random.RandomState(0)
    B, H, lora, rope_d, PS, MP = 3, 4, 128, 64, 16, 4
    stored = ((lora + rope_d) + 127) // 128 * 128
    N = B * MP * PS
    pool = rng.randn(N, stored).astype(np.float32)
    pool[:, lora + rope_d :] = 0.0  # the pad lanes, as write_latent leaves them
    q_nope = rng.randn(B, H, 96).astype(np.float32)
    q_pe = rng.randn(B, H, rope_d).astype(np.float32)
    w_uk = (rng.randn(lora, H, 96) * 0.1).astype(np.float32)
    w_uv = (rng.randn(lora, H, 64) * 0.1).astype(np.float32)
    ctx = rng.randint(1, MP * PS, size=B).astype(np.int32)
    tables = np.stack([b * MP + np.arange(MP) for b in range(B)]).astype(np.int32)
    return pool, q_nope, q_pe, w_uk, w_uv, ctx, tables, PS, lora, rope_d


@pytest.mark.parametrize("empty_slot", [False, True])
def test_plain_latent_decode_matches_pallas(empty_slot):
    pool, q_nope, q_pe, w_uk, _, ctx, tables, PS, lora, rope_d = _latent_decode_inputs()
    if empty_slot:
        ctx[1] = 0
    scale = 0.11
    q_eff = np.concatenate([np.einsum("bhn,lhn->bhl", q_nope, w_uk), q_pe], -1).astype(np.float32)
    want = j_paged_mla_decode(jnp.asarray(q_eff), jnp.asarray(pool), jnp.asarray(tables),
                              jnp.asarray(ctx), PS, scale, v_dim=lora, interpret=True)
    # the port's pool stores latent_dim columns, no lane padding
    tpool = T(np.ascontiguousarray(pool[:, : lora + rope_d]))
    got = A.paged_mla_decode(T(q_eff), tpool, T(tables), T(ctx), PS, scale, v_dim=lora)
    assert got.shape == (3, 4, lora)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if empty_slot:
        assert not got[1].any()
    # the head-major entry point's latent mode is the same function
    hm = A.paged_decode_attention_hm(T(q_eff), tpool[None], T(tables), T(ctx), PS, scale, v_dim=lora)
    assert torch.equal(hm, got)
    # a padded pool (the reference's stored width) gives the same rows
    padded = A.paged_mla_decode_plain(T(q_eff), T(pool), T(tables), T(ctx), PS, scale, lora)
    assert torch.equal(padded, got)


TWIN_TOL = 2.0 ** -8


@pytest.mark.parametrize("seed,v6", [(0, False), (2, False), (0, True)])
def test_latent_decode_twin_matches_pallas_on_bf16(seed, v6):
    """paged_mla_decode_twin (the unnormalized p rounded to bf16 before P.V,
    the division by l last) against the Pallas latent decode on bf16 inputs:
    within 2^-8 of its size. The plain version, which rounds the normalized
    probabilities as the XLA path does, is further off, and at seed 0 outside
    the bound (on unit-variance latents and on V columns near 6)."""
    rng = np.random.RandomState(seed)
    B, H, lora, rope_d, PS, MP = 3, 4, 128, 64, 16, 4
    stored = 256  # the reference's lane-padded row
    pool = rng.randn(B * MP * PS, stored).astype(np.float32)
    pool[:, lora + rope_d :] = 0.0
    if v6:  # V columns in [4.5, 7.5): outputs in [4, 8)
        pool[:, :lora] = 6 + 1.5 * (2 * rng.rand(B * MP * PS, lora) - 1)
    q = rng.randn(B, H, lora + rope_d).astype(np.float32)
    ctx = rng.randint(1, MP * PS, size=B).astype(np.int32)
    tables = np.stack([b * MP + np.arange(MP) for b in range(B)]).astype(np.int32)
    qb, pb = jnp.asarray(q, jnp.bfloat16), jnp.asarray(pool, jnp.bfloat16)
    want = np.asarray(j_paged_mla_decode(qb, pb, jnp.asarray(tables), jnp.asarray(ctx), PS, 0.11,
                                         v_dim=lora, interpret=True).astype(jnp.float32))
    tq = T(np.array(qb.astype(jnp.float32))).bfloat16()
    tp = T(np.ascontiguousarray(np.asarray(pb.astype(jnp.float32))[:, : lora + rope_d])).bfloat16()
    args = (tq, tp, T(tables), T(ctx), PS, 0.11, lora)
    top = np.abs(want).max()
    twin = np.abs(A.paged_mla_decode_twin(*args).float().numpy() - want).max() / top
    plain = np.abs(A.paged_mla_decode_plain(*args).float().numpy() - want).max() / top
    assert twin <= TWIN_TOL and twin <= plain
    if seed == 0:
        assert plain > TWIN_TOL


@pytest.mark.parametrize("splits", [2, 4, 8, 16])
def test_latent_decode_twin_at_a_split_count_stays_near_the_one_max_twin(splits):
    """paged_mla_decode_twin at ``splits`` context splits (p rounded against
    the running max the CUDA kernel keeps at that count) against the one-max
    twin (held to the Pallas kernel above), fp32 out, on V columns near 6:
    each rounds every p within 2^-9 of itself, which moves an output of
    positive V by at most 2^-9 of it, so the two differ by at most 2^-8 of
    the output's size; they do differ."""
    rng = np.random.RandomState(splits)
    B, H, PS, MP = 4, 16, 16, 64
    pool = rng.randn(B * MP * PS, 576).astype(np.float32)
    pool[:, :512] = 6 + 1.5 * (2 * rng.rand(B * MP * PS, 512) - 1)
    q = T(rng.randn(B, H, 576).astype(np.float32))
    ctx = T(np.array([MP * PS, 700, 65, 1], np.int32))
    tables = T(np.stack([b * MP + np.arange(MP) for b in range(B)]).astype(np.int32))
    args = (q, T(pool).bfloat16(), tables, ctx, PS, 1.0 / np.sqrt(192), 512)
    one_max = A.paged_mla_decode_twin(*args)
    split = A.paged_mla_decode_twin(*args, splits)
    assert one_max.dtype == split.dtype == torch.float32
    gap = (split - one_max).abs().max().item()
    assert 0 < gap <= 2.0 ** -8 * one_max.abs().max().item()
    # one token: p = 1 exactly at any split count
    assert torch.equal(split[3], one_max[3])


@pytest.mark.parametrize("B,H,ctx", [(8, 16, 2816), (1, 16, 2816), (8, 128, 2816), (8, 16, 40),
                                     (64, 16, 2816)])
def test_latent_decode_split_plan_fills_one_wave(B, H, ctx):
    """The latent kernel's split count (mla_splits over its blocks of 16
    heads): a power of two up to 16, no more than the context's 64-token
    tiles (so no 16-token run is empty but the last ones), every block on
    the card at once, and a cluster per (sequence, head tile) that the card
    holds at once: on H100 counts and on a card with one cluster of 16 fewer."""
    blocks = B * -(-H // 16)
    for capacity, clusters in ((132, {2: 66, 4: 30, 8: 16, 16: 8}),
                               (132, {2: 66, 4: 30, 8: 14, 16: 7}), (264, {2: 132, 4: 60})):
        splits = A.mla_splits(B, H, ctx, capacity, clusters)
        assert splits in (1, 2, 4, 8, 16) and splits <= -(-ctx // 64)
        assert splits * blocks <= max(capacity, blocks)
        assert splits == 1 or clusters[splits] >= blocks
        # the kernel's runs: a multiple of 16 tokens, as many non-empty ones as splits at most
        per = -(-max(-(-ctx // splits), 1) // 16) * 16
        assert per % 16 == 0 and -(-ctx // per) <= splits
    assert A.mla_splits(8, 16, 2816, 132, {2: 66, 4: 30, 8: 16, 16: 8}) == 16
    assert A.mla_splits(8, 16, 2816, 132, {2: 66, 4: 30, 8: 16, 16: 7}) == 8


def test_absorbed_decode_matches_jax():
    pool, q_nope, q_pe, w_uk, w_uv, ctx, tables, PS, lora, rope_d = _latent_decode_inputs()

    class m:
        kv_lora_rank, qk_rope_head_dim = lora, rope_d

    jctx = JP.gather_latent(JP.KVCache(latent=(jnp.asarray(pool),), page_size=PS), 0,
                            jnp.asarray(tables))
    want = JM._mla_decode(*(jnp.asarray(a) for a in (q_nope, q_pe)), jctx, jnp.asarray(w_uk),
                          jnp.asarray(w_uv), jnp.asarray(ctx), 0.11, m)
    tcache = TP.KVCache(latent=[T(pool)[None]], page_size=PS)
    got = TM._mla_decode(T(q_nope), T(q_pe), TP.gather_latent(tcache, 0, T(tables)), T(w_uk),
                         T(w_uv), T(ctx), 0.11, m)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(TM._q_eff(T(q_nope), T(q_pe), T(w_uk)).numpy(),
                               np.asarray(JM._q_eff(jnp.asarray(q_nope), jnp.asarray(q_pe),
                                                    jnp.asarray(w_uk))), rtol=RTOL, atol=ATOL)


def test_emit_partial_and_side_rows_raise():
    """The latent decode, normal and partial (held to the Pallas kernel in
    tests/test_torch_window.py), takes its plain version only on the CPU: on
    the meta device it raises."""
    pool, q_nope, q_pe, w_uk, _, ctx, tables, PS, lora, _ = _latent_decode_inputs()
    q_eff = torch.zeros(3, 4, 192)
    m, l, acc = A.paged_mla_decode(q_eff, T(pool), T(tables), T(ctx), PS, 0.1, v_dim=lora,
                                   emit_partial=True)
    assert m.shape == l.shape == (3, 4) and acc.shape == (3, 4, lora)
    for partial in (False, True):
        with pytest.raises(NotImplementedError):
            A.paged_mla_decode(q_eff.to("meta"), T(pool).to("meta"), T(tables).to("meta"),
                               T(ctx).to("meta"), PS, 0.1, v_dim=lora, emit_partial=partial)


# ---------------------------------------------------------------------------
# mla_attention_layer and the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    hf = deepseek_v2_cfg(**CASES[request.param])
    jcfg = j_adapt_hf_config(hf).replace(dtype="float32")
    tcfg = t_adapt_hf_config(hf).replace(dtype="float32")
    assert tcfg.mla.enabled and tcfg.moe.enabled and tcfg == t_adapt_hf_config(hf).replace(dtype="float32")
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    if tcfg.moe.topk_method == "noaux_tc":
        # a correction bias that changes the choice of experts
        bias = np.random.RandomState(5).randn(tcfg.moe.num_experts).astype(np.float32) * 0.3
        for i in range(jcfg.num_layers):
            if jcfg.is_moe_layer(i):
                jparams["layers"][str(i)]["mlp"]["router"]["e_score_correction_bias"] = jnp.asarray(bias)
    tparams = params_to_torch(jax.device_get(jparams), "cpu")
    return jcfg, jparams, JL.build_rope(jcfg), tcfg, tparams, TL.build_rope(tcfg)


def _caches(jcfg, tcfg):
    j = JP.new_latent_cache(jcfg.num_layers, PAGES, S, jcfg.mla.latent_dim, jnp.float32)
    t = TP.new_latent_cache(tcfg.num_layers, PAGES, S, tcfg.mla.latent_dim, torch.float32, device="cpu")
    return j, t


def _assert_pools(jcache, tcache):
    for layer in range(tcache.num_layers):
        width = tcache.latent[layer].shape[-1]
        np.testing.assert_allclose(tcache.latent[layer][0].numpy(),
                                   np.asarray(jcache.latent[layer])[:, :width], rtol=RTOL, atol=ATOL)


def _prefill_metas(positions, slots, table, cache_len, q_len):
    j = JPrefillMeta(jnp.asarray(positions), jnp.asarray(slots), jnp.asarray(table),
                     jnp.int32(cache_len), jnp.int32(q_len))
    t = TPrefillMeta(T(positions), T(slots), T(table), torch.tensor(cache_len, dtype=torch.int32),
                     torch.tensor(q_len, dtype=torch.int32))
    return j, t


def _chunk(table, start, n, bucket):
    pos = np.zeros(bucket, np.int32)
    pos[:n] = np.arange(start, start + n)
    slots = np.full(bucket, -1, np.int32)
    p = np.arange(start, start + n)
    slots[:n] = table[p // S] * S + p % S
    return pos, slots


def _prompt(rng, cfg, n):
    return rng.randint(2, cfg.vocab_size, size=n).astype(np.int32)


def test_rope_table_has_the_rope_head_width(model):
    jcfg, _, jrope, tcfg, _, trope = model
    np.testing.assert_allclose(np.asarray(trope.inv_freq), np.asarray(jrope.inv_freq), rtol=1e-6)
    assert len(np.asarray(trope.inv_freq)) == tcfg.mla.qk_rope_head_dim // 2
    assert abs(trope.mscale - jrope.mscale) < 1e-6


def test_mla_layer_prefill_packed_and_decode_match_jax(model):
    """Layer 0's attention alone: a chunk from an empty cache, a chunk that
    starts mid-page, a packed group over both sequences, then a decode step."""
    jcfg, jp, jrope, tcfg, tp, trope = model
    rng = np.random.RandomState(1)
    jcache, tcache = _caches(jcfg, tcfg)
    ja, ta = jp["layers"]["0"]["attn"], tp["layers"]["0"]["attn"]
    perm = rng.permutation(PAGES)
    tables = np.full((2, MAXP), -1, np.int32)
    tables[0, :6], tables[1, :4] = perm[:6], perm[6:10]

    def both(x, positions, jmeta, tmeta, mode):
        nonlocal jcache, tcache
        jo, jcache = JM.mla_attention_layer(ja, jcfg, jrope, jnp.asarray(x), jnp.asarray(positions),
                                            jcache, 0, jmeta, mode)
        to, tcache = TM.mla_attention_layer(ta, tcfg, trope, T(x), T(positions), tcache, 0, tmeta, mode)
        return np.asarray(jo), to.numpy()

    start = 0
    for n in (13, 7):  # the second chunk starts mid-page
        x = rng.randn(16, jcfg.dim_model).astype(np.float32)
        pos, slots = _chunk(tables[0], start, n, 16)
        jm, tm = _prefill_metas(pos, slots, tables[0], start, n)
        jo, to = both(x, pos, jm, tm, "prefill")
        np.testing.assert_allclose(to[:n], jo[:n], rtol=RTOL, atol=ATOL)
        start += n

    TC = 8
    cache_lens, q_lens = np.array([20, 0], np.int32), np.array([3, 8], np.int32)
    positions = np.zeros(2 * TC, np.int32)
    slot_map = np.full(2 * TC, -1, np.int32)
    for s in range(2):
        positions[s * TC : (s + 1) * TC], slot_map[s * TC : (s + 1) * TC] = _chunk(
            tables[s], cache_lens[s], q_lens[s], TC)
    x = rng.randn(2 * TC, jcfg.dim_model).astype(np.float32)
    arrays = (positions, slot_map, tables, cache_lens, q_lens)
    jo, to = both(x, positions, JPackedPrefillMeta(*(jnp.asarray(a) for a in arrays)),
                  TPackedPrefillMeta(*(T(a) for a in arrays)), "prefill")
    for s in range(2):
        rows = slice(s * TC, s * TC + q_lens[s])
        np.testing.assert_allclose(to[rows], jo[rows], rtol=RTOL, atol=ATOL)

    positions = np.array([23, 8, 0], np.int32)
    tables3 = np.concatenate([tables, np.full((1, MAXP), -1, np.int32)])
    slot_map = np.array([tables[0, 23 // S] * S + 23 % S, tables[1, 8 // S] * S + 8 % S, -1], np.int32)
    arrays = (positions, slot_map, tables3, np.array([24, 9, 0], np.int32))
    x = rng.randn(3, jcfg.dim_model).astype(np.float32)
    jo, to = both(x, positions, JDecodeMeta(*(jnp.asarray(a) for a in arrays)),
                  TDecodeMeta(*(T(a) for a in arrays)), "decode")
    np.testing.assert_allclose(to[:2], jo[:2], rtol=RTOL, atol=ATOL)
    _assert_pools(jcache, tcache)
    # the same step as the first of a decode window (side rows, no write):
    # this step's row from the side buffer, the rest from the pool
    valid = T(arrays[3] > 0)
    side = dict(rows=torch.zeros(3, 2, tcfg.mla.latent_dim), valid=torch.stack([valid, torch.zeros_like(valid)], 1),
                pool_lens=T(np.maximum(arrays[3] - 1, 0)), step=0)
    before = tcache.latent[0].clone()
    so, _, rows = TM.mla_attention_layer(ta, tcfg, trope, T(x), T(positions), tcache, 0,
                                         TDecodeMeta(*(T(a) for a in arrays)), "decode", side=side)
    np.testing.assert_allclose(so[:2].numpy(), to[:2], rtol=RTOL, atol=ATOL)
    assert torch.equal(tcache.latent[0], before) and rows is side["rows"] and rows[:2, 0].any()


def test_model_logits_match_jax(model):
    """Whole-model logits (MLA + dense layer 0 + MoE layer 1): two prefill
    chunks, then a decode step over the sequence and an idle slot; also
    forward_score and forward_hidden over the whole prompt."""
    jcfg, jp, jrope, tcfg, tp, trope = model
    rng = np.random.RandomState(2)
    jcache, tcache = _caches(jcfg, tcfg)
    table = np.full(MAXP, -1, np.int32)
    table[:6] = rng.permutation(PAGES)[:6]
    prompt = _prompt(rng, jcfg, 14)
    start = 0
    for n in (9, 5):
        pos, slots = _chunk(table, start, n, 16)
        toks = np.zeros(16, np.int32)
        toks[:n] = prompt[start : start + n]
        jm, tm = _prefill_metas(pos, slots, table, start, n)
        jl, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache)
        tl, tcache = TL.forward_prefill(tp, tcfg, trope, T(toks), tm, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
        start += n

    tables = np.stack([table, np.full(MAXP, -1, np.int32)])
    arrays = (np.array([14, 0], np.int32), np.array([table[14 // S] * S + 14 % S, -1], np.int32),
              tables, np.array([15, 0], np.int32))
    tokens = _prompt(rng, jcfg, 2)
    jl, jcache = JL.forward_decode(jp, jcfg, jrope, jnp.asarray(tokens),
                                   JDecodeMeta(*(jnp.asarray(a) for a in arrays)), jcache)
    tl, tcache = TL.forward_decode(tp, tcfg, trope, T(tokens), TDecodeMeta(*(T(a) for a in arrays)),
                                   tcache)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], rtol=RTOL, atol=ATOL)
    _assert_pools(jcache, tcache)

    jcache, tcache = _caches(jcfg, tcfg)
    pos, slots = _chunk(table, 0, 14, 14)
    jm, tm = _prefill_metas(pos, slots, table, 0, 14)
    for name in ("forward_score", "forward_hidden"):
        jo, _ = getattr(JL, name)(jp, jcfg, jrope, jnp.asarray(prompt), jm, jcache)
        to, _ = getattr(TL, name)(tp, tcfg, trope, T(prompt), tm, tcache)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)


def test_init_params_has_the_reference_layout(model):
    jcfg, jp, _, tcfg, _, _ = model
    tp = TL.init_params(tcfg, seed=0, device="cpu")

    def shapes(tree, get):
        return {k: shapes(v, get) if isinstance(v, dict) else get(v) for k, v in tree.items()}

    assert shapes(tp, lambda v: (tuple(v.shape), str(v.dtype).removeprefix("torch."))) == \
        shapes(jp, lambda v: (tuple(v.shape), v.dtype.name))


# ---------------------------------------------------------------------------
# the serving stack on a latent pool
# ---------------------------------------------------------------------------

VOCAB, EOS = 64, 1
TINY_MLA = dict(model_type="deepseek_v2", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
                num_kv_heads=4, dim_ff=64, vocab_size=VOCAB, dtype="float32")
TINY_MLA_DIMS = dict(q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
                     v_head_dim=8)
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_engine_e2e.py's tiny MLA model in both packages."""
    jcfg = JModelConfig(**TINY_MLA, mla=JMLAConfig(**TINY_MLA_DIMS))
    tcfg = ModelConfig(**TINY_MLA, mla=MLAConfig(**TINY_MLA_DIMS))
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    return jcfg, jparams, tcfg, params_to_torch(jax.device_get(jparams), "cpu")


def _jax_llm(tiny, **sched):
    jcfg, jparams, _, _ = tiny
    return JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=64),
        scheduler=JSchedulerConfig(**dict(SCHED, **sched))))


def _torch_llm(tiny, num_pages=64, **sched):
    _, _, tcfg, tparams = tiny
    return LLM(model_config=tcfg, params=tparams, device="cpu", engine_config=EngineConfig(
        max_model_len=64, cache=CacheConfig(page_size=4, num_pages=num_pages),
        scheduler=SchedulerConfig(**dict(SCHED, **sched))))


def _tokens(results):
    return [r.outputs[0].token_ids for r in results]


def test_greedy_tokens_match_jax_engine(tiny):
    """Four concurrent requests whose prompts cross the page and the chunk
    size, 4-step decode windows and a packed prefill group, then one long
    request alone: identical tokens from the latent pool."""
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in (3, 9, 18, 37)]
    long_prompt = list(rng.randint(2, VOCAB, size=50))

    def serve(llm, gen_cls, arg_cls):
        with gen_cls(llm) as gen:
            res = gen.batch_generate(prompts, [arg_cls(max_length=12) for _ in prompts], timeout=300)
            res.append(gen.generate(long_prompt, arg_cls(max_length=12), timeout=300))
        return _tokens(res)

    tllm = _torch_llm(tiny)
    assert tllm.executor.cache.is_latent
    assert tllm.executor._kv_bytes_per_token() == 2 * 20 * 2
    got = serve(tllm, DynamicBatchGenerator, GeneratorArg)
    assert got == serve(_jax_llm(tiny), JGenerator, JGeneratorArg)
    assert all(len(t) >= 1 for t in got)


def test_beam_search_on_the_latent_pool_matches_jax(tiny):
    rng = np.random.RandomState(4)
    prompt = list(rng.randint(2, VOCAB, size=7))
    kw = dict(beam_size=2, num_results=2, max_length=6)
    with JGenerator(_jax_llm(tiny)) as gen:
        want = [(o.token_ids, o.score) for o in gen.generate(prompt, JGeneratorArg(**kw)).outputs]
    with DynamicBatchGenerator(_torch_llm(tiny)) as gen:
        got = [(o.token_ids, o.score) for o in gen.generate(prompt, GeneratorArg(**kw)).outputs]
    assert len(got) == len(want) >= 1
    for (gt, gs), (wt, ws) in zip(got, want):
        assert gt == wt and abs(gs - ws) < 1e-3


def test_swap_preemption_on_the_latent_pool(tiny):
    """8 pages x 4 = 32 latent rows, optimistic admission: two (7-token prompt,
    20 new tokens) requests need 54, so the newer one is swapped out and back;
    both return the tokens the JAX engine gives with room for both."""
    rng = np.random.RandomState(21)
    prompts = [list(rng.randint(2, VOCAB, size=7)) for _ in range(2)]
    with JGenerator(_jax_llm(tiny)) as gen:
        want = _tokens(gen.batch_generate(prompts, JGeneratorArg(max_length=20, ignore_eos=True)))
    llm = _torch_llm(tiny, num_pages=8, chunk_size=8, prefill_buckets=(8, 16, 32), ignore_eos=True,
                     admission_reserve=0.2, preempt_mode="swap", session_ttl=0.0,
                     decode_multi_step=0, prefill_pack=0)
    with DynamicBatchGenerator(llm) as gen:
        got = _tokens(gen.batch_generate(prompts, GeneratorArg(max_length=20)))
        n_pre = gen.scheduler.num_preemptions
    assert got == want
    assert n_pre >= 1, "pool pressure never triggered a preemption"


def test_latent_pool_rows_copy_and_swap(tiny):
    llm = _torch_llm(tiny)
    ex = llm.executor
    for layer, pool in enumerate(ex.cache.latent):
        pool.copy_(torch.randn(pool.shape, generator=torch.Generator().manual_seed(layer)))
    before = [p.clone() for p in ex.cache.latent]
    ex.copy_slots(np.array([3, 4, 5], np.int32), np.array([40, -1, 42], np.int32))
    ex.swap_in_rows(np.array([50, 51], np.int32), ex.swap_out_rows(np.array([7, 9, -1], np.int32)))
    for pool, old in zip(ex.cache.latent, before):
        assert torch.equal(pool[:, [40, 42, 50, 51]], old[:, [3, 5, 7, 9]])
        untouched = [i for i in range(pool.shape[1]) if i not in (40, 42, 50, 51)]
        assert torch.equal(pool[:, untouched], old[:, untouched])


def test_calc_logits_matches_jax(tiny):
    tokens = [5, 9, 12, 40, 3, 17, 22]
    want = _jax_llm(tiny).calc_logits(tokens)
    np.testing.assert_allclose(_torch_llm(tiny).calc_logits(tokens), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
