"""Multimodal input embeddings and custom position ids through the port's
engine (zhilight_tpu_torch), against the JAX package's on the CPU.

First tests/test_multimodal_embeddings.py's four tests, run on the port:
embedding rows equal to the token rows give the tokens' generation through
chunked prefill; such prompts neither match nor register the token-keyed
prefix cache; position ids equal to arange change nothing; and
``DeepseekVL2._strip_language`` swaps the torch language model for a shim
over the engine's own table. Then the port against the JAX engine on the same
random embedding rows and position ids (greedy tokens identical on the packed
head-major pool, the slot-major pools, the int8 pool, MLA + MoE over a latent
pool and decode windows with side buffers), the model's first-token logits
with ``input_embeddings`` (fp32 1e-4; bf16 2e-2 of the largest logit, the
tolerance of the card's fp16 engine test, ``FP16_LOGIT_TOL`` in
tests/test_torch_cuda.py; MoE routing may part from the reference's only at
a near tie), the executor's cast of the rows (bit-equal to
``jnp.asarray(pad, dtype)``), swap and recompute preemption of a multimodal
request, and ``output_hidden_states``, which both refuse with embeddings.

Last, a DeepSeek-VL2 checkpoint's own tensor names (``language.model.*``,
``language.lm_head.weight``): neither package's loader maps them, so both
``LLM(model_path)`` build an empty parameter tree and fail at the first
request the same way. The test pins that shared fault as parity.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import MLAConfig as JMLAConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import MoEConfig as JMoEConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.engine import SearchTask as JSearchTask
from zhilight_tpu.engine.scheduler import Scheduler as JScheduler
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.kvcache import new_latent_cache as j_new_latent_cache
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import PackedPrefillMeta as JPackedPrefillMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.ops.pallas import attn_headmajor as JA
from zhilight_tpu.ops.pallas import prefill_attention as JP
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, MLAConfig, ModelConfig, MoEConfig
from zhilight_tpu_torch.config import SchedulerConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SearchTask
from zhilight_tpu_torch.engine.scheduler import Scheduler
from zhilight_tpu_torch.kvcache import new_kv_cache, new_latent_cache
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import PackedPrefillMeta, PrefillMeta
from zhilight_tpu_torch.models.multimodal import DeepseekVL2, is_customized_model
from zhilight_tpu_torch.utils import hf_loader as TH
from zhilight_tpu_torch.utils.convert import params_to_torch

VOCAB, EOS = 64, 1
RTOL = ATOL = 1e-4
BF16_LOGIT_TOL = 2e-2  # of the largest |logit|: tests/test_torch_cuda.py FP16_LOGIT_TOL


def _both_llms(jcfg, tcfg, jparams, cache, sched, max_model_len=64):
    """The JAX and the port's LLM over the same weights and configuration."""
    jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=max_model_len, cache=JCacheConfig(**cache),
        scheduler=JSchedulerConfig(**sched)))
    tllm = LLM(model_config=tcfg, params=params_to_torch(jax.device_get(jparams), "cpu"),
               device="cpu", engine_config=EngineConfig(
                   max_model_len=max_model_len, cache=CacheConfig(**cache),
                   scheduler=SchedulerConfig(**sched)))
    return jllm, tllm


def _serve(llm, gen_cls, task_cls, arg_cls, requests, **arg):
    """Every request submitted at once; each is (token ids, embedding rows or
    None, position ids or None). Returns each request's token ids."""
    with gen_cls(llm) as gen:
        tasks = [task_cls([int(t) for t in toks], arg_cls(**arg), input_embeddings=emb,
                          position_ids=pos) for toks, emb, pos in requests]
        for task in tasks:
            gen.scheduler.submit(task)
        outs = [gen._wait_final(task, 300)[1] for task in tasks]
    for out in outs:
        if isinstance(out, BaseException):
            raise out
    return [out.token_ids for out in outs]


def _image_rows(rng, n, table):
    """n random rows at the scale of the embedding table's rows."""
    return (rng.randn(n, table.shape[1]) * float(np.std(table))).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_multimodal_embeddings.py on the port
# ---------------------------------------------------------------------------

SETUP_MODEL = dict(model_type="llama", num_layers=2, dim_model=32, num_heads=4, dim_head=8,
                   num_kv_heads=2, dim_ff=64, vocab_size=VOCAB, dtype="float32")


@pytest.fixture(scope="module")
def setup():
    """The reference test's model (head_dim 8: slot-major pools) and engine,
    its weights from the JAX package's init_params."""
    cfg = ModelConfig(**SETUP_MODEL)
    jparams = jax.device_get(JL.init_params(JModelConfig(**SETUP_MODEL), jax.random.PRNGKey(0),
                                            jnp.float32))
    ecfg = EngineConfig(
        max_model_len=64,
        cache=CacheConfig(page_size=4, num_pages=64),
        scheduler=SchedulerConfig(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32),
                                  eos_id=EOS),
    )
    params = params_to_torch(jparams, "cpu")
    return cfg, jparams, params, LLM(model_config=cfg, params=params, engine_config=ecfg,
                                     device="cpu")


def test_embeddings_match_tokens(setup):
    cfg, jparams, _, llm = setup
    rng = np.random.RandomState(9)
    prompt = list(rng.randint(2, VOCAB, size=11))  # > chunk_size: chunked path
    emb_table = np.asarray(jparams["embedding"]["w"], np.float32)
    emb = emb_table[np.asarray(prompt)] * cfg.scale_emb

    with DynamicBatchGenerator(llm) as gen:
        want = gen.generate(prompt, GeneratorArg(max_length=6)).outputs[0].token_ids
        got = gen.generate(
            prompt, GeneratorArg(max_length=6), input_embeddings=emb
        ).outputs[0].token_ids
    assert got == want


def test_embeddings_skip_prefix_cache(setup):
    """Prompts with input_embeddings neither register nor match the
    token-keyed prefix cache: identical placeholder token ids can carry
    different images."""
    cfg, jparams, params, _ = setup
    ecfg = EngineConfig(
        max_model_len=64,
        cache=CacheConfig(page_size=4, num_pages=64, enable_prefix_caching=True),
        scheduler=SchedulerConfig(max_batch=4, chunk_size=32, prefill_buckets=(8, 16, 32),
                                  eos_id=EOS),
    )
    llm = LLM(model_config=cfg, params=params, engine_config=ecfg, device="cpu")
    rng = np.random.RandomState(13)
    prompt = list(rng.randint(2, VOCAB, size=8))
    emb_table = np.asarray(jparams["embedding"]["w"], np.float32)
    emb_a = emb_table[np.asarray(prompt)] * cfg.scale_emb
    emb_b = emb_a + 0.25  # "different image", same placeholder token ids

    with DynamicBatchGenerator(llm) as gen:
        # a text request registers its prefix
        gen.generate(prompt, GeneratorArg(max_length=3))
        assert gen.scheduler.allocator.num_cached > 0
        cached0 = gen.scheduler.allocator.num_cached

        ta = SearchTask(prompt, GeneratorArg(max_length=3), input_embeddings=emb_a)
        gen.scheduler.submit(ta)
        _, out_a = ta.res_queue.get(timeout=120)
        tb = SearchTask(prompt, GeneratorArg(max_length=3), input_embeddings=emb_b)
        gen.scheduler.submit(tb)
        _, out_b = tb.res_queue.get(timeout=120)

    # neither matched the text prefix nor registered new entries
    assert ta.prefix_hit_len == 0 and tb.prefix_hit_len == 0
    assert gen.scheduler.allocator.num_cached == cached0
    # different embeddings over the same token ids produce different KV
    assert out_a.token_ids != out_b.token_ids


def test_custom_position_ids(setup):
    _, _, _, llm = setup
    rng = np.random.RandomState(10)
    prompt = list(rng.randint(2, VOCAB, size=6))
    with DynamicBatchGenerator(llm) as gen:
        base = gen.generate(prompt, GeneratorArg(max_length=4)).outputs[0].token_ids
        same = gen.generate(
            prompt, GeneratorArg(max_length=4),
            position_ids=np.arange(len(prompt), dtype=np.int32),
        ).outputs[0].token_ids
    assert same == base


class FakeVL(torch.nn.Module):
    """A vision-language module whose language model is the bulk of it."""

    def __init__(self):
        super().__init__()
        self.vision = torch.nn.Linear(8, 8)
        self.language = torch.nn.Sequential(
            torch.nn.Embedding(VOCAB, 512), torch.nn.Linear(512, 512)
        )


def test_strip_language_replaces_torch_lm(setup):
    """After stripping, the language module is a shim serving the engine's own
    table rows (raw, no scale_emb, float32) and its weights are gone (the
    reference nulls `vl_gpt.language`, deepseek_vl_v2.py:90)."""
    _, jparams, _, llm = setup
    vl = DeepseekVL2(llm, model_path="/nonexistent")
    fake = FakeVL()
    n_before = sum(p.numel() for p in fake.parameters())
    vl._strip_language(fake)
    n_after = sum(p.numel() for p in fake.parameters())
    assert n_after < n_before // 10  # language weights actually gone
    ids = torch.tensor([[2, 3, 5]])
    out = fake.language.get_input_embeddings()(ids)
    assert out.dtype == torch.float32 and out.shape == (1, 3, SETUP_MODEL["dim_model"])
    table = llm.executor.params["embedding"]["w"]
    assert torch.equal(out[0], table[[2, 3, 5]].float())
    expect = np.asarray(jparams["embedding"]["w"], np.float32)[[2, 3, 5]]
    np.testing.assert_allclose(out.numpy()[0], expect, rtol=1e-6)


def test_strip_language_takes_language_model_and_bf16_tables(setup):
    """The shim also replaces a ``language_model`` attribute, and a bf16
    table's rows come back as their float32 values."""
    cfg, _, params, _ = setup
    llm = LLM(model_config=dataclasses.replace(cfg, dtype="bfloat16"), params=params,
              device="cpu", engine_config=EngineConfig(
                  max_model_len=64, cache=CacheConfig(page_size=4, num_pages=16),
                  scheduler=SchedulerConfig(max_batch=2, chunk_size=8, prefill_buckets=(8,))))

    class Other(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.language_model = torch.nn.Embedding(VOCAB, 256)

    model = Other()
    DeepseekVL2(llm, "/nonexistent")._strip_language(model)
    assert sum(p.numel() for p in model.parameters()) == 0
    table = llm.executor.params["embedding"]["w"]
    assert table.dtype == torch.bfloat16
    shim = model.language_model.get_input_embeddings()
    out = shim(torch.tensor([7, 1, 7]))
    assert out.dtype == torch.float32 and torch.equal(out, table[[7, 1, 7]].float())
    for bad in ([3, VOCAB], [-1, 2]):
        with pytest.raises(IndexError, match="token ids"):
            shim(torch.tensor(bad))


def test_missing_vision_stack_raises(setup, monkeypatch):
    """No fallback: without transformers, or without the model's remote code
    and weights, the vision tower raises a RuntimeError that says why."""
    _, _, _, llm = setup
    assert is_customized_model({"model_type": "deepseek_vl_v2"})
    assert not is_customized_model({"model_type": "deepseek_v2"})
    with pytest.raises(RuntimeError, match="vision tower unavailable"):
        DeepseekVL2(llm, "/nonexistent").compute_embeddings([], [])
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        DeepseekVL2(llm, "/nonexistent").generate([], [])


# ---------------------------------------------------------------------------
# the port against the JAX engine on random embedding rows and position ids
# ---------------------------------------------------------------------------

DENSE = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
SCHED = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)
MLA_MOE = dict(model_type="deepseek_v2", num_layers=3, dim_model=32, num_heads=4, dim_head=8,
               num_kv_heads=4, dim_ff=64, vocab_size=VOCAB, dtype="float32",
               mla=dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8),
               moe=dict(num_experts=4, top_k=2, intermediate_size=16,
                        shared_expert_intermediate_size=16, first_k_dense_replace=1))
LAYOUTS = {
    # layout: model overrides, cache overrides, scheduler overrides, environment
    "packed": ({}, {}, {}, {}),
    "slot_major": (dict(dim_head=16), {}, {}, {}),
    "int8": ({}, dict(kv_dtype="int8"), {}, {}),
    "mla_moe": (MLA_MOE, {}, {}, {}),
    # tests/test_torch_window.py's engine settings; the JAX kernels in
    # interpret mode
    "window": (dict(dim_model=128, vocab_size=128), dict(page_size=16, num_pages=16),
               dict(max_batch=2, chunk_size=16, prefill_buckets=(16,)),
               dict(ZT_WINDOW_KV="1", ZT_PALLAS_INTERPRET="1")),
}


# the JAX int8 attention kernels, run in interpret mode for the int8 layout
# (tests/test_torch_fp16.py): the JAX engine's TPU path, which the port's
# plain versions follow, not its CPU fallback, which rounds the dequantized
# rows to bf16 first
JAX_INT8_KERNELS = ((JP, "paged_prefill_attention_hm_packed_q"),
                    (JP, "paged_prefill_attention_hm_q"), (JA, "paged_decode_attention_hm_q"))


def _jax_int8_kernels(monkeypatch):
    """Route the JAX engine's int8 attention through its Pallas kernels in
    interpret mode; returns the list their calls append to."""
    calls = []
    monkeypatch.setattr(JL, "_use_pallas_decode", lambda *a, **kw: True)
    for module, name in JAX_INT8_KERNELS:
        def interpret(*a, _fn=getattr(module, name), **kw):
            if calls and calls[-1]:  # an inner call: interpret is passed on
                return _fn(*a, **kw)
            calls.append(1)
            try:
                return _fn(*a, **dict(kw, interpret=True))
            finally:
                calls.append(0)
        monkeypatch.setattr(module, name, interpret)
    return calls


def _configs(model):
    model = dict(model)
    mla, moe = model.pop("mla", None), model.pop("moe", None)
    jcfg = JModelConfig(**model, **({"mla": JMLAConfig(**mla)} if mla else {}),
                        **({"moe": JMoEConfig(**moe)} if moe else {}))
    tcfg = ModelConfig(**model, **({"mla": MLAConfig(**mla)} if mla else {}),
                       **({"moe": MoEConfig(**moe)} if moe else {}))
    return jcfg, tcfg


def _requests(rng, table, vocab):
    """Concurrent requests: image rows with position ids that repeat (image
    rows sharing a position), image rows alone, a text prompt with shuffled
    position ids, and a plain text prompt."""
    out = []
    for n, with_emb, pos in ((11, True, "repeat"), (19, True, None), (9, False, "shuffle"),
                             (13, False, None)):
        toks = rng.randint(2, vocab, size=n)
        emb = _image_rows(rng, n, table) if with_emb else None
        if pos == "repeat":
            pos = np.sort(rng.randint(0, n, size=n)).astype(np.int32)
        elif pos == "shuffle":
            pos = rng.permutation(n).astype(np.int32)
        out.append((toks, emb, pos))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_tokens_match_jax_engine(layout, monkeypatch):
    model, cache, sched, env = LAYOUTS[layout]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    pallas_calls = _jax_int8_kernels(monkeypatch) if layout == "int8" else []
    jcfg, tcfg = _configs(dict(DENSE, **model))
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    cache = dict(dict(page_size=4, num_pages=64), **cache)
    jllm, tllm = _both_llms(jcfg, tcfg, jparams, cache, dict(SCHED, **sched))
    assert tllm.executor.cache.packed == jllm.executor.cache.packed
    assert tllm.executor.window_kv == (layout == "window")
    table = np.asarray(jparams["embedding"]["w"], np.float32)
    requests = _requests(np.random.RandomState(7), table, tcfg.vocab_size)
    want = _serve(jllm, JGenerator, JSearchTask, JGeneratorArg, requests, max_length=8)
    assert bool(pallas_calls) == (layout == "int8")
    got = _serve(tllm, DynamicBatchGenerator, SearchTask, GeneratorArg, requests, max_length=8)
    assert got == want
    assert all(len(t) > 1 for t in got)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_emb_arg_casts_as_the_reference(dtype):
    """The executor's rows: zero-padded to the bucket in fp32, then cast to
    the model's dtype with the values of jnp.asarray(pad, dtype), halfway
    cases included (round to nearest even)."""
    model = dict(DENSE, dtype=dtype)
    jcfg, tcfg = _configs(model)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jllm, tllm = _both_llms(jcfg, tcfg, jparams, dict(page_size=4, num_pages=16), SCHED)
    rng = np.random.RandomState(2)
    rows = rng.randn(11, 64).astype(np.float32)
    bits = rows.view(np.uint32)
    bits[0, :32] = (bits[0, :32] & 0xFFFF0000) | 0x8000  # bf16 halfway cases
    bits[1, :32] = (bits[1, :32] & 0xFFFFE000) | 0x1000  # fp16 halfway cases
    got = tllm.executor._emb_arg(rows, 16)
    want, used = jllm.executor._emb_arg(rows, 16)
    assert used and got.dtype == tcfg.torch_dtype and got.shape == (16, 64)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not want[11:].any()
    assert tllm.executor._emb_arg(None, 16) is None


PREFILL_MODELS = {"dense": DENSE, "mla_moe": dict(DENSE, **MLA_MOE)}
# bf16 as the fp16 engine tests hold it (tests/test_torch_fp16.py)
PREFILL_CASES = [("dense", "float32"), ("dense", "bfloat16"), ("mla_moe", "float32"),
                 ("mla_moe", "bfloat16")]


def _prefill_case(name, dtype):
    jcfg, tcfg = _configs(dict(PREFILL_MODELS[name], dtype=dtype))
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    tparams = params_to_torch(jax.device_get(jparams), "cpu", tcfg.torch_dtype)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jcfg.jax_dtype), jparams)
    table = np.asarray(jparams["embedding"]["w"], np.float32)
    return jcfg, jparams, tcfg, tparams, table


def _caches(jcfg, tcfg, pages, S):
    if tcfg.mla.enabled:
        return (j_new_latent_cache(jcfg.num_layers, pages, S, jcfg.mla.latent_dim, jcfg.jax_dtype),
                new_latent_cache(tcfg.num_layers, pages, S, tcfg.mla.latent_dim, tcfg.torch_dtype,
                                 device="cpu"))
    return (j_new_kv_cache(jcfg.num_layers, pages, S, jcfg.num_kv_heads, jcfg.dim_head,
                           jcfg.jax_dtype),
            new_kv_cache(tcfg.num_layers, pages, S, tcfg.num_kv_heads, tcfg.dim_head,
                         tcfg.torch_dtype, device="cpu"))


def _assert_logits(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert np.abs(got - want).max() <= BF16_LOGIT_TOL * np.abs(want).max()
        assert got.argmax(-1).tolist() == want.argmax(-1).tolist()


def _reference_routing(monkeypatch):
    """Each MoE layer's routing, the port's against the reference's (which
    runs first on the same input): where a token's top-k experts part, the
    parting must be a near tie, the reference's gap between its k-th expert
    and the port's pick no more than twice the row's largest router-logit
    difference; that token then takes the reference's experts and weights,
    so that one rounding flip does not stand for the rest of the layer.
    Returns the list of parted token counts, one per layer call."""
    from zhilight_tpu.models import moe as JM
    from zhilight_tpu_torch.models import moe as TM

    queue, parted = [], []

    def j_select(logits, m, bias=None, _orig=JM.select_experts):
        weights, ids = _orig(logits, m, bias)
        queue.append((np.asarray(logits, np.float32), np.asarray(ids), np.asarray(weights)))
        return weights, ids

    def t_select(logits, m, bias=None, _orig=TM.select_experts):
        weights, ids = _orig(logits, m, bias)
        j_logits, j_ids, j_weights = queue.pop(0)
        t_logits = logits.float().numpy()
        rows = [r for r in range(len(j_ids))
                if set(j_ids[r].tolist()) != set(ids[r].tolist())]
        for r in rows:
            kth = j_logits[r, j_ids[r]].min()
            picked = j_logits[r, sorted(set(ids[r].tolist()) - set(j_ids[r].tolist()))].max()
            assert kth - picked <= 2 * np.abs(j_logits[r] - t_logits[r]).max(), (r, kth, picked)
            ids[r] = torch.from_numpy(j_ids[r].astype(np.int32))
            weights[r] = torch.from_numpy(j_weights[r].astype(np.float32))
        parted.append(len(rows))
        return weights, ids

    monkeypatch.setattr(JM, "select_experts", j_select)
    monkeypatch.setattr(TM, "select_experts", t_select)
    return parted


@pytest.mark.parametrize("name,dtype", PREFILL_CASES)
def test_prefill_logits_with_embeddings_match_jax(name, dtype, monkeypatch):
    """forward_prefill over two chunks (the second mid-page, custom
    positions) and forward_prefill_packed over two segments, each fed image
    rows in the model's dtype: the logits of both packages. MoE routing is
    held by _reference_routing: in fp32 it never parts; in bf16 one token
    parts at one layer, a near tie, which alone would move the logits far
    beyond the bf16 tolerance."""
    parted = _reference_routing(monkeypatch) if name == "mla_moe" else []
    jcfg, jp, tcfg, tp, table = _prefill_case(name, dtype)
    jrope, trope = JL.build_rope(jcfg), TL.build_rope(tcfg)
    S, PAGES = 4, 16
    rng = np.random.RandomState(4)
    jcache, tcache = _caches(jcfg, tcfg, PAGES, S)
    emb = _image_rows(rng, 22, table)
    positions = np.sort(rng.randint(0, 22, size=22)).astype(np.int32)
    table_pages = rng.permutation(PAGES)[:8].astype(np.int32)
    start = 0
    for n in (13, 9):
        bucket = 16
        pos = np.zeros(bucket, np.int32)
        pos[:n] = positions[start : start + n]
        p = np.arange(start, start + n)
        slots = np.full(bucket, -1, np.int32)
        slots[:n] = table_pages[p // S] * S + p % S
        rows = np.zeros((bucket, tcfg.dim_model), np.float32)
        rows[:n] = emb[start : start + n]
        toks = np.zeros(bucket, np.int32)
        jm = JPrefillMeta(jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(table_pages),
                          jnp.int32(start), jnp.int32(n))
        tm = PrefillMeta(torch.from_numpy(pos), torch.from_numpy(slots),
                         torch.from_numpy(table_pages), torch.tensor(start, dtype=torch.int32),
                         torch.tensor(n, dtype=torch.int32))
        jl, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache,
                                        jnp.asarray(rows, jcfg.jax_dtype))
        tl, tcache = TL.forward_prefill(tp, tcfg, trope, torch.from_numpy(toks), tm, tcache,
                                        torch.from_numpy(rows).to(tcfg.torch_dtype))
        _assert_logits(tl, jl, dtype)
        start += n

    # a packed group: two fresh segments of 5 and 7 rows in 8-row slots
    jcache, tcache = _caches(jcfg, tcfg, PAGES, S)
    TC, lens = 8, np.array([5, 7], np.int32)
    rows = np.zeros((2 * TC, tcfg.dim_model), np.float32)
    pos = np.zeros(2 * TC, np.int32)
    slots = np.full(2 * TC, -1, np.int32)
    tables = np.full((2, 4), -1, np.int32)
    tables[0, :2], tables[1, :2] = (3, 9), (0, 14)
    for s, n in enumerate(lens):
        rows[s * TC : s * TC + n] = _image_rows(rng, n, table)
        pos[s * TC : s * TC + n] = np.arange(n)
        slots[s * TC : s * TC + n] = tables[s, np.arange(n) // S] * S + np.arange(n) % S
    zeros = np.zeros(2, np.int32)
    jm = JPackedPrefillMeta(jnp.asarray(pos), jnp.asarray(slots), jnp.asarray(tables),
                            jnp.asarray(zeros), jnp.asarray(lens))
    tm = PackedPrefillMeta(torch.from_numpy(pos), torch.from_numpy(slots),
                           torch.from_numpy(tables), torch.from_numpy(zeros),
                           torch.from_numpy(lens))
    toks = np.zeros(2 * TC, np.int32)
    jl, _ = JL.forward_prefill_packed(jp, jcfg, jrope, jnp.asarray(toks), jm, jcache,
                                      jnp.asarray(rows, jcfg.jax_dtype))
    tl, _ = TL.forward_prefill_packed(tp, tcfg, trope, torch.from_numpy(toks), tm, tcache,
                                      torch.from_numpy(rows).to(tcfg.torch_dtype))
    _assert_logits(tl, jl, dtype)
    if name == "mla_moe":
        assert len(parted) == 3 * (MLA_MOE["num_layers"] - 1)
        assert sum(parted) == (0 if dtype == "float32" else 1)


# ---------------------------------------------------------------------------
# preemption and hidden states
# ---------------------------------------------------------------------------

PRESSURE = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                ignore_eos=True, admission_reserve=0.2, session_ttl=0.0)


def _victims(monkeypatch):
    """For each package, whether each preempted task carried embeddings."""
    seen = {"jax": [], "torch": []}
    for key, cls in (("jax", JScheduler), ("torch", Scheduler)):
        def spy(self, newer_than, _orig=cls._preempt_one, _key=key):
            done = _orig(self, newer_than)
            if done:
                seen[_key].append(self.preempted[-1].input_embeddings is not None)
            return done
        monkeypatch.setattr(cls, "_preempt_one", spy)
    return seen


def test_swap_preemption_of_a_multimodal_request(setup, monkeypatch):
    """8 pages x 4 = 32 rows, optimistic admission: a text request and a
    newer multimodal one (7 tokens, 20 new each) need 54, so the multimodal
    one is swapped out and back. Both return the JAX engine's tokens, which
    are those of a pool with room for both."""
    _, jparams, _, _ = setup
    jcfg, tcfg = _configs(SETUP_MODEL)
    rng = np.random.RandomState(21)
    table = np.asarray(jparams["embedding"]["w"], np.float32)
    requests = [(rng.randint(2, VOCAB, size=7), None, None),
                (rng.randint(2, VOCAB, size=7), _image_rows(rng, 7, table), None)]
    victims = _victims(monkeypatch)
    sched = dict(PRESSURE, preempt_mode="swap")
    jllm, tllm = _both_llms(jcfg, tcfg, jparams, dict(page_size=4, num_pages=8), sched)
    want = _serve(jllm, JGenerator, JSearchTask, JGeneratorArg, requests, max_length=20)
    got = _serve(tllm, DynamicBatchGenerator, SearchTask, GeneratorArg, requests, max_length=20)
    assert got == want
    assert True in victims["torch"], "the multimodal request was never swapped out"
    assert victims["torch"] == victims["jax"]
    _, roomy = _both_llms(jcfg, tcfg, jparams, dict(page_size=4, num_pages=64), sched)
    assert _serve(roomy, DynamicBatchGenerator, SearchTask, GeneratorArg, requests,
                  max_length=20) == got


def test_recompute_preemption_leaves_a_multimodal_request_alone(setup, monkeypatch):
    """Recompute cannot rebuild a multimodal prompt's KV from token ids, so
    the reference never picks such a request (zhilight_tpu/engine/
    scheduler.py:585-587). Two text requests, then a multimodal one, the
    newest, over a pool that holds two of them: the newer text request is
    preempted and re-prefilled instead, in both packages, with the JAX
    engine's tokens."""
    _, jparams, _, _ = setup
    jcfg, tcfg = _configs(SETUP_MODEL)
    rng = np.random.RandomState(22)
    table = np.asarray(jparams["embedding"]["w"], np.float32)
    requests = [(rng.randint(2, VOCAB, size=5), None, None),
                (rng.randint(2, VOCAB, size=5), None, None),
                (rng.randint(2, VOCAB, size=5), _image_rows(rng, 5, table), None)]
    victims = _victims(monkeypatch)
    sched = dict(PRESSURE, preempt_mode="recompute")
    jllm, tllm = _both_llms(jcfg, tcfg, jparams, dict(page_size=4, num_pages=10), sched)
    want = _serve(jllm, JGenerator, JSearchTask, JGeneratorArg, requests, max_length=14)
    got = _serve(tllm, DynamicBatchGenerator, SearchTask, GeneratorArg, requests, max_length=14)
    assert got == want
    assert victims["torch"] and not any(victims["torch"]), victims
    assert victims["torch"] == victims["jax"]


def test_hidden_states_with_embeddings_raise_as_the_reference(setup):
    cfg, jparams, _, llm = setup
    jllm = JLLM(model_config=JModelConfig(**SETUP_MODEL), params=jparams,
                engine_config=JEngineConfig(max_model_len=64,
                                            cache=JCacheConfig(page_size=4, num_pages=64),
                                            scheduler=JSchedulerConfig(max_batch=4, chunk_size=8,
                                                                       prefill_buckets=(8, 16))))
    prompt = [5, 9, 12, 3]
    emb = np.asarray(jparams["embedding"]["w"], np.float32)[prompt]
    errors = []
    for lm, gen_cls, arg_cls in ((jllm, JGenerator, JGeneratorArg),
                                 (llm, DynamicBatchGenerator, GeneratorArg)):
        with gen_cls(lm) as gen, pytest.raises(ValueError) as err:
            gen.generate(prompt, arg_cls(max_length=3, output_hidden_states=True),
                         input_embeddings=emb)
        errors.append(str(err.value))
    assert errors[0] == errors[1] and "input_embeddings" in errors[1]


# ---------------------------------------------------------------------------
# DeepSeek-VL2's configuration and checkpoint names
# ---------------------------------------------------------------------------

# deepseek-ai/deepseek-vl2-small's geometry: the language model of the
# DeepSeek-VL2 paper's Table 1 (DeepSeekMoE-16B with MLA), the fields the
# paper does not give at DeepSeek-V2-Lite's public values (chip_smoke.py's
# VL2_SMALL, which the card serves)
VL2_SMALL = {
    "model_type": "deepseek_vl_v2", "architectures": ["DeepseekVLV2ForCausalLM"],
    "torch_dtype": "bfloat16",
    "language_config": {
        "model_type": "deepseek_v2", "architectures": ["DeepseekV2ForCausalLM"],
        "hidden_size": 2048, "intermediate_size": 10944, "moe_intermediate_size": 1408,
        "num_hidden_layers": 27, "num_attention_heads": 16, "num_key_value_heads": 16,
        "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
        "first_k_dense_replace": 1, "moe_layer_freq": 1, "kv_lora_rank": 512, "q_lora_rank": None,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "scoring_func": "softmax", "topk_method": "greedy", "norm_topk_prob": False,
        "routed_scaling_factor": 1.0, "vocab_size": 102400, "max_position_embeddings": 163840,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
        "torch_dtype": "bfloat16", "eos_token_id": 2, "bos_token_id": 1,
        "rope_scaling": {"rope_type": "yarn", "factor": 40.0, "beta_fast": 32, "beta_slow": 1,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 4096},
    },
    "vision_config": {"model_type": "vision", "layers": 27, "width": 1152},
    "projector_config": {"model_type": "mlp_projector", "n_embed": 2048},
}


def test_vl2_config_adapts_as_the_reference():
    tcfg, jcfg = t_adapt(VL2_SMALL), j_adapt(VL2_SMALL)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.model_type, tcfg.num_layers, tcfg.dim_model, tcfg.dtype) == \
        ("deepseek_v2", 27, 2048, "bfloat16")
    assert tcfg.mla.kv_lora_rank == 512 and tcfg.moe.num_experts == 64 and tcfg.moe.top_k == 6
    assert tcfg.moe.shared_expert_intermediate_size == 2 * 1408 and tcfg.rope.type == "yarn"


VL2_TINY_LANGUAGE = dict(
    model_type="deepseek_v2", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=4, intermediate_size=64, moe_intermediate_size=16, n_routed_experts=4,
    n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1, moe_layer_freq=1,
    q_lora_rank=None, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
    vocab_size=VOCAB, rms_norm_eps=1e-6, max_position_embeddings=256, torch_dtype="float32",
    tie_word_embeddings=False)


def _vl2_checkpoint(path):
    """A tiny DeepSeek-VL2 checkpoint under the public model's module names:
    the language model under ``language``, beside ``vision`` and
    ``projector``."""
    rng = np.random.RandomState(31)
    D, L = 32, VL2_TINY_LANGUAGE
    state = {}

    def put(name, *shape):
        state[name] = torch.from_numpy((rng.randn(*shape) * 0.1).astype(np.float32))

    put("language.model.embed_tokens.weight", VOCAB, D)
    for i in range(L["num_hidden_layers"]):
        pre = f"language.model.layers.{i}."
        put(pre + "self_attn.q_proj.weight", 4 * 12, D)
        put(pre + "self_attn.kv_a_proj_with_mqa.weight", 16 + 4, D)
        put(pre + "self_attn.kv_a_layernorm.weight", 16)
        put(pre + "self_attn.kv_b_proj.weight", 4 * 16, 16)
        put(pre + "self_attn.o_proj.weight", D, 4 * 8)
        put(pre + "input_layernorm.weight", D)
        put(pre + "post_attention_layernorm.weight", D)
        if i == 0:
            for m, shape in (("gate", (64, D)), ("up", (64, D)), ("down", (D, 64))):
                put(f"{pre}mlp.{m}_proj.weight", *shape)
            continue
        put(pre + "mlp.gate.weight", 4, D)
        for e in range(4):
            for m, shape in (("gate", (16, D)), ("up", (16, D)), ("down", (D, 16))):
                put(f"{pre}mlp.experts.{e}.{m}_proj.weight", *shape)
        for m, shape in (("gate", (16, D)), ("up", (16, D)), ("down", (D, 16))):
            put(f"{pre}mlp.shared_experts.{m}_proj.weight", *shape)
    put("language.model.norm.weight", D)
    put("language.lm_head.weight", VOCAB, D)
    put("vision.blocks.0.attn.qkv.weight", 24, 8)
    put("projector.layers.0.weight", D, 8)
    torch.save(state, path / "pytorch_model.bin")
    hf = dict(VL2_SMALL, torch_dtype="float32", language_config=VL2_TINY_LANGUAGE)
    (path / "config.json").write_text(json.dumps(hf))
    return state


def test_vl2_checkpoint_names_load_as_the_reference_loads_them(tmp_path):
    """Neither loader maps ``language.model.*`` or ``language.lm_head.weight``
    (zhilight_tpu_torch/utils/hf_loader.py:79-80,112; zhilight_tpu/utils/
    hf_loader.py:88-89,126) and both load with strict=False, so both
    ``LLM(model_path)`` build an empty parameter tree and the first request
    fails with the same KeyError. A shared fault, pinned here as parity until
    the reference may change (ROADMAP queue 3)."""
    state = _vl2_checkpoint(tmp_path)
    for name in state:
        assert TH.map_hf_name(name) is None and JH.map_hf_name(name) is None, name
    sched = dict(max_batch=2, chunk_size=16, prefill_buckets=(8, 16))
    jllm = JLLM(model_path=str(tmp_path), engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=32),
        scheduler=JSchedulerConfig(**sched)))
    tllm = LLM(model_path=str(tmp_path), device="cpu", engine_config=EngineConfig(
        max_model_len=64, cache=CacheConfig(page_size=4, num_pages=32),
        scheduler=SchedulerConfig(**sched)))
    assert tllm.model_config.mla.enabled and tllm.model_config.moe.enabled
    assert dict(jllm.executor.params) == {} and tllm.executor.params == {}
    errors = []
    for lm, gen_cls, arg_cls in ((jllm, JGenerator, JGeneratorArg),
                                 (tllm, DynamicBatchGenerator, GeneratorArg)):
        with gen_cls(lm) as gen, pytest.raises(KeyError) as err:
            gen.generate([3, 4, 5], arg_cls(max_length=3), timeout=120)
        errors.append(repr(err.value))
    assert errors == ["KeyError('embedding')"] * 2
