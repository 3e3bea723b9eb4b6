"""An fp16 model (``"torch_dtype": "float16"``, as most public GPTQ/AWQ
checkpoints ship) served by the port's ``LLM`` + ``DynamicBatchGenerator``
against the JAX package's engine on the CPU, with the same fp16 weights.

One parametrised test, a case for each pool layout a model can get: the
packed head-major pool (head_dim 64), the int8 pool, the slot-major pools
(head_dim 80: ``2 * head_dim % 128 != 0``) and a decode window with side
buffers (``ZT_WINDOW_KV=1`` on both sides, the JAX kernels in interpret mode,
as tests/test_torch_window.py runs them). Greedy tokens must be identical.

Over the int8 pool the JAX engine runs its Pallas int8 attention kernels in
interpret mode (its path on the TPU, which the port's plain versions follow:
K scale on the scores, ``p * v_scale`` rounded to q's dtype), not its CPU
fallback, which dequantizes the rows to bf16 first and so rounds elsewhere.
It serves the model of the int8 engine test (tests/test_torch_int8kv.py,
width 64, vocabulary 64): on the 128-wide model of the other cases the two
engines' int8 tokens part after a few decode steps in fp32 as in fp16, at
near ties (a top-2 gap of 0.0024 in logits of 0.55, where the prefill logits
of both agree within 1e-6), which the int8 rows' one-code-step rule
(tests/test_torch_int8kv.py) leaves open.
Both sides compute in fp16 where the model is fp16: the port's plain paths
here, its CUDA kernels on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.ops.pallas import attn_headmajor as JA
from zhilight_tpu.ops.pallas import prefill_attention as JP
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.ops.cuda import kv_write as W

MODEL = dict(model_type="llama", num_layers=2, dim_model=128, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=128, dtype="float16")
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=1)
CASES = {
    # case: model overrides, cache overrides, environment
    "packed": ({}, {}, {}),
    # the int8 pool on the model of the int8 engine test (tests/test_torch_int8kv.py)
    "int8": (dict(dim_model=64, vocab_size=64), dict(kv_dtype="int8"), {}),
    "slot_major": (dict(num_heads=2, dim_head=80, num_kv_heads=1), {}, {}),
    "window": ({}, dict(page_size=16, num_pages=16),
               dict(ZT_WINDOW_KV="1", ZT_PALLAS_INTERPRET="1")),
}
# the JAX int8 attention kernels, run in interpret mode for the int8 case
JAX_INT8_KERNELS = ((JP, "paged_prefill_attention_hm_packed_q"),
                    (JP, "paged_prefill_attention_hm_q"), (JA, "paged_decode_attention_hm_q"))
PROMPT_LENS = (3, 9, 18, 37)


def _tokens(generator_cls, arg_cls, llm, prompts):
    with generator_cls(llm) as gen:
        results = gen.batch_generate(prompts, [arg_cls(max_length=10) for _ in prompts],
                                     timeout=300)
    return [r.outputs[0].token_ids for r in results]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp16_greedy_tokens_match_jax(case, monkeypatch):
    model, cache, env = CASES[case]
    model = dict(MODEL, **model)
    cache = dict(dict(page_size=4, num_pages=64), **cache)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    pallas_calls = []
    if case == "int8":
        monkeypatch.setattr(JL, "_use_pallas_decode", lambda *a, **kw: True)
        for module, name in JAX_INT8_KERNELS:
            fn = getattr(module, name)

            def interpret(*a, _fn=fn, **kw):
                if pallas_calls and pallas_calls[-1]:  # an inner call: interpret is passed on
                    return _fn(*a, **kw)
                pallas_calls.append(1)
                try:
                    return _fn(*a, **dict(kw, interpret=True))
                finally:
                    pallas_calls.append(0)

            monkeypatch.setattr(module, name, interpret)
    jcfg = JModelConfig(**model)
    params = jax.device_get(JL.init_params(jcfg, jax.random.PRNGKey(3), jnp.float16))
    rng = np.random.RandomState(3)
    prompts = [list(rng.randint(2, model["vocab_size"], size=n)) for n in PROMPT_LENS]

    jllm = JLLM(model_config=jcfg, params=params, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**SCHED)))
    want = _tokens(JGenerator, JGeneratorArg, jllm, prompts)
    assert bool(pallas_calls) == (case == "int8")

    flushes = []
    for name in ("flush_side_layers_hm", "flush_side_rows_hm"):
        fn = getattr(W, name)
        monkeypatch.setattr(W, name, lambda *a, _fn=fn, **kw: flushes.append(1) or _fn(*a, **kw))
    tllm = LLM(model_config=ModelConfig(**model), params=params, device="cpu",
               engine_config=EngineConfig(max_model_len=64, cache=CacheConfig(**cache),
                                          scheduler=SchedulerConfig(**SCHED)))
    ex = tllm.executor
    pool_dtype = torch.int8 if case == "int8" else torch.float16
    assert ex.cache.k[0].dtype == pool_dtype
    assert ex.cache.packed == (case != "slot_major")
    assert ex.window_kv == (case == "window")
    got = _tokens(DynamicBatchGenerator, GeneratorArg, tllm, prompts)

    assert got == want
    assert all(len(t) > 1 for t in got)
    assert bool(flushes) == (case == "window")
