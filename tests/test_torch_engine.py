"""The port's serving stack (LLM + DynamicBatchGenerator: scheduler, executor,
model, sampler) against the JAX package's on the CPU, with the same weights.

Four concurrent greedy requests whose prompts cross the page size (4) and
the chunk size (16), with 4-step decode windows and a packed prefill group
in play, then one long request alone (its full chunks run as a chunk chain),
must come out with identical tokens. Both sides run in fp32.
"""

import numpy as np

import jax
import jax.numpy as jnp

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu_torch.config import CacheConfig as TCacheConfig
from zhilight_tpu_torch.config import EngineConfig as TEngineConfig
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import SchedulerConfig as TSchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.llm import LLM as TLLM
from zhilight_tpu_torch.models import llama as TL

VOCAB = 64
EOS = 1
MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)
PROMPT_LENS = (3, 9, 18, 37)


def _torch_params():
    return TL.init_params(TModelConfig(**MODEL), seed=0, device="cpu")


def _serve(llm, generator_cls, arg_cls, prompts, long_prompt):
    with generator_cls(llm) as gen:
        results = gen.batch_generate(prompts, [arg_cls(max_length=12) for _ in prompts], timeout=300)
        results.append(gen.generate(long_prompt, arg_cls(max_length=12), timeout=300))
        stats = (gen.scheduler.num_packed_prefills, gen.scheduler.num_chunk_chains)
    return [r.outputs[0].token_ids for r in results], stats


def test_greedy_tokens_match_jax_engine():
    jcfg = JModelConfig(**MODEL)
    params = jax.device_get(JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in PROMPT_LENS]
    long_prompt = list(rng.randint(2, VOCAB, size=50))

    jllm = JLLM(
        model_config=jcfg, params=params,
        engine_config=JEngineConfig(
            max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=64),
            scheduler=JSchedulerConfig(**SCHED),
        ),
    )
    want, jstats = _serve(jllm, JGenerator, JGeneratorArg, prompts, long_prompt)

    tllm = TLLM(
        model_config=TModelConfig(**MODEL), params=params, device="cpu",
        engine_config=TEngineConfig(
            max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=64),
            scheduler=TSchedulerConfig(**SCHED),
        ),
    )
    got, tstats = _serve(tllm, TGenerator, TGeneratorArg, prompts, long_prompt)

    assert got == want
    assert tstats == jstats
    assert tstats[0] >= 1 and tstats[1] >= 1, "packed prefill and chunk chains must be in play"
    assert all(len(t) > 0 for t in got)



def test_warmup_runs_every_step_kind():
    """warmup drives each prefill bucket (single and packed) and a decode
    window, greedy and sampled, at the serving shapes."""
    tllm = TLLM(
        model_config=TModelConfig(**MODEL), params=_torch_params(), device="cpu",
        engine_config=TEngineConfig(
            max_model_len=64, cache=TCacheConfig(page_size=4, num_pages=64),
            scheduler=TSchedulerConfig(**SCHED),
        ),
    )
    ex = tllm.executor
    assert ex.warmup() >= 0.0
    assert all(pool.isfinite().all() for pool in ex.cache.k)
    assert ex._decode_carry is None
