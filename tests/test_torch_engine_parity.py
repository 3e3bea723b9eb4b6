"""Scheduler and model features of the port's serving stack against the JAX
engine on the CPU, each case greedy and in fp32, from the same weights.

The model and scheduler are tests/test_torch_engine.py's (2 layers, head_dim
64: packed head-major pools; head_dim 16 where a case names it: slot-major
pools), changed only where a case says. Tokens and finish reasons must be
identical; scores (cumulative logprobs) and top logprobs agree to 1e-3 (fp32
sums in another order), over an int8 pool to 1e-2 of their size: off the TPU
the JAX engine attends over int8 rows dequantized and rounded to bf16, the
port rounds nothing (tests/test_torch_int8kv.py).
"""

import numpy as np
import pytest

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
from zhilight_tpu_torch.kvcache.allocator import PageAllocator
from zhilight_tpu_torch.llm import LLM as TLLM

VOCAB, EOS = 64, 1
MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)
TOL = 1e-3

_rng = np.random.RandomState(11)
PREFIX = list(_rng.randint(2, VOCAB, size=24))
PROMPTS = [list(_rng.randint(2, VOCAB, size=n)) for n in (5, 13, 21)]
# two rounds: the second shares the first's 24-token prefix
PREFIX_ROUNDS = [[PREFIX + [7, 9, 11]], [PREFIX + [13, 2, 5, 8], PREFIX + [30]]]

CASES = {
    "prefix_caching": dict(cache=dict(enable_prefix_caching=True), rounds=PREFIX_ROUNDS,
                           arg=dict(max_length=8)),
    "prefix_caching_int8": dict(cache=dict(enable_prefix_caching=True, kv_dtype="int8"),
                                rounds=PREFIX_ROUNDS, arg=dict(max_length=8)),
    "sliding_window": dict(model=dict(model_type="mistral", sliding_window=8),
                           arg=dict(max_length=12)),
    "sliding_window_slot_major": dict(model=dict(model_type="mistral", sliding_window=8,
                                                 dim_head=16), arg=dict(max_length=12)),
    "repetition_ngram": dict(arg=dict(max_length=10, repetition_penalty=1.3, ngram_penalty=1.2)),
    "presence_frequency": dict(arg=dict(max_length=10, presence_penalty=0.8,
                                        frequency_penalty=0.6)),
    "logit_bias_stop": dict(arg=dict(max_length=12, logit_bias={5: 3.0, 9: -100.0},
                                     stop_token_ids=[17, 33])),
    "ignore_eos_top_logprobs": dict(arg=dict(max_length=10, ignore_eos=True, top_logprobs=3)),
    "beam": dict(arg=dict(max_length=8, beam_size=3, num_results=2), rounds=[PROMPTS[1:2]]),
    "minicpm": dict(model=dict(model_type="cpm_dragonfly", scale_emb=12.0, scale_depth=1.4,
                               dim_model_base=16, tie_lm_head=True), arg=dict(max_length=10)),
    "attn_bias": dict(model=dict(model_type="qwen2", attn_bias=True), arg=dict(max_length=10)),
}


def _params(jcfg):
    """The JAX package's random weights; biases (zero at init) drawn too."""
    params = jax.device_get(JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.RandomState(3)

    def fill(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                fill(val)
            elif key == "b":
                tree[key] = (rng.randn(*val.shape) * 0.5).astype(np.float32)

    fill(params)
    return params


def _serve(llm, gen_cls, arg_cls, rounds, arg):
    out = []
    with gen_cls(llm) as gen:
        for prompts in rounds:
            for r in gen.batch_generate(prompts, [arg_cls(**arg) for _ in prompts], timeout=300):
                out.append([(o.token_ids, o.finish_reason, o.score, o.top_logprobs)
                            for o in r.outputs])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax_engine(case, monkeypatch):
    spec = CASES[case]
    hits = []  # tokens the port's prefix cache served, per admitted request
    match = PageAllocator.match_prefix

    def spy(self, tokens):
        pages, cached = match(self, tokens)
        hits.append(cached)
        return pages, cached

    monkeypatch.setattr(PageAllocator, "match_prefix", spy)
    model = dict(MODEL, **spec.get("model", {}))
    cache = dict(dict(page_size=4, num_pages=64), **spec.get("cache", {}))
    rounds, arg = spec.get("rounds", [PROMPTS]), spec["arg"]
    jcfg = JModelConfig(**model)
    params = _params(jcfg)
    jllm = JLLM(model_config=jcfg, params=params, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**SCHED)))
    tllm = TLLM(model_config=TModelConfig(**model), params=params, device="cpu",
                engine_config=TEngineConfig(max_model_len=64, cache=TCacheConfig(**cache),
                                            scheduler=TSchedulerConfig(**SCHED)))
    assert tllm.executor.cache.packed == jllm.executor.cache.packed
    want = _serve(jllm, JGenerator, JGeneratorArg, rounds, arg)
    got = _serve(tllm, TGenerator, TGeneratorArg, rounds, arg)
    tol = (lambda w: 1e-2 * max(1.0, abs(w))) if cache.get("kv_dtype") == "int8" else (lambda w: TOL)
    assert len(got) == len(want) == sum(map(len, rounds))
    for g_outs, w_outs in zip(got, want):
        assert len(g_outs) == len(w_outs)
        for (gt, gf, gs, gl), (wt, wf, ws, wl) in zip(g_outs, w_outs):
            assert (gt, gf) == (wt, wf)
            assert abs(gs - ws) < tol(ws)
            assert (gl is None) == (wl is None)
            for gd, wd in zip(gl or [], wl or []):
                assert gd.keys() == wd.keys()
                assert all(abs(gd[k] - wd[k]) < tol(wd[k]) for k in gd)
    if spec.get("cache", {}).get("enable_prefix_caching"):
        assert max(hits) >= 24 - 4, "the second round never hit the prefix cache"
    if arg.get("top_logprobs"):
        assert all(len(o[0][3]) == len(o[0][0]) for o in got)
