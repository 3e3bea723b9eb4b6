"""``ZT_STACK=1`` in the port against the JAX package's on the CPU.

The JAX package's switch stacks a homogeneous model's layers and scans one
layer body over one layer-major pool (``zhilight_tpu/models/stacked.py``), so
that XLA compiles a program whose size does not grow with depth; it promises
the per-layer loop's tokens (tests/test_stacked.py). The port has no second
layout: under the switch it serves from its per-layer pools and paths.

- The engine under ``ZT_STACK=1``: greedy tokens equal the JAX engine's under
  ``ZT_STACK=1`` (its fused chunk meta, packed prefill and window side-KV
  off) and the port's run without the switch, the port keeping its per-layer
  pool and those three paths; ``ZT_FUSED_KV=1`` over a slot-major pool
  against the JAX engine under both switches (its fused kernel in interpret
  mode).
- Pool rows: under ``ZT_STACK=1`` the reference's ``copy_slots``,
  ``swap_out_rows`` and ``swap_in_rows`` move layer 0's region of its
  layer-major pool only (a recorded difference, pinned here on its pool and
  in its tokens); the port's move every layer's rows
  (tests/test_torch_poolrows.py), and its beam search and swap preemption
  under the switch give the JAX per-layer engine's tokens.
"""

import copy
import json

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
from zhilight_tpu.ops.pallas import paged_attention as JPA
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.engine.engine import ModelExecutor
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.utils.convert import params_to_torch

VOCAB, EOS = 64, 1
BASE = dict(model_type="llama", num_layers=3, dim_model=64, num_heads=4, dim_head=64,
            num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")


def _weights(model, seed=0):
    """The JAX package's random weights of ``model`` as numpy (a fresh tree
    each call), with both packages' configs."""
    key = json.dumps(model, sort_keys=True)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = jax.device_get(JL.init_params(JModelConfig(**model),
                                                      jax.random.PRNGKey(seed), jnp.float32))
    return JModelConfig(**model), copy.deepcopy(_WEIGHTS[key]), ModelConfig(**model)


_WEIGHTS = {}


def _interpret_jax(m, kernels):
    """The JAX model's Pallas branch on the CPU: the switch on and
    ``kernels`` run in interpret mode (an inner call passes it on)."""
    m.setattr(JL, "_use_pallas_decode", lambda *a, **kw: True)
    inside = []
    for module, name in kernels:
        def interpret(*a, _fn=getattr(module, name), **kw):
            if inside:
                return _fn(*a, **kw)
            inside.append(1)
            try:
                return _fn(*a, **dict(kw, interpret=True))
            finally:
                inside.pop()
        m.setattr(module, name, interpret)


# ---------------------------------------------------------------------------
# the engine under ZT_STACK=1
# ---------------------------------------------------------------------------

SCHED = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=EOS)
_rng = np.random.RandomState(11)
PROMPTS = [[int(t) for t in _rng.randint(2, VOCAB, size=n)] for n in (5, 7, 21, 30)]
# name -> model overrides, cache overrides, environment of both packages
ENGINE = {
    # the three gated paths asked for: window side-KV, packed prefill (pack
    # 4) and the fused chunk meta (prompts of several chunks)
    "packed": ({}, {}, {"ZT_WINDOW_KV": "1"}),
    "int8": ({}, dict(kv_dtype="int8"), {}),
    # the fused write + attend over a slot-major pool
    "slot_major_fused": (dict(dim_head=16), {}, {"ZT_FUSED_KV": "1"}),
}


def _tokens(llm, gen_cls, arg_cls, prompts, **arg):
    with gen_cls(llm) as gen:
        res = gen.batch_generate(prompts, [arg_cls(**arg) for _ in prompts], timeout=300)
    return [[(o.token_ids, o.score) for o in r.outputs] for r in res]


def _count(m, counts, owner, name):
    fn = getattr(owner, name)

    def counted(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*a, **kw)

    m.setattr(owner, name, counted)


def _port_run(tcfg, params, cache, sched, env, stack, monkeypatch, prompts, max_model_len=64,
              **arg):
    """The port's tokens with ``env`` (and ZT_STACK=1 where ``stack``), and
    the calls of the paths the reference turns off under ZT_STACK=1. The
    port keeps its per-layer pool either way."""
    counts = {}
    with monkeypatch.context() as m:
        for key, value in dict(env, **({"ZT_STACK": "1"} if stack else {})).items():
            m.setenv(key, value)
        for owner, name in ((ModelExecutor, "run_prefill_packed"),
                            (ModelExecutor, "run_chunk_fused"),
                            (TL, "forward_decode_window")):
            _count(m, counts, owner, name)
        llm = LLM(model_config=tcfg, params=params, device="cpu", engine_config=EngineConfig(
            max_model_len=max_model_len, cache=CacheConfig(**cache),
            scheduler=SchedulerConfig(**sched)))
        cache_ = llm.executor.cache
        assert cache_.num_layers == tcfg.num_layers and cache_.num_pages == cache["num_pages"]
        got = _tokens(llm, DynamicBatchGenerator, GeneratorArg, prompts, **arg)
    return got, counts, llm


def _same(got, want, tol=1e-3):
    """Identical tokens, scores within ``tol`` (fp32 sums in another order)."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert [t for t, _ in g] == [t for t, _ in w]
        assert all(abs(gs - ws) < tol * max(1.0, abs(ws)) for (_, gs), (_, ws) in zip(g, w))
    assert any(len(t) > 1 for outs in got for t, _ in outs)


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_stacked_tokens_match_reference(name, monkeypatch):
    model, cache_kw, env = ENGINE[name]
    jcfg, jparams, tcfg = _weights(dict(BASE, **model))
    cache = dict(page_size=4, num_pages=64, **cache_kw)
    jax_calls = {}
    with monkeypatch.context() as m:
        m.setenv("ZT_STACK", "1")
        for key, value in env.items():
            m.setenv(key, value)
        if "ZT_FUSED_KV" in env:
            _interpret_jax(m, [(JPA, "paged_decode_attention_fused")])
            _count(m, jax_calls, JPA, "paged_decode_attention_fused")
        jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
            max_model_len=64, cache=JCacheConfig(**cache), scheduler=JSchedulerConfig(**SCHED)))
        assert jllm.executor.stacked and jllm.executor.cache.num_layers == 1
        want = _tokens(jllm, JGenerator, JGeneratorArg, PROMPTS, max_length=10)
    params = params_to_torch(jparams, "cpu")
    got, on, llm = _port_run(tcfg, params, cache, SCHED, env, True, monkeypatch, PROMPTS,
                             max_length=10)
    layered, off, _ = _port_run(tcfg, params, cache, SCHED, env, False, monkeypatch, PROMPTS,
                                max_length=10)
    _same(got, want, 1e-2 if cache_kw else 1e-3)  # int8: as tests/test_torch_int8kv.py
    assert got == layered and on == off
    if name == "packed":  # the paths the reference turns off run in the port
        assert all(on.get(p, 0) > 0 for p in ("run_prefill_packed", "run_chunk_fused",
                                               "forward_decode_window")), on
    if name == "slot_major_fused":
        ex = llm.executor
        assert ex.fused_kv and not ex.cache.packed and jax_calls


# ---------------------------------------------------------------------------
# pool rows
# ---------------------------------------------------------------------------

def test_reference_copies_layer_zero_only_when_stacked(monkeypatch):
    """The recorded difference: the JAX executor's pool-row operations under
    ZT_STACK=1 index the one layer-major pool with the scheduler's slot
    numbers, so they move layer 0's region only
    (zhilight_tpu/engine/engine.py:742-824); the port, per layer under the
    switch, moves every layer's (tests/test_torch_poolrows.py)."""
    jcfg, jparams, _ = _weights(BASE)
    monkeypatch.setenv("ZT_STACK", "1")
    jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=16),
        scheduler=JSchedulerConfig(max_batch=2, chunk_size=8, prefill_buckets=(8,))))
    ex = jllm.executor
    pool = ex.cache.k[0]
    assert ex.stacked and ex.cache.num_layers == 1 and pool.shape[1] == 3 * 64
    ex.cache = ex.cache.set_layer(0, k=jnp.arange(pool.size, dtype=pool.dtype).reshape(pool.shape))
    ex.copy_slots(np.arange(4, 8), np.arange(8, 12))
    got = np.asarray(ex.cache.k[0])
    regions = [got[:, l * 64:(l + 1) * 64] for l in range(3)]
    assert np.array_equal(regions[0][:, 8:12], regions[0][:, 4:8])
    for r in regions[1:]:
        assert not np.array_equal(r[:, 8:12], r[:, 4:8])
    swapped = ex.swap_out_rows(np.arange(20, 24))
    assert swapped.k[0].shape[1] == 4  # layer 0's rows, none of the other layers'


PRESSURE_PROMPTS = [[int(t) for t in np.random.RandomState(21).randint(2, VOCAB, size=7)]
                    for _ in range(2)]
PRESSURE = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                ignore_eos=True, session_ttl=0.0)
BEAM_PROMPT = [5, 9, 12, 33, 17, 40, 8, 3, 22]
ROOMY = dict(max_batch=8, max_total_token=2048, chunk_size=32, prefill_buckets=(8, 16, 32, 128),
             eos_id=EOS)


@pytest.fixture(scope="module")
def pool_weights():
    return _weights(BASE)


@pytest.fixture(scope="module")
def jax_roomy(pool_weights):
    """The JAX per-layer engine with room for every request, for the beams."""
    jcfg, jparams, _ = pool_weights
    return JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=128, cache=JCacheConfig(page_size=4, num_pages=256),
        scheduler=JSchedulerConfig(**ROOMY)))


def _jax_beam(jllm, **arg):
    with JGenerator(jllm) as gen:
        res = gen.generate(BEAM_PROMPT, JGeneratorArg(**arg), timeout=300)
    return [[(o.token_ids, o.score) for o in res.outputs]]


def _jax_tokens(jcfg, jparams, monkeypatch, stack, cache, sched, prompts, **arg):
    with monkeypatch.context() as m:
        if stack:
            m.setenv("ZT_STACK", "1")
        jllm = JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
            max_model_len=64 if len(prompts) > 1 else 128, cache=JCacheConfig(**cache),
            scheduler=JSchedulerConfig(**sched)))
        with JGenerator(jllm) as gen:
            res = gen.batch_generate(prompts, [JGeneratorArg(**arg) for _ in prompts],
                                     timeout=300)
            preempted = gen.scheduler.num_preemptions
    return [[(o.token_ids, o.score) for o in r.outputs] for r in res], preempted


def test_swap_preemption_stacked_matches_reference(pool_weights, monkeypatch):
    """Two requests in 8 pages of 4: the newer one is swapped out and back.
    The port under ZT_STACK=1 gives the JAX engine's unpreempted tokens; the
    JAX engine under ZT_STACK=1 swaps layer 0's rows only, and the preempted
    request's tokens part from them (the recorded difference, in tokens)."""
    jcfg, jparams, tcfg = pool_weights
    roomy = dict(PRESSURE, admission_reserve=1.0)
    tight = dict(PRESSURE, admission_reserve=0.2, preempt_mode="swap")
    want, _ = _jax_tokens(jcfg, jparams, monkeypatch, False, dict(page_size=4, num_pages=64),
                          roomy, PRESSURE_PROMPTS, max_length=20)
    params = params_to_torch(jparams, "cpu")
    with monkeypatch.context() as m:
        m.setenv("ZT_STACK", "1")
        llm = LLM(model_config=tcfg, params=params, device="cpu", engine_config=EngineConfig(
            max_model_len=64, cache=CacheConfig(page_size=4, num_pages=8),
            scheduler=SchedulerConfig(**tight)))
        with DynamicBatchGenerator(llm) as gen:
            res = gen.batch_generate(PRESSURE_PROMPTS, GeneratorArg(max_length=20), timeout=300)
            preempted = gen.scheduler.num_preemptions
    assert llm.executor.cache.num_layers == 3 and preempted >= 1
    got = [[(o.token_ids, o.score) for o in r.outputs] for r in res]
    _same(got, want)
    ref, ref_preempted = _jax_tokens(jcfg, jparams, monkeypatch, True,
                                     dict(page_size=4, num_pages=8), tight, PRESSURE_PROMPTS,
                                     max_length=20)
    assert ref_preempted >= 1
    assert ref[0][0][0] == want[0][0][0] and ref[1][0][0] != want[1][0][0]


@pytest.mark.parametrize("beam,num_results,max_new", [(2, 1, 6), (3, 2, 8)])
def test_beam_search_stacked_matches_reference(pool_weights, jax_roomy, beam, num_results,
                                               max_new, monkeypatch):
    """Beam search's copy-on-write under ZT_STACK=1 against the JAX
    per-layer engine (the JAX engine under ZT_STACK=1 copies layer 0's rows
    only: at beam 3 its beams part from the per-layer engine's)."""
    jcfg, jparams, tcfg = pool_weights
    arg = dict(beam_size=beam, num_results=num_results, max_length=max_new)
    cache = dict(page_size=4, num_pages=256)
    want = _jax_beam(jax_roomy, **arg)
    got, _, _ = _port_run(tcfg, params_to_torch(jparams, "cpu"), cache, ROOMY, {}, True,
                          monkeypatch, [BEAM_PROMPT], max_model_len=128, **arg)
    _same(got, want)
    assert len(got[0]) == num_results
    if beam == 3:
        ref, _ = _jax_tokens(jcfg, jparams, monkeypatch, True, cache, ROOMY, [BEAM_PROMPT], **arg)
        assert [t for t, _ in ref[0]] != [t for t, _ in want[0]]
