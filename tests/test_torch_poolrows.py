"""The port's pool-row operations and what rests on them, on the CPU: swap and
recompute preemption, ``swap_out_rows`` / ``swap_in_rows``, ``copy_slots``
(beam search), the scoring utilities (``calc_*``: ``run_score`` /
``run_hidden``) and sessions, each for a pool in the model's dtype and, where
the rows carry scales, for an int8 pool.

The JAX package's own tests of these paths (tests/test_preemption.py,
test_beam_search.py, test_scoring.py, test_sessions.py) run a head_dim 8 model
on slot-major pools; here both packages run one tiny fp32 model with head_dim
64 (packed head-major pools) from the same weights (tests/test_torch_slotmajor.py
holds beam search and swap preemption over slot-major pools). Tokens must be identical; logits and hidden states agree to
rtol = atol = 1e-4 (fp32 sums in another order).
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
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, ModelConfig, SchedulerConfig
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg, SessionGenerator
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
VOCAB, EOS = 64, 1
MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
ROOMY = dict(max_batch=8, max_total_token=2048, chunk_size=32,
             prefill_buckets=(8, 16, 32, 128), eos_id=EOS)


@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig(**MODEL)
    jparams = JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    return jcfg, jparams, ModelConfig(**MODEL), params_to_torch(jax.device_get(jparams), "cpu")


@pytest.fixture(scope="module")
def jax_llm(weights):
    """The JAX engine with room for everything: the reference for unpreempted
    tokens, beam results and scores."""
    jcfg, jparams, _, _ = weights
    return JLLM(model_config=jcfg, params=jparams, engine_config=JEngineConfig(
        max_model_len=128, cache=JCacheConfig(page_size=4, num_pages=256),
        scheduler=JSchedulerConfig(**ROOMY)))


def roomy_llm(weights, kv_dtype="bfloat16", **sched_kw):
    _, _, cfg, params = weights
    return LLM(model_config=cfg, params=params, device="cpu", engine_config=EngineConfig(
        max_model_len=128, cache=CacheConfig(page_size=4, num_pages=256, kv_dtype=kv_dtype),
        scheduler=SchedulerConfig(**dict(ROOMY, **sched_kw))))


@pytest.fixture(scope="module")
def llm(weights):
    return roomy_llm(weights)


def pressure_llm(weights, mode, kv_dtype="bfloat16", **kw):
    """8 pages x 4 = 32 KV tokens, optimistic admission: two (7-token prompt,
    20 new tokens) requests need 54, so the newer one is preempted."""
    _, _, cfg, params = weights
    sched = dict(max_batch=4, chunk_size=8, prefill_buckets=(8, 16, 32), eos_id=EOS,
                 ignore_eos=True, admission_reserve=0.2, preempt_mode=mode, session_ttl=0.0)
    sched.update(kw)
    return LLM(model_config=cfg, params=params, device="cpu", engine_config=EngineConfig(
        max_model_len=64, cache=CacheConfig(page_size=4, num_pages=8, kv_dtype=kv_dtype),
        scheduler=SchedulerConfig(**sched)))


def _tokens(results):
    return [r.outputs[0].token_ids for r in results]


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["swap", "recompute"])
@pytest.mark.parametrize("multi_step", [0, 4])
def test_preemption_gives_the_unpreempted_outputs(weights, jax_llm, mode, multi_step):
    """Two over-admitted requests: the newer is preempted (swapped to the
    host, or dropped and recomputed), and both still return the tokens the
    JAX engine gives with room for both; with 4-step decode windows too."""
    rng = np.random.RandomState(21 + multi_step)
    prompts = [list(rng.randint(2, VOCAB, size=n)) for n in ((7, 7) if not multi_step else (6, 9))]
    new = 20 if not multi_step else 18
    with JGenerator(jax_llm) as gen:
        want = _tokens(gen.batch_generate(prompts, JGeneratorArg(max_length=new, ignore_eos=True)))
    kw = dict(decode_multi_step=multi_step) if multi_step else {}
    with DynamicBatchGenerator(pressure_llm(weights, mode, **kw)) as gen:
        got = _tokens(gen.batch_generate(prompts, GeneratorArg(max_length=new)))
        n_pre = gen.scheduler.num_preemptions
    assert got == want
    assert all(len(t) == new for t in got)
    assert n_pre >= 1, "pool pressure never triggered a preemption"


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preemption_with_an_int8_pool(weights, mode):
    """The same pressure over an int8 pool: the swapped rows carry their
    scales, so the outputs are those of the int8 engine with room for both."""
    rng = np.random.RandomState(23)
    prompts = [list(rng.randint(2, VOCAB, size=7)) for _ in range(2)]
    arg = GeneratorArg(max_length=20, ignore_eos=True)
    with DynamicBatchGenerator(roomy_llm(weights, "int8")) as gen:
        want = _tokens(gen.batch_generate(prompts, arg))
        assert gen.scheduler.num_preemptions == 0
    with DynamicBatchGenerator(pressure_llm(weights, mode, "int8")) as gen:
        got = _tokens(gen.batch_generate(prompts, arg))
        n_pre = gen.scheduler.num_preemptions
    assert got == want
    assert n_pre >= 1


def test_conservative_admission_never_preempts(weights):
    rng = np.random.RandomState(24)
    prompts = [list(rng.randint(2, VOCAB, size=5)) for _ in range(4)]
    with DynamicBatchGenerator(pressure_llm(weights, "swap", admission_reserve=1.0)) as gen:
        gen.batch_generate(prompts, GeneratorArg(max_length=16))
        assert gen.scheduler.num_preemptions == 0


# ---------------------------------------------------------------------------
# swap_out_rows / swap_in_rows, copy_slots
# ---------------------------------------------------------------------------

def _written_llm(weights, kv_dtype):
    """An executor whose pages 0-1 hold a real generation's rows."""
    _, _, cfg, params = weights
    llm = LLM(model_config=cfg, params=params, device="cpu", engine_config=EngineConfig(
        max_model_len=64, cache=CacheConfig(page_size=4, num_pages=8, kv_dtype=kv_dtype),
        scheduler=SchedulerConfig(max_batch=2, chunk_size=8, prefill_buckets=(8, 16),
                                  eos_id=EOS)))
    with DynamicBatchGenerator(llm) as gen:
        gen.generate(list(range(2, 9)), GeneratorArg(max_length=2))
    return llm.executor


def _snapshot(cache):
    return [[arr.clone() for arr in arrays] for arrays in cache.arrays()]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_swap_rows_round_trip(weights, kv_dtype):
    """Rows 0-7 out to the host and back into rows 16-23, in every layer: the
    pool and, for int8, both scale arrays, against direct indexing."""
    ex = _written_llm(weights, kv_dtype)
    assert ex.cache.quantized == (kv_dtype == "int8")
    assert len(ex.cache.arrays()) == (3 if kv_dtype == "int8" else 1)
    rows_a = np.arange(0, 8, dtype=np.int32)
    rows_b = np.arange(16, 24, dtype=np.int32)
    before = _snapshot(ex.cache)
    assert all(arr[:, :8].any() for arrays in before for arr in arrays), "rows were never written"
    ex._decode_carry = ("stale",)
    data = ex.swap_out_rows(rows_a)
    for arrays, saved in zip(before, data):
        for arr, host in zip(arrays, saved):
            assert host.device.type == "cpu" and torch.equal(host, arr[:, rows_a])
    ex.swap_in_rows(rows_b, data)
    assert ex._decode_carry is None
    for arrays, now in zip(before, ex.cache.arrays()):
        for arr, cur in zip(arrays, now):
            assert torch.equal(cur[:, rows_b], arr[:, rows_a])
            untouched = np.setdiff1d(np.arange(arr.shape[1]), rows_b)
            assert torch.equal(cur[:, untouched], arr[:, untouched])


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_copy_slots_carries_rows_and_scales(weights, kv_dtype):
    ex = _written_llm(weights, kv_dtype)
    before = _snapshot(ex.cache)
    src = np.array([0, 1, 2, 3, 5], np.int32)
    dst = np.array([20, 21, 22, 23, -1], np.int32)  # the last pair is skipped
    ex._decode_carry = ("stale",)
    ex.copy_slots(src, dst)
    assert ex._decode_carry is None
    for arrays, now in zip(before, ex.cache.arrays()):
        for arr, cur in zip(arrays, now):
            assert torch.equal(cur[:, dst[:4]], arr[:, src[:4]])
            untouched = np.setdiff1d(np.arange(arr.shape[1]), dst[:4])
            assert torch.equal(cur[:, untouched], arr[:, untouched])


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beam,num_results,max_new", [(2, 1, 6), (3, 2, 8)])
def test_beam_search_matches_jax_engine(jax_llm, llm, beam, num_results, max_new):
    rng = np.random.RandomState(4)
    prompt = list(rng.randint(2, VOCAB, size=7))
    kw = dict(beam_size=beam, num_results=num_results, max_length=max_new)
    with JGenerator(jax_llm) as gen:
        want = [(o.token_ids, o.score) for o in gen.generate(prompt, JGeneratorArg(**kw)).outputs]
    with DynamicBatchGenerator(llm) as gen:
        got = [(o.token_ids, o.score) for o in gen.generate(prompt, GeneratorArg(**kw)).outputs]
    assert len(got) == len(want) >= 1
    for (gt, gs), (wt, ws) in zip(got, want):
        assert gt == wt
        assert abs(gs - ws) < 1e-3


def test_beam_search_over_an_int8_pool_finishes(weights):
    """Beam copies move int8 rows with their scales: the result of a beam
    request does not depend on which slots the beams were copied through."""
    rng = np.random.RandomState(5)
    prompt = list(rng.randint(2, VOCAB, size=9))
    arg = GeneratorArg(beam_size=3, num_results=2, max_length=6)
    outs = []
    for max_batch in (8, 4):
        with DynamicBatchGenerator(roomy_llm(weights, "int8", max_batch=max_batch)) as gen:
            outs.append([(o.token_ids, round(o.score, 5)) for o in gen.generate(prompt, arg).outputs])
    assert outs[0] == outs[1] and len(outs[0]) == 2


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def test_calc_logits_and_hidden_states_match_jax(jax_llm, llm):
    toks = [5, 9, 12, 33, 17, 40, 2]
    want, got = jax_llm.calc_logits(toks), llm.calc_logits(toks)
    assert got.shape == (len(toks), VOCAB) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    want, got = jax_llm.calc_hidden_states(toks), llm.calc_hidden_states(toks)
    assert got.shape == (len(toks), MODEL["dim_model"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_calc_log_prob_loss_and_greedy_match_match_jax(jax_llm, llm):
    toks = [5, 9, 12, 33, 17, 40, 2]
    labels = [9, 12, 33, 17]
    for lab in (None, labels):
        wt, wp = jax_llm.calc_log_prob(toks[: len(lab)] if lab else toks, lab)
        gt, gp = llm.calc_log_prob(toks[: len(lab)] if lab else toks, lab)
        assert len(gp) == len(wp)
        np.testing.assert_allclose(gp, wp, rtol=RTOL, atol=ATOL)
        assert abs(gt - wt) < 1e-3
    assert abs(llm.calc_loss(toks) - jax_llm.calc_loss(toks)) < 1e-4
    assert llm.calc_loss(toks) > 0
    assert llm.calc_greedy_match(toks) == jax_llm.calc_greedy_match(toks)
    assert llm.calc_greedy_match(toks[:4], labels) == jax_llm.calc_greedy_match(toks[:4], labels)


def test_scoring_a_prompt_longer_than_the_largest_bucket(jax_llm, llm):
    cap = llm.executor.sched_cfg.prefill_buckets[-1]
    toks = list(np.random.RandomState(7).randint(2, 60, size=cap + 5))
    want, got = jax_llm.calc_logits(toks), llm.calc_logits(toks)
    assert got.shape == (cap + 5, VOCAB)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_scoring_leaves_serving_state_alone_and_refuses_strings(weights):
    """run_score works on a scratch cache in the model's dtype, also beside an
    int8 serving pool, which it does not touch."""
    llm8 = roomy_llm(weights, "int8")
    before = _snapshot(llm8.executor.cache)
    got = llm8.calc_logits([5, 9, 12, 33])
    np.testing.assert_allclose(got, roomy_llm(weights).calc_logits([5, 9, 12, 33]), rtol=0, atol=0)
    for arrays, now in zip(before, llm8.executor.cache.arrays()):
        assert all(torch.equal(a, b) for a, b in zip(arrays, now))
    with pytest.raises(ValueError, match="no tokenizer for string input"):
        llm8.calc_logits("a string")


def test_output_hidden_states_of_a_request(llm):
    toks = [5, 9, 17, 23]
    hs = llm.calc_hidden_states(toks)
    with llm.generator() as gen:
        res = gen.generate(toks, GeneratorArg(max_length=4, output_hidden_states=True))
    assert res.hidden_states is not None and len(res.hidden_states) == 1
    full = res.hidden_states[0]
    assert full.shape == (len(toks) + len(res.outputs[0].token_ids), MODEL["dim_model"])
    np.testing.assert_allclose(full[: len(toks)], hs, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_session_resume_equals_fresh_generation(weights, llm, kv_dtype):
    rng = np.random.RandomState(7)
    turn1 = list(rng.randint(2, VOCAB, size=9))
    turn2 = list(rng.randint(2, VOCAB, size=6))
    model = llm if kv_dtype == "bfloat16" else roomy_llm(weights, "int8")
    with DynamicBatchGenerator(model) as gen:
        with SessionGenerator(gen) as sess:
            out1 = sess.generate(turn1, GeneratorArg(max_length=4)).outputs[0].token_ids
            assert sess.context_len == len(turn1) + len(out1)
            out2 = sess.generate(turn2, GeneratorArg(max_length=4)).outputs[0].token_ids
        fresh = gen.generate(turn1 + out1 + turn2, GeneratorArg(max_length=4))
    assert out2 == fresh.outputs[0].token_ids


def test_session_rollback(llm):
    rng = np.random.RandomState(8)
    base = list(rng.randint(2, VOCAB, size=8))
    spec = list(rng.randint(2, VOCAB, size=3))
    tail = list(rng.randint(2, VOCAB, size=4))
    with DynamicBatchGenerator(llm) as gen:
        with SessionGenerator(gen) as sess:
            sess.feed(base)
            sess.feed(spec)                            # speculative tokens
            sess.rollback_speculative(len(spec) + 1)   # + feed's probe token, not in the history
            assert sess.context_len == len(base) - 1
            with pytest.raises(ValueError):
                sess.rollback_speculative(len(base))
            r = sess.generate(tail, GeneratorArg(max_length=4))
        fresh = gen.generate(base[:-1] + tail, GeneratorArg(max_length=4))
    assert r.outputs[0].token_ids == fresh.outputs[0].token_ids


def test_session_close_releases_pages(llm):
    with DynamicBatchGenerator(llm) as gen:
        free0 = gen.scheduler.allocator.num_free
        sess = SessionGenerator(gen)
        sess.generate([5, 9, 12, 33], GeneratorArg(max_length=3))
        assert gen.scheduler.allocator.num_free < free0
        sess.close()
        assert gen.scheduler.allocator.num_free == free0
