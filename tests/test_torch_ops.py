"""The port's plain ops (zhilight_tpu_torch.ops and config adapters) against
the JAX package's, on the same numpy inputs, on the CPU.

Norms, activations, rope tables and rotations (default, the MiniCPM
configuration from the HF adapter, llama3, and the other scaling families,
neox and interleaved), sampling penalties, the sort-free top-k/top-p masks,
and whole sampling steps: greedy (tokens, logprobs, top-logprobs, penalty
counts) and sampled given the same uniforms. Tolerance: fp32 rtol = atol =
1e-4 unless a test says otherwise; masks and tokens must be equal.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import RopeConfig as JRopeConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt
from zhilight_tpu.ops import activations as JA
from zhilight_tpu.ops import norms as JN
from zhilight_tpu.ops import rope as JR
from zhilight_tpu.ops import sampling as JS
from zhilight_tpu_torch.config import RopeConfig as TRopeConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt
from zhilight_tpu_torch.ops import activations as TA
from zhilight_tpu_torch.ops import norms as TN
from zhilight_tpu_torch.ops import rope as TR
from zhilight_tpu_torch.ops import sampling as TS

RTOL = ATOL = 1e-4


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# config adapters
# ---------------------------------------------------------------------------

HF_CONFIGS = {
    "minicpm": dict(model_type="minicpm", hidden_size=2304, intermediate_size=5760,
                    num_hidden_layers=40, num_attention_heads=36, num_key_value_heads=36,
                    vocab_size=122753, max_position_embeddings=4096, rope_theta=10000.0,
                    rms_norm_eps=1e-5, scale_emb=12, dim_model_base=256, scale_depth=1.4),
    "llama3": dict(model_type="llama", hidden_size=4096, intermediate_size=14336,
                   num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                   vocab_size=128256, max_position_embeddings=131072, rope_theta=500000.0,
                   rope_scaling=dict(rope_type="llama3", factor=8.0, low_freq_factor=1.0,
                                     high_freq_factor=4.0,
                                     original_max_position_embeddings=8192)),
    "qwen2": dict(model_type="qwen2", hidden_size=896, intermediate_size=4864,
                  num_hidden_layers=24, num_attention_heads=14, num_key_value_heads=2,
                  vocab_size=151936, max_position_embeddings=32768, rope_theta=1000000.0,
                  tie_word_embeddings=True),
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_adapt_hf_config_matches_jax(name):
    assert dataclasses.asdict(t_adapt(HF_CONFIGS[name])) == dataclasses.asdict(j_adapt(HF_CONFIGS[name]))


# ---------------------------------------------------------------------------
# norms and activations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["rms_norm", "layer_norm", "qk_norm"])
def test_norms_match_jax(fn):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 4, 64).astype(np.float32) * 3
    w = rng.randn(64).astype(np.float32)
    _close(getattr(TN, fn)(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           getattr(JN, fn)(jnp.asarray(x), jnp.asarray(w), 1e-5))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_new", "relu"])
def test_gated_act_matches_jax(act):
    rng = np.random.RandomState(2)
    g, u = rng.randn(6, 48).astype(np.float32) * 2, rng.randn(6, 48).astype(np.float32)
    _close(TA.gated_act(torch.from_numpy(g), torch.from_numpy(u), act),
           JA.gated_act(jnp.asarray(g), jnp.asarray(u), act))


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

ROPES = {
    "default": (dict(), 10000.0),
    "minicpm": (None, None),  # from the adapter's MiniCPM config
    "llama3": (dict(type="llama3", factor=8.0, low_freq_factor=1.0, high_freq_factor=4.0,
                    original_max_position=512), 500000.0),
    "linear": (dict(type="linear", factor=4.0), 10000.0),
    "dynamic": (dict(type="dynamic", factor=2.0), 10000.0),
    "yarn": (dict(type="yarn", factor=4.0, mscale=0.707, mscale_all_dim=0.707,
                  original_max_position=256), 10000.0),
}


def _rope_tables(name, neox):
    kw, theta = ROPES[name]
    if kw is None:
        jcfg, tcfg = j_adapt(HF_CONFIGS["minicpm"]), t_adapt(HF_CONFIGS["minicpm"])
        jr, tr, theta, dim = jcfg.rope, tcfg.rope, jcfg.rope_theta, jcfg.dim_head
    else:
        jr, tr, dim = JRopeConfig(neox_style=neox, **kw), TRopeConfig(neox_style=neox, **kw), 64
    return (JR.build_rope_table(dim, theta, jr, 1024, 4096),
            TR.build_rope_table(dim, theta, tr, 1024, 4096), dim)


# the HF adapter always builds neox-style rope
ROPE_CASES = [(n, neox) for n in sorted(ROPES) for neox in (True, False) if neox or n != "minicpm"]


@pytest.mark.parametrize("name,neox", ROPE_CASES)
def test_rope_matches_jax(name, neox):
    jt, tt, dim = _rope_tables(name, neox)
    np.testing.assert_array_equal(tt.inv_freq, jt.inv_freq)
    assert tt.mscale == jt.mscale
    rng = np.random.RandomState(3)
    pos = rng.randint(0, 4000, size=9).astype(np.int32)
    x = rng.randn(9, 3, dim).astype(np.float32)
    jcos, jsin = jt.rot_values(jnp.asarray(pos))
    tcos, tsin = tt.rot_values(torch.from_numpy(pos))
    _close(tcos, jcos)
    _close(tsin, jsin)
    _close(TR.apply_rope_rot(torch.from_numpy(x), tcos, tsin, tt.neox_style),
           JR.apply_rope_rot(jnp.asarray(x), jcos, jsin, jt.neox_style))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

B, V = 6, 50


def _params(rng, greedy=False):
    p = dict(
        temperature=np.zeros(B, np.float32) if greedy else rng.uniform(0.5, 1.5, B).astype(np.float32),
        top_p=rng.uniform(0.3, 1.0, B).astype(np.float32),
        top_k=rng.choice([0, 1, 5, 20, 60], B).astype(np.int32),
        min_p=rng.choice([0.0, 0.05], B).astype(np.float32),
        repetition_penalty=rng.uniform(1.0, 1.5, B).astype(np.float32),
        presence_penalty=rng.uniform(0.0, 0.5, B).astype(np.float32),
        frequency_penalty=rng.uniform(0.0, 0.3, B).astype(np.float32),
        seed=np.arange(B, dtype=np.int32),
    )
    return (JS.SamplingParams(**{k: jnp.asarray(v) for k, v in p.items()}),
            TS.SamplingParams(**{k: torch.from_numpy(v) for k, v in p.items()}))


def _inputs(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    counts = rng.poisson(0.3, (B, V)).astype(np.int32)
    step = rng.randint(0, 9, B).astype(np.int32)
    return rng, logits, counts, step


def test_apply_penalties_matches_jax():
    rng, logits, counts, _ = _inputs(4)
    jp, tp = _params(rng)
    _close(TS.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), tp),
           JS.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), jp))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_top_k_top_p_mask_matches_jax(seed):
    rng, logits, _, _ = _inputs(seed)
    jp, tp = _params(rng)
    got = TS._top_k_top_p_mask(torch.from_numpy(logits), tp.top_k, tp.top_p)
    want = JS._top_k_top_p_mask(jnp.asarray(logits), jp.top_k, jp.top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_record_tokens_matches_jax():
    rng, _, counts, step = _inputs(8)
    tokens = np.array([3, 7, 3, -1, 49, -1], np.int32)
    for reset in (True, False):
        js = JS.record_tokens(JS.SamplerState(jnp.asarray(counts), jnp.asarray(step)), 2,
                              jnp.asarray(tokens), reset=reset)
        ts = TS.record_tokens(TS.SamplerState(torch.from_numpy(counts.copy()), torch.from_numpy(step.copy())),
                              2, torch.from_numpy(tokens), reset=reset)
        np.testing.assert_array_equal(ts.token_counts.numpy(), np.asarray(js.token_counts))
        np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))


def _maps(rng):
    bias_tok = np.full((B, 4), -1, np.int32)
    bias_tok[:, :2] = rng.randint(0, V, (B, 2))
    bias_val = rng.randn(B, 4).astype(np.float32) * 2
    pen_tok = np.full((B, 4), -1, np.int32)
    pen_tok[:, :3] = rng.randint(0, V, (B, 3))
    pen_val = rng.uniform(1.0, 2.0, (B, 4)).astype(np.float32)
    return bias_tok, bias_val, pen_tok, pen_val


@pytest.mark.parametrize("greedy_only", [False, True])
def test_greedy_sample_step_matches_jax(greedy_only):
    """Greedy slots (temperature 0) with penalties, bias and penalty maps:
    tokens, chosen logprobs, top-logprobs and the new counts."""
    rng, logits, counts, step = _inputs(9)
    jp, tp = _params(rng, greedy=True)
    maps = _maps(rng)
    jout = JS.sample_step(jnp.asarray(logits), JS.SamplerState(jnp.asarray(counts), jnp.asarray(step)),
                          jp, jax.random.PRNGKey(0), *(jnp.asarray(m) for m in maps),
                          num_logprobs=3, greedy_only=greedy_only)
    tout = TS.sample_step(torch.from_numpy(logits),
                          TS.SamplerState(torch.from_numpy(counts), torch.from_numpy(step)), tp,
                          uniforms=None if greedy_only else torch.full((B, V), 0.5),
                          logit_bias_tokens=torch.from_numpy(maps[0]),
                          logit_bias_values=torch.from_numpy(maps[1]),
                          penalty_tokens=torch.from_numpy(maps[2]),
                          penalty_values=torch.from_numpy(maps[3]),
                          num_logprobs=3, greedy_only=greedy_only)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    _close(tout[1], jout[1])
    _close(tout[2], jout[2])
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    np.testing.assert_array_equal(tout[4].token_counts.numpy(), np.asarray(jout[4].token_counts))
    np.testing.assert_array_equal(tout[4].step.numpy(), np.asarray(jout[4].step))


@pytest.mark.parametrize("seed", [10, 11])
def test_sampled_tokens_match_jax_given_uniforms(seed):
    """Sampled slots: the reference's penalties, top-k/top-p mask and min-p
    cut (JAX ops) plus Gumbel noise from the same uniforms choose the same
    tokens as the port's sample_step."""
    rng, logits, counts, step = _inputs(seed)
    jp, tp = _params(rng)
    u = rng.uniform(1e-20, 1.0, (B, V)).astype(np.float32)

    pen = JS.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), jp)
    scaled = pen / jnp.maximum(jp.temperature, 1e-6)[:, None]
    mask = JS._top_k_top_p_mask(scaled, jp.top_k, jp.top_p)
    cut = scaled.max(-1, keepdims=True) + jnp.log(jnp.maximum(jp.min_p, 1e-30))[:, None]
    mask = mask & ((scaled >= cut) | (jp.min_p[:, None] <= 0))
    want = np.argmax(np.where(np.asarray(mask), np.asarray(scaled), JS.NEG_INF)
                     - np.log(-np.log(u)), axis=-1)

    tok = TS.sample_step(torch.from_numpy(logits),
                         TS.SamplerState(torch.from_numpy(counts), torch.from_numpy(step)), tp,
                         uniforms=torch.from_numpy(u))[0]
    np.testing.assert_array_equal(tok.numpy(), want)


def test_sampling_generators_are_per_slot_and_reproducible():
    """A slot's draws depend on its own generator only."""
    rng, logits, counts, step = _inputs(12)
    _, tp = _params(rng)
    state = TS.SamplerState(torch.from_numpy(counts), torch.from_numpy(step))

    def run(seeds):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return TS.sample_step(torch.from_numpy(logits), state, tp, generators=gens)[0]

    a, b = run(range(B)), run([0, 1, 2, 99, 4, 5])
    assert torch.equal(a, run(range(B)))
    keep = [0, 1, 2, 4, 5]
    assert torch.equal(a[keep], b[keep])
