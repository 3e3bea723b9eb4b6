"""The port's W8A8 int8 / SmoothQuant path (ops/quant's int8 half,
utils/quant_convert's int8 half, utils/calibrate, LLM's AUTO_INT8 branch,
``calc_act_scales`` and ``load_with_smooth_quant``) against the JAX package on
the CPU.

Inputs come from numpy seeds and reach both sides as numpy arrays.
Tolerances: int8 codes are equal and scales agree to an fp32 ulp (the same
fp32 arithmetic in the same order); ``int8_linear`` agrees within 1e-5 of the
largest output (the integer product is exact; the two fp32 scalings round
alike); calibration statistics within 1e-4; the logits of the int8 models
quantized from the same activation scales within 1e-3 of the largest logit,
row by row, on all rows but a few: an activation that falls on a rounding
boundary takes the neighbouring code on one side (the frameworks' fp32 sums
differ in the last bit), and after SmoothQuant's migration most channels
hold codes of 0 to 2, so one such code moves that token's and the later
tokens' logits by a few percent; those rows are held to 5e-2. Greedy tokens
are identical.
"""

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
from zhilight_tpu.config import load_model_config as j_load_model_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.ops import quant as JQ
from zhilight_tpu.utils import calibrate as JCal
from zhilight_tpu.utils import quant_convert as JC
from zhilight_tpu_torch.config import CacheConfig as TCacheConfig
from zhilight_tpu_torch.config import EngineConfig as TEngineConfig
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import SchedulerConfig as TSchedulerConfig
from zhilight_tpu_torch.config import load_model_config as t_load_model_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.llm import LLM as TLLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.ops import quant as TQ
from zhilight_tpu_torch.utils import calibrate as TCal
from zhilight_tpu_torch.utils import quant_convert as TC
from zhilight_tpu_torch.utils.convert import params_to_torch

ULP = dict(rtol=2e-7, atol=0)
VOCAB = 64
# tests/test_smooth_quant.py's model, at head_dim 64 (the packed head-major pool)
MODEL = dict(model_type="llama", num_layers=2, dim_model=64, num_heads=4, dim_head=64,
             num_kv_heads=2, dim_ff=128, vocab_size=VOCAB, dtype="float32")
SCHED = dict(max_batch=2, chunk_size=16, prefill_buckets=(16, 32), eos_id=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


# ---------------------------------------------------------------------------
# ops/quant: the int8 half
# ---------------------------------------------------------------------------

def test_quantize_int8_weight_matches_jax():
    w = np.random.RandomState(0).randn(96, 40).astype(np.float32) * 0.1
    w[:, 3] = 0  # a zero column takes the floor scale
    jq, js = JQ.quantize_int8_weight(jnp.asarray(w))
    tq, ts = TQ.quantize_int8_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **ULP)


@pytest.mark.parametrize("shape", [(5, 96), (2, 3, 64)])
def test_quantize_act_per_token_matches_jax(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32) * 3
    x[0] = 0  # an all-zero token takes the floor scale
    x[1].flat[:4] = [0.5, 1.5, 2.5, -2.5]
    x[1].flat[4] = 127.0  # scale 1 on this token: the halves above round to even
    jq, js = JQ._quantize_act_per_token(jnp.asarray(x))
    tq, ts = TQ._quantize_act_per_token(_t(x))
    assert tq.dtype == torch.int8 and ts.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **ULP)


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("lead", [(1,), (16,), (2, 5)])
def test_int8_linear_matches_jax(lead, smooth):
    rng = np.random.RandomState(2)
    K, N = 128, 72
    x = rng.randn(*lead, K).astype(np.float32)
    x[..., 5] *= 50.0  # an activation outlier channel
    q = JC.auto_int8_from_fp(rng.randn(K, N).astype(np.float32) * 0.05)
    p = dict(q, b=rng.randn(N).astype(np.float32))
    if smooth:
        p["smooth"] = (rng.rand(K) + 0.5).astype(np.float32)
    want = np.asarray(JQ.int8_linear({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))
    got = TQ.int8_linear({k: _t(v) for k, v in p.items()}, _t(x))
    assert got.dtype == torch.float32 and got.shape == lead + (N,)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# utils/quant_convert: the int8 half
# ---------------------------------------------------------------------------

def test_auto_int8_and_smooth_quant_weights_match_jax():
    rng = np.random.RandomState(3)
    w = rng.randn(128, 64).astype(np.float32) * 0.05
    act = np.abs(rng.randn(128)).astype(np.float32) * 4
    act[7] = 0  # a dead channel takes the floor
    want, got = JC.auto_int8_from_fp(w), TC.auto_int8_from_fp(_t(w))
    np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
    np.testing.assert_allclose(got["scale"].numpy(), want["scale"], **ULP)
    for alpha in (0.5, 0.8):
        jw, js = JC.smooth_quant_weights(w, act, alpha)
        tw, ts = TC.smooth_quant_weights(_t(w), act, alpha)
        assert ts.dtype == torch.float32 and tw.dtype == torch.float32
        np.testing.assert_allclose(ts.numpy(), js, **ULP)
        np.testing.assert_allclose(tw.numpy(), jw, **ULP)


@pytest.fixture(scope="module")
def model():
    params = jax.device_get(JL.init_params(JModelConfig(**MODEL), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.RandomState(4)
    params["layers"]["0"]["attn"]["q_proj"]["b"] = rng.randn(256).astype(np.float32) * 0.1
    calib = [rng.randint(2, VOCAB, size=32).astype(np.int32) for _ in range(3)]
    jcfg = JModelConfig(**MODEL)
    scales = JCal.calc_act_scales(jax.tree.map(jnp.asarray, params), jcfg, JL.build_rope(jcfg), calib)
    return params, calib, scales


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_int8_params_matches_jax(model, calibrated):
    """The same leaves quantized (the seven dense linears of each layer, 2-D
    weights only, expert stacks and everything else untouched, a bias kept),
    w_q equal, scale and smooth to an fp32 ulp."""
    params, _, scales = model
    tree = dict(params, extra={"experts": {"down_proj": {"w": np.ones((2, 8, 8), np.float32)}},
                               "q_proj": {"w": np.ones((3, 8, 8), np.float32)}})
    act = scales if calibrated else None
    want = dict(_leaves(JC.quantize_int8_params(tree, act, alpha=0.5)))
    got = dict(_leaves(TC.quantize_int8_params(params_to_torch(tree, "cpu"), act, alpha=0.5)))
    assert sorted(got) == sorted(want)
    assert ("layers.0.attn.q_proj.smooth" in got) == calibrated
    assert "layers.0.attn.q_proj.b" in got and "layers.1.mlp.down_proj.w_q" in got
    assert "embedding.w" in got and "extra.experts.down_proj.w" in got and "extra.q_proj.w" in got
    for path, w in want.items():
        w, g = np.asarray(w), got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path.endswith((".scale", ".smooth")):
            np.testing.assert_allclose(g, w, err_msg=path, **ULP)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# utils/calibrate
# ---------------------------------------------------------------------------

def test_calc_act_scales_matches_jax(model):
    params, calib, want = model
    tcfg = TModelConfig(**MODEL)
    tp = params_to_torch(params, "cpu")
    got = TCal.calc_act_scales(tp, tcfg, TL.build_rope(tcfg), calib)
    assert sorted(got) == sorted(want) and len(got) == 2 * 7
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4, err_msg=k)
    # one sequence's statistics are what the running maximum starts from
    one = TCal.calib_forward(tp, tcfg, TL.build_rope(tcfg), torch.from_numpy(calib[0]))
    assert sorted(one) == sorted(want)
    assert all((one[k].numpy() <= got[k] + 1e-6).all() for k in one)


# ---------------------------------------------------------------------------
# the slice as a whole: W8A8 serving
# ---------------------------------------------------------------------------

def _engine(cfg_cls, cache_cls, sched_cls):
    return cfg_cls(max_model_len=64, cache=cache_cls(page_size=4, num_pages=64),
                   scheduler=sched_cls(**SCHED))


def _llms(jparams, tparams):
    jllm = JLLM(model_config=JModelConfig(**MODEL), params=jparams,
                engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig))
    tllm = TLLM(model_config=TModelConfig(**MODEL), params=tparams, device="cpu",
                engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig))
    return jllm, tllm


def _assert_same_serving(jllm, tllm):
    rng = np.random.RandomState(1)
    probe = rng.randint(2, VOCAB, size=20).astype(np.int32)
    want, got = jllm.calc_logits(probe), tllm.calc_logits(probe)
    rows = np.abs(got - want).max(axis=1) / np.abs(want).max()
    assert (rows <= 1e-3).sum() >= len(probe) - 3 and rows.max() <= 5e-2, rows
    prompts = [rng.randint(2, VOCAB, size=n).tolist() for n in (5, 19)]
    tokens = []
    for llm, gen_cls, arg_cls in ((jllm, JGenerator, JGeneratorArg), (tllm, TGenerator, TGeneratorArg)):
        with gen_cls(llm) as gen:
            res = gen.batch_generate(prompts, [arg_cls(max_length=8) for _ in prompts], timeout=300)
        tokens.append([r.outputs[0].token_ids for r in res])
    assert tokens[0] == tokens[1] and all(len(t) > 0 for t in tokens[1])
    return got


@pytest.mark.parametrize("calibrated", [False, True])
def test_int8_model_matches_jax(model, calibrated):
    """The int8 models quantized on each side from the same activation scales
    (or none: AutoInt8): logits within 1e-3 of the largest, greedy tokens
    identical; and int8 stays near the fp32 model."""
    params, _, scales = model
    act = scales if calibrated else None
    jq = JC.quantize_int8_params(params, act, 0.5)
    tq = TC.quantize_int8_params(params_to_torch(params, "cpu"), act, 0.5)
    jllm, tllm = _llms(jq, tq)
    q = tllm.executor.params["layers"]["0"]["attn"]["q_proj"]
    assert q["w_q"].dtype == torch.int8 and q["scale"].dtype == torch.float32
    assert ("smooth" in q) == calibrated
    got = _assert_same_serving(jllm, tllm)
    ref = TLLM(model_config=TModelConfig(**MODEL), params=params, device="cpu",
               engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig))
    probe = np.random.RandomState(1).randint(2, VOCAB, size=20).astype(np.int32)
    fp = ref.calc_logits(probe)
    assert np.abs(got - fp).max() < 0.08 * np.abs(fp).max()


@pytest.fixture(scope="module")
def dense_checkpoint(model, tmp_path_factory):
    """An HF-format llama directory of the dense model (torch ``.bin``)."""
    params, _, _ = model
    path = tmp_path_factory.mktemp("llama-dense")
    names = {"attn": "self_attn", "mlp": "mlp"}
    state = {"model.embed_tokens.weight": params["embedding"]["w"],
             "model.norm.weight": params["final_norm"]["w"],
             "lm_head.weight": params["lm_head"]["w"].T}
    for i, layer in params["layers"].items():
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = layer["ln_attn"]["w"]
        state[pre + "post_attention_layernorm.weight"] = layer["ln_ff"]["w"]
        for part, hf in names.items():
            for name, p in layer[part].items():
                state[f"{pre}{hf}.{name}.weight"] = p["w"].T
                if "b" in p:
                    state[f"{pre}{hf}.{name}.bias"] = p["b"]
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
               path / "pytorch_model.bin")
    cfg = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "hidden_size": 64,
           "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 64, "vocab_size": VOCAB,
           "max_position_embeddings": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
           "tie_word_embeddings": False, "attention_bias": True, "torch_dtype": "float32"}
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": 1}))
    return str(path), cfg


def test_auto_int8_model_path_matches_jax(dense_checkpoint, tmp_path):
    """``quantization_config`` {"quant_method": "int8"} is AUTO_INT8: both
    packages quantize the raw weights to W8A8 after loading them."""
    path, cfg = dense_checkpoint
    cfg = dict(cfg, quantization_config={"quant_method": "int8"})
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    for name in ("pytorch_model.bin", "generation_config.json"):
        (tmp_path / name).symlink_to(f"{path}/{name}")
    _, jq, _ = j_load_model_config(str(tmp_path))
    _, tq, _ = t_load_model_config(str(tmp_path))
    assert jq.quant_type.name == tq.quant_type.name == "AUTO_INT8"
    jllm = JLLM(model_path=str(tmp_path), model_config=JModelConfig(**MODEL, attn_bias=True),
                engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig))
    tllm = TLLM(model_path=str(tmp_path), model_config=TModelConfig(**MODEL, attn_bias=True),
                device="cpu", engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig))
    for name, p in tllm.executor.params["layers"]["1"]["mlp"].items():
        assert p["w_q"].dtype == torch.int8 and "smooth" not in p, name
        np.testing.assert_array_equal(
            p["w_q"].numpy(), np.asarray(jllm.executor.params["layers"]["1"]["mlp"][name]["w_q"]))
    assert tllm.executor.params["layers"]["0"]["attn"]["q_proj"]["b"].dtype == torch.float32
    assert "w" in tllm.executor.params["lm_head"]
    _assert_same_serving(jllm, tllm)


def test_load_with_smooth_quant_matches_jax(dense_checkpoint, model):
    """Load, calibrate on token-id prompts (tiled to calib_len), quantize,
    rebuild on the same device: the smooth vectors agree with the reference's
    to 1e-4, the logits within 1e-3 of the largest, greedy tokens identical."""
    path, _ = dense_checkpoint
    _, calib, _ = model
    prompts = [c[:20].tolist() for c in calib]
    jllm = JLLM.load_with_smooth_quant(
        path, prompts, engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig),
        alpha=0.5, calib_len=32, model_config=JModelConfig(**MODEL, attn_bias=True))
    tllm = TLLM.load_with_smooth_quant(
        path, prompts, engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig),
        alpha=0.5, calib_len=32, device="cpu", model_config=TModelConfig(**MODEL, attn_bias=True))
    assert tllm.device.type == "cpu" and tllm.engine_config.scheduler.eos_id == 1
    for i in ("0", "1"):
        for part in ("attn", "mlp"):
            for name, p in tllm.executor.params["layers"][i][part].items():
                ref = jllm.executor.params["layers"][i][part][name]
                assert p["w_q"].dtype == torch.int8, (i, name)
                np.testing.assert_allclose(p["smooth"].numpy(), np.asarray(ref["smooth"]),
                                           rtol=1e-4, err_msg=f"{i}.{name}")
    with pytest.raises(ValueError, match="calibration"):
        tllm.calc_act_scales([[]])
    _assert_same_serving(jllm, tllm)
