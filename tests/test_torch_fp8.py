"""The port's FP8 path (ops/quant.fp8_linear, ops/cuda/fp8_matmul's plain
version, utils/hf_loader's FP8 branch, params_to_torch) against the JAX
package on the CPU, and the slice as a whole on a tiny qwen3-style model whose
linears are FP8 with 128 x 128 block scales.

Inputs come from numpy seeds and reach both sides as numpy arrays (FP8 ones
as ``ml_dtypes.float8_e4m3fn``, which is what ``jax.device_get`` returns).
Tolerances: the plain ``fp8_block_matmul`` agrees with the Pallas kernel in
interpret mode within 1e-2 of the largest output (both round the output to
bf16 once; the fp32 sums run in another order) and exactly where every sum is
exact in fp32; ``fp8_linear`` off the accelerator dequantizes on both sides
and agrees to 1e-4 in fp32, and so do the model's logits; loader leaves are
bit-equal; greedy tokens are identical.
"""

import dataclasses
import json

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import DecodeMeta as JDecodeMeta
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.ops import quant as JQ
from zhilight_tpu.ops.pallas.fp8_matmul import fp8_block_matmul as j_fp8_block_matmul
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu_torch.config import CacheConfig as TCacheConfig
from zhilight_tpu_torch.config import EngineConfig as TEngineConfig
from zhilight_tpu_torch.config import ModelConfig as TModelConfig
from zhilight_tpu_torch.config import SchedulerConfig as TSchedulerConfig
from zhilight_tpu_torch.config import load_model_config as t_load_model_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.kvcache import new_kv_cache as t_new_kv_cache
from zhilight_tpu_torch.llm import LLM as TLLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import DecodeMeta as TDecodeMeta
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.ops.cuda import fp8_matmul as TF8
from zhilight_tpu_torch.ops.linear import linear
from zhilight_tpu_torch.utils.convert import params_to_torch, to_tensor

F8 = ml_dtypes.float8_e4m3fn
B = 128
S = 4  # page size


def block_quantize(w: np.ndarray, block: int = B):
    """fp32 [K, N] -> (e4m3 [K, N], f32 scales [K/block, N/block]), each
    block scaled to the format's largest value, 448."""
    K, N = w.shape
    blocks = w.reshape(K // block, block, N // block, block)
    s = (np.abs(blocks).max(axis=(1, 3)) / 448.0 + 1e-12).astype(np.float32)
    w8 = (blocks / s[:, None, :, None]).reshape(K, N).astype(F8)
    return w8, s


def _t(a):
    return to_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# the plain version of the kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 8, 40])
@pytest.mark.parametrize("K,N", [(128, 256), (256, 128), (256, 384), (384, 256), (384, 384)])
def test_plain_fp8_block_matmul_matches_pallas_interpret(M, K, N):
    rng = np.random.RandomState(M + K + N)
    w8 = (rng.randn(K, N) * 0.5).astype(np.float32).astype(F8)
    bs = (rng.rand(K // B, N // B) * 0.02 + 0.01).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32).astype(ml_dtypes.bfloat16)  # bf16-representable
    want = np.asarray(j_fp8_block_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(bs),
                                         interpret=True), np.float32)
    before = TF8.fp8_block_matmul.launches
    got = TF8.fp8_block_matmul(_t(x), _t(w8), _t(bs))
    assert TF8.fp8_block_matmul.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert np.abs(got.float().numpy() - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("M", [1, 8, 40])
def test_plain_fp8_block_matmul_is_exact_for_one_k_block(M):
    """K = 128 is one scale block: with small integer x and weights that are
    multiples of 0.25, every partial sum is exact in fp32 whatever its order,
    so the two sides agree bit for bit (fp32 x is cast to bf16 and back)."""
    rng = np.random.RandomState(M)
    K, N = 128, 384
    w8 = (rng.randint(-15, 16, size=(K, N)) * 0.25).astype(np.float32).astype(F8)
    bs = (rng.rand(1, N // B) * 0.02 + 0.01).astype(np.float32)
    x = rng.randint(-8, 9, size=(M, K)).astype(np.float32)
    want = np.asarray(j_fp8_block_matmul(jnp.asarray(x), jnp.asarray(w8), jnp.asarray(bs),
                                         interpret=True))
    got = TF8.fp8_block_matmul(_t(x), _t(w8), _t(bs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["block", "block64", "channel", "tensor"])
def test_fp8_linear_matches_jax(kind):
    """Off the accelerator both sides dequantize: block scales of 128 and of
    64 (no kernel takes those), a per-channel and a per-tensor scale; with a
    bias, through ops.linear."""
    rng = np.random.RandomState(5)
    K, N = 256, 384
    w = (rng.randn(K, N) * 0.05).astype(np.float32)
    x = rng.randn(4, K).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    if kind.startswith("block"):
        w8, s = block_quantize(w, 64 if kind == "block64" else B)
        scales = {"block_scale": s}
    else:
        s = (np.abs(w).max(axis=0) / 448.0).astype(np.float32) if kind == "channel" \
            else np.float32(np.abs(w).max() / 448.0)
        w8 = (w / s).astype(F8)
        scales = {"scale": np.asarray(s)}
    jp = {"w_f8": jnp.asarray(w8), **{k: jnp.asarray(v) for k, v in scales.items()}}
    want = np.asarray(JQ.fp8_linear(jp, jnp.asarray(x))) + b
    tp = {"w_f8": _t(w8), "b": _t(b), **{k: _t(v) for k, v in scales.items()}}
    got = linear(tp, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - b - x @ w).max() < 0.06 * np.abs(x @ w).max()  # and it is the matmul


def test_params_to_torch_keeps_quantized_leaves():
    """With a model dtype given, the payloads and fp32 scales of int8, FP8
    (an ml_dtypes array, as jax.device_get returns it) and int4 linears keep
    their dtypes and bits; dense leaves and biases are cast."""
    rng = np.random.RandomState(0)
    w8, bs = block_quantize(rng.randn(128, 256).astype(np.float32))
    w8_dev = jax.device_get(jnp.asarray(w8))
    assert w8_dev.dtype.name == "float8_e4m3fn"
    w_q = rng.randint(-127, 128, size=(64, 32)).astype(np.int8)
    f32 = lambda *shape: (rng.rand(*shape) * 1e-3 + 1e-5).astype(np.float32)  # not bf16 values
    params = {
        "dense": {"w": f32(8, 32), "b": f32(32)},
        "int8": {"w_q": w_q, "scale": f32(32), "smooth": f32(64), "b": f32(32)},
        "fp8_block": {"w_f8": w8_dev, "block_scale": bs, "b": f32(256)},
        "fp8_channel": {"w_f8": w8_dev, "scale": f32(256)},
        "experts": {"gate_proj": {"w_f8": np.stack([w8, w8]), "block_scale": np.stack([bs, bs])}},
        "int4": {"w_p": rng.randint(0, 16, size=(64, 32)).astype(np.int8), "scales": f32(2, 32),
                 "zeros": f32(2, 32), "perm": np.arange(64, dtype=np.int32)},
    }
    t = params_to_torch(params, "cpu", torch.bfloat16)
    assert t["dense"]["w"].dtype == torch.bfloat16 and t["dense"]["b"].dtype == torch.bfloat16
    for name, leaves in (("int8", ("scale", "smooth")), ("fp8_block", ("block_scale",)),
                         ("fp8_channel", ("scale",)), ("int4", ("scales", "zeros"))):
        for leaf in leaves:
            assert t[name][leaf].dtype == torch.float32, (name, leaf)
            np.testing.assert_array_equal(t[name][leaf].numpy(), params[name][leaf])
    assert t["int8"]["w_q"].dtype == torch.int8
    np.testing.assert_array_equal(t["int8"]["w_q"].numpy(), w_q)
    assert t["int8"]["b"].dtype == torch.bfloat16 and t["fp8_block"]["b"].dtype == torch.bfloat16
    for p in (t["fp8_block"], t["fp8_channel"]):
        assert p["w_f8"].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(p["w_f8"].view(torch.uint8).numpy(), w8.view(np.uint8))
    stack = t["experts"]["gate_proj"]
    assert stack["w_f8"].dtype == torch.float8_e4m3fn and stack["w_f8"].shape == (2, 128, 256)
    assert stack["block_scale"].dtype == torch.float32
    assert t["int4"]["w_p"].dtype == torch.int8 and t["int4"]["perm"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the slice as a whole: a tiny qwen3-style model with FP8-block linears
# ---------------------------------------------------------------------------

MODEL = dict(model_type="qwen3", num_layers=2, dim_model=128, num_heads=2, dim_head=64,
             num_kv_heads=2, dim_ff=256, vocab_size=97, qk_norm=True, dtype="float32")
LINEARS = {"attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
           "mlp": ("gate_proj", "up_proj", "down_proj")}
SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4, eos_id=1)


def _engine(cfg_cls, cache_cls, sched_cls):
    return cfg_cls(max_model_len=64, cache=cache_cls(page_size=S, num_pages=64),
                   scheduler=sched_cls(**SCHED))


@pytest.fixture(scope="module")
def fp8_model():
    """(numpy parameter tree with FP8-block linears, the dense tree it came from)."""
    jcfg = JModelConfig(**MODEL)
    dense = jax.device_get(JL.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.RandomState(0)
    for name in ("q_norm", "k_norm"):  # not all ones, so that the norms matter
        for layer in dense["layers"].values():
            layer["attn"][name]["w"] = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    fp8 = jax.tree.map(lambda a: a, dense)
    for layer in fp8["layers"].values():
        for part, names in LINEARS.items():
            for name in names:
                w8, bs = block_quantize(np.asarray(layer[part][name]["w"]))
                layer[part][name] = {"w_f8": w8, "block_scale": bs}
    return fp8, dense


def _logits_pair(jp, tp, n=21):
    """Prefill of ``n`` tokens (the last page partly filled), then one decode
    step, on both sides: ((jax, torch) prefill logits, (jax, torch) decode logits)."""
    jcfg, tcfg = JModelConfig(**MODEL), TModelConfig(**MODEL)
    jrope, trope = JL.build_rope(jcfg), TL.build_rope(tcfg)
    pages = n // S + 1
    toks = np.random.RandomState(1).randint(2, MODEL["vocab_size"], size=n + 1).astype(np.int32)
    pos, table = np.arange(n, dtype=np.int32), np.arange(pages, dtype=np.int32)
    jcache = j_new_kv_cache(2, pages, S, 2, 64, jnp.float32)
    tcache = t_new_kv_cache(2, pages, S, 2, 64, torch.float32, device="cpu")
    jm = JPrefillMeta(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(table), jnp.int32(0), jnp.int32(n))
    tm = TPrefillMeta(torch.from_numpy(pos), torch.from_numpy(pos), torch.from_numpy(table),
                      torch.tensor(0, dtype=torch.int32), torch.tensor(n, dtype=torch.int32))
    jl, jcache = JL.forward_prefill(jp, jcfg, jrope, jnp.asarray(toks[:n]), jm, jcache)
    tl, tcache = TL.forward_prefill(tp, tcfg, trope, torch.from_numpy(toks[:n]), tm, tcache)
    step = [np.array(a, np.int32) for a in ([n], [n], table[None], [n + 1])]
    jd, _ = JL.forward_decode(jp, jcfg, jrope, jnp.asarray(toks[n:]),
                              JDecodeMeta(*(jnp.asarray(a) for a in step)), jcache)
    td, _ = TL.forward_decode(tp, tcfg, trope, torch.from_numpy(toks[n:]),
                              TDecodeMeta(*(torch.from_numpy(a) for a in step)), tcache)
    return (np.asarray(jl), tl.numpy()), (np.asarray(jd), td.numpy())


def _serve(llm, gen_cls, arg_cls, prompts):
    with gen_cls(llm) as gen:
        res = gen.batch_generate(prompts, [arg_cls(max_length=10) for _ in prompts], timeout=300)
    return [r.outputs[0].token_ids for r in res]


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(2, MODEL["vocab_size"], size=n).tolist() for n in (3, 9, 18, 37)]


def test_fp8_model_logits_match_jax(fp8_model):
    fp8, dense = fp8_model
    jp, tp = jax.tree.map(jnp.asarray, fp8), params_to_torch(fp8, "cpu")
    q = tp["layers"]["0"]["attn"]["q_proj"]
    assert q["w_f8"].dtype == torch.float8_e4m3fn and q["block_scale"].shape == (1, 1)
    (jl, tl), (jd, td) = _logits_pair(jp, tp)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    # and FP8 changes the logits: the test above does not compare two dense models
    (dl, _), _ = _logits_pair(jax.tree.map(jnp.asarray, dense), tp)
    assert np.abs(dl - tl).max() > 1e-3


def test_fp8_model_greedy_tokens_match_jax_engine(fp8_model):
    """LLM + DynamicBatchGenerator over the FP8 tree; LLM carries it across
    with the model dtype given, and the FP8 leaves stay FP8."""
    fp8, _ = fp8_model
    jllm = JLLM(model_config=JModelConfig(**MODEL), params=jax.tree.map(jnp.asarray, fp8),
                engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig))
    tllm = TLLM(model_config=TModelConfig(**MODEL), params=fp8, device="cpu",
                engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig))
    down = tllm.executor.params["layers"]["1"]["mlp"]["down_proj"]
    assert down["w_f8"].dtype == torch.float8_e4m3fn and down["block_scale"].dtype == torch.float32
    want = _serve(jllm, JGenerator, JGeneratorArg, _prompts())
    got = _serve(tllm, TGenerator, TGeneratorArg, _prompts())
    assert got == want and all(len(t) > 0 for t in got)


HF_CONFIG = {
    "architectures": ["Qwen3ForCausalLM"], "model_type": "qwen3", "hidden_size": 128,
    "intermediate_size": 256, "num_hidden_layers": 2, "num_attention_heads": 2,
    "num_key_value_heads": 2, "head_dim": 64, "vocab_size": 97, "max_position_embeddings": 256,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "attention_bias": False, "torch_dtype": "bfloat16",
    "quantization_config": {"quant_method": "fp8", "fmt": "e4m3", "activation_scheme": "dynamic",
                            "weight_block_size": [128, 128]},
}


def hf_fp8_tensors(fp8, dense):
    """The FP8 tree as an official FP8 release names and lays it out: e4m3
    ``.weight`` [out, in] with f32 ``.weight_scale_inv`` [out/128, in/128]."""
    hf_names = {"attn": "self_attn", "mlp": "mlp"}
    out = [("model.embed_tokens.weight", dense["embedding"]["w"]),
           ("model.norm.weight", dense["final_norm"]["w"]),
           ("lm_head.weight", np.ascontiguousarray(dense["lm_head"]["w"].T))]
    for i, layer in fp8["layers"].items():
        pre = f"model.layers.{i}."
        out += [(pre + "input_layernorm.weight", layer["ln_attn"]["w"]),
                (pre + "post_attention_layernorm.weight", layer["ln_ff"]["w"]),
                (pre + "self_attn.q_norm.weight", layer["attn"]["q_norm"]["w"]),
                (pre + "self_attn.k_norm.weight", layer["attn"]["k_norm"]["w"])]
        for part, names in LINEARS.items():
            for name in names:
                p = layer[part][name]
                out.append((f"{pre}{hf_names[part]}.{name}.weight", np.ascontiguousarray(p["w_f8"].T)))
                out.append((f"{pre}{hf_names[part]}.{name}.weight_scale_inv",
                            np.ascontiguousarray(p["block_scale"].T)))
    return out


@pytest.fixture(scope="module")
def fp8_checkpoint(fp8_model, tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen3-fp8")
    tensors = hf_fp8_tensors(*fp8_model)
    torch.save({k: to_tensor(v) for k, v in tensors}, path / "pytorch_model.bin")
    (path / "config.json").write_text(json.dumps(HF_CONFIG))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": 1}))
    return str(path), tensors


@pytest.mark.parametrize("keep", [False, True])
def test_fp8_checkpoint_serves_like_jax(fp8_checkpoint, monkeypatch, keep):
    """LLM(model_path=...) on an FP8 checkpoint directory, dequantized at load
    and kept in FP8 (ZT_FP8_KEEP=1). The reference cannot read FP8 tensors
    from a torch ``.bin``, so it gets the same arrays through its own
    map_hf_params; logits 1e-4, greedy tokens identical."""
    path, tensors = fp8_checkpoint
    if keep:
        monkeypatch.setenv("ZT_FP8_KEEP", "1")
    else:
        monkeypatch.delenv("ZT_FP8_KEEP", raising=False)
    tcfg, tq, _ = t_load_model_config(path)
    assert tq.quant_type.name == "FP8_BLOCK" and tcfg.qk_norm
    tllm = TLLM(model_path=path, model_config=dataclasses.replace(tcfg, dtype="float32"),
                device="cpu", engine_config=_engine(TEngineConfig, TCacheConfig, TSchedulerConfig))
    jcfg = dataclasses.replace(j_adapt_hf_config(HF_CONFIG), dtype="float32")
    jparams = JH.map_hf_params(list(tensors), jcfg, quant_method="fp8")
    jllm = JLLM(model_config=jcfg, params=jparams,
                engine_config=_engine(JEngineConfig, JCacheConfig, JSchedulerConfig))
    q = tllm.executor.params["layers"]["0"]["attn"]["q_proj"]
    assert sorted(q) == (["block_scale", "w_f8"] if keep else ["w"])
    assert sorted(jparams["layers"]["0"]["attn"]["q_proj"]) == sorted(q)
    assert tllm.engine_config.scheduler.eos_id == 1
    (jl, tl), (jd, td) = _logits_pair(jllm.executor.params, tllm.executor.params)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    want = _serve(jllm, JGenerator, JGeneratorArg, _prompts())
    got = _serve(tllm, TGenerator, TGeneratorArg, _prompts())
    assert got == want and all(len(t) > 0 for t in got)
