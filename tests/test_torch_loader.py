"""The port's HF checkpoint path (utils/hf_loader + LLM(model_path=...))
against the JAX package's on a tiny Qwen2-style GPTQ/AWQ checkpoint, on the
CPU.

Geometry: 2 layers, dim 256, 4 heads of 64, 2 KV heads, ff 512, vocab 128,
group size 64, q/k/v biases, untied head. K = 256 takes the planar fast path
and head_dim 64 the packed head-major pool. The loaders must agree leaf by
leaf, bit for bit. End to end, both ``LLM(model_path=...)`` read a
``pytorch_model.bin`` + ``config.json`` written with ``torch.save``; in fp32
their first-token logits agree within 1e-4 (only the order of sums differs)
and their greedy tokens through ``DynamicBatchGenerator`` are identical.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import load_model_config as j_load_model_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.kvcache import new_kv_cache as j_new_kv_cache
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import llama as JL
from zhilight_tpu.models.base import PrefillMeta as JPrefillMeta
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu.utils.quant_convert import pack_awq, pack_gptq
from zhilight_tpu_torch.config import CacheConfig as TCacheConfig
from zhilight_tpu_torch.config import EngineConfig as TEngineConfig
from zhilight_tpu_torch.config import SchedulerConfig as TSchedulerConfig
from zhilight_tpu_torch.config import adapt_hf_config
from zhilight_tpu_torch.config import load_model_config as t_load_model_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator as TGenerator
from zhilight_tpu_torch.engine import GeneratorArg as TGeneratorArg
from zhilight_tpu_torch.kvcache import new_kv_cache as t_new_kv_cache
from zhilight_tpu_torch.llm import LLM as TLLM
from zhilight_tpu_torch.models import llama as TL
from zhilight_tpu_torch.models.base import PrefillMeta as TPrefillMeta
from zhilight_tpu_torch.utils import hf_loader as TH

D, H, HKV, DH, FF, V, GS = 256, 4, 2, 64, 512, 128, 64
EOS = 1
HF_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2", "hidden_size": D,
    "intermediate_size": FF, "num_hidden_layers": 2, "num_attention_heads": H,
    "num_key_value_heads": HKV, "vocab_size": V, "max_position_embeddings": 256,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16",
}
LINEARS = {
    "self_attn.q_proj": (D, H * DH), "self_attn.k_proj": (D, HKV * DH),
    "self_attn.v_proj": (D, HKV * DH), "self_attn.o_proj": (H * DH, D),
    "mlp.gate_proj": (D, FF), "mlp.up_proj": (D, FF), "mlp.down_proj": (FF, D),
}


def qwen2_state(method: str, seed: int = 0, act_order: bool = False):
    """HF-named tensors (numpy) of a tiny Qwen2 with GPTQ or AWQ linears.
    Scales are about 2/sqrt(K)/8 so the activations stay O(1)."""
    rng = np.random.RandomState(seed)
    out = [("model.embed_tokens.weight", (rng.randn(V, D) * 0.5).astype(np.float32))]
    for i in range(HF_CONFIG["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        for name, (K, N) in LINEARS.items():
            G = K // GS
            w = rng.randint(0, 16, size=(K, N)).astype(np.int8)
            scales = ((rng.rand(G, N) + 0.5) * (2.0 / np.sqrt(K) / 8)).astype(np.float16)
            zeros = rng.randint(1, 16, size=(G, N)).astype(np.float32)
            if method == "gptq":
                qw, qz, sc = pack_gptq(w, zeros, scales)
                g_idx = np.arange(K, dtype=np.int32) // GS
                if act_order and name == "mlp.up_proj":
                    g_idx = rng.permutation(g_idx).astype(np.int32)
                parts = dict(qweight=qw, qzeros=qz, scales=sc, g_idx=g_idx)
            else:
                qw, qz, sc = pack_awq(w, zeros, scales)
                parts = dict(qweight=qw, qzeros=qz, scales=sc)
            out += [(pre + name + "." + k, v) for k, v in parts.items()]
            if name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj"):
                out.append((pre + name + ".bias", (rng.randn(N) * 0.1).astype(np.float32)))
        out.append((pre + "input_layernorm.weight", (1 + 0.1 * rng.randn(D)).astype(np.float32)))
        out.append((pre + "post_attention_layernorm.weight",
                    (1 + 0.1 * rng.randn(D)).astype(np.float32)))
    out.append(("model.norm.weight", (1 + 0.1 * rng.randn(D)).astype(np.float32)))
    out.append(("lm_head.weight", (rng.randn(V, D) * 0.1).astype(np.float32)))
    return out


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("method,act_order,dtype", [
    ("gptq", False, "float32"), ("gptq", True, "float32"), ("gptq", False, "bfloat16"),
    ("awq", False, "float32"),
])
def test_map_hf_params_matches_reference(method, act_order, dtype):
    """Leaf by leaf: w_p bit-exact (uint8 planar), scales/zeros exact f32,
    perm exact, dense leaves bit-exact in the model dtype."""
    from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config

    cfg = dict(HF_CONFIG, torch_dtype=dtype)
    tensors = qwen2_state(method, act_order=act_order)
    want = dict(_leaves(JH.map_hf_params(tensors, j_adapt_hf_config(cfg), quant_method=method)))
    got = dict(_leaves(TH.map_hf_params(tensors, adapt_hf_config(cfg), quant_method=method)))
    assert sorted(got) == sorted(want)
    assert ("layers.0.mlp.up_proj.perm" in got) == act_order
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            g = g.view(torch.uint16)
        else:
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        np.testing.assert_array_equal(g.numpy(), _bits(w), err_msg=path)
    assert got["layers.0.attn.q_proj.w_p"].dtype == torch.uint8


def test_map_hf_params_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unmapped"):
        TH.map_hf_params([("model.layers.0.mlp.nonsense.weight", np.zeros((8, 8), np.float32))],
                         adapt_hf_config(HF_CONFIG))


@pytest.mark.parametrize("name", [
    "model.layers.3.mlp.gate.weight",                            # Qwen2-MoE / DeepSeek router
    "model.layers.3.mlp.gate.e_score_correction_bias",
    "model.layers.3.mlp.shared_expert.up_proj.weight",
    "model.layers.3.mlp.shared_experts.down_proj.weight",
    "model.layers.3.mlp.shared_expert_gate.weight",
    "model.layers.3.mlp.experts.7.down_proj.weight",
    "model.layers.3.block_sparse_moe.experts.0.w1.weight",       # Mixtral
    "model.layers.3.self_attn.kv_a_proj_with_mqa.weight",        # DeepSeek MLA
    "model.layers.3.self_attn.q_b_proj.weight",
])
def test_map_hf_names_of_moe_and_mla_match_jax(name):
    """The MoE and MLA names map to the reference's paths, transposes and
    expert indices (the leaves themselves are held equal in
    test_torch_moe.py); so do the dense names beside them."""
    assert TH.map_hf_name(name) == JH.map_hf_name(name)
    for dense in ("model.layers.3.mlp.gate_proj.weight", "model.layers.3.self_attn.q_proj.bias",
                  "model.layers.3.rotary_emb.inv_freq", "model.layers.3.unknown.weight"):
        assert TH.map_hf_name(dense) == JH.map_hf_name(dense)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("qwen2-gptq")
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in qwen2_state("gptq", seed=1)}
    torch.save(state, path / "pytorch_model.bin")
    cfg = dict(HF_CONFIG, quantization_config={
        "quant_method": "gptq", "bits": 4, "group_size": GS, "desc_act": False, "sym": True})
    (path / "config.json").write_text(json.dumps(cfg))
    (path / "generation_config.json").write_text(json.dumps({"eos_token_id": EOS}))
    return str(path)


SCHED = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4,
             prefill_pack=4)


def _first_token_logits(jllm, tllm, prompt):
    n = len(prompt)
    pages = (n + 3) // 4
    pos, table = np.arange(n, dtype=np.int32), np.arange(pages, dtype=np.int32)
    jcfg, tcfg = jllm.model_config, tllm.model_config
    jcache = j_new_kv_cache(jcfg.num_layers, pages, 4, jcfg.num_kv_heads, jcfg.dim_head, jnp.float32)
    tcache = t_new_kv_cache(tcfg.num_layers, pages, 4, tcfg.num_kv_heads, tcfg.dim_head,
                            torch.float32, device="cpu")
    jm = JPrefillMeta(jnp.asarray(pos), jnp.asarray(pos), jnp.asarray(table), jnp.int32(0), jnp.int32(n))
    tm = TPrefillMeta(torch.from_numpy(pos), torch.from_numpy(pos), torch.from_numpy(table),
                      torch.tensor(0, dtype=torch.int32), torch.tensor(n, dtype=torch.int32))
    toks = np.asarray(prompt, np.int32)
    jl, _ = JL.forward_prefill(jllm.executor.params, jcfg, JL.build_rope(jcfg), jnp.asarray(toks),
                               jm, jcache)
    tl, _ = TL.forward_prefill(tllm.executor.params, tcfg, TL.build_rope(tcfg),
                               torch.from_numpy(toks), tm, tcache)
    return np.asarray(jl), tl.numpy()


def test_llm_model_path_matches_reference(checkpoint):
    """LLM(model_path=...) in both packages, fp32: the same first-token
    logits and greedy tokens; the port keeps the int4 leaves and reads the
    EOS id from generation_config.json."""
    jcfg, jq, _ = j_load_model_config(checkpoint)
    tcfg, tq, _ = t_load_model_config(checkpoint)
    assert tq.quant_type.name == "GPTQ" and tq.group_size == GS
    jllm = JLLM(model_path=checkpoint, model_config=dataclasses.replace(jcfg, dtype="float32"),
                engine_config=JEngineConfig(max_model_len=64,
                                            cache=JCacheConfig(page_size=4, num_pages=64),
                                            scheduler=JSchedulerConfig(**SCHED)))
    tllm = TLLM(model_path=checkpoint, model_config=dataclasses.replace(tcfg, dtype="float32"),
                device="cpu",
                engine_config=TEngineConfig(max_model_len=64,
                                            cache=TCacheConfig(page_size=4, num_pages=64),
                                            scheduler=TSchedulerConfig(**SCHED)))
    assert tllm.engine_config.scheduler.eos_id == EOS == jllm.engine_config.scheduler.eos_id
    q = tllm.executor.params["layers"]["0"]["attn"]["q_proj"]
    assert q["w_p"].dtype == torch.uint8 and q["scales"].dtype == torch.float32
    assert q["b"].dtype == torch.float32

    rng = np.random.RandomState(0)
    prompts = [rng.randint(2, V, size=n).tolist() for n in (3, 9, 18, 37)]
    jl, tl = _first_token_logits(jllm, tllm, prompts[3])
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)

    def serve(llm, gen_cls, arg_cls):
        with gen_cls(llm) as gen:
            res = gen.batch_generate(prompts, [arg_cls(max_length=10) for _ in prompts], timeout=300)
        return [r.outputs[0].token_ids for r in res]

    want = serve(jllm, JGenerator, JGeneratorArg)
    got = serve(tllm, TGenerator, TGeneratorArg)
    assert got == want and all(len(t) > 0 for t in got)


# ---------------------------------------------------------------------------
# FP8 checkpoints
# ---------------------------------------------------------------------------

def _fp8_linear_tensors(seed=9, O=256, I=128, B=128):
    """tests/test_quant.py:322-333's tensors: one HF [out, in] e4m3 weight with
    its [out/B, in/B] ``weight_scale_inv``."""
    import ml_dtypes

    rng = np.random.RandomState(seed)
    w8 = rng.randn(O, I).astype(np.float32).astype(ml_dtypes.float8_e4m3fn)
    sc = rng.rand(O // B, I // B).astype(np.float32) * 0.05 + 0.01
    return w8, sc


def _assert_leaves_bit_equal(got, want):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w, g = np.asarray(w), got[path]
        if w.dtype.itemsize == 1 and w.dtype.kind not in "iu":  # FP8: by its bytes
            assert g.dtype == torch.float8_e4m3fn, path
            g, w = g.view(torch.uint8), w.view(np.uint8)
        elif w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            g, w = g.view(torch.uint16), w.view(np.uint16)
        else:
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("keep", [False, True])
def test_map_hf_params_fp8_matches_reference(monkeypatch, keep, dtype):
    """An FP8 linear through both loaders: dequantized at load by default
    (``w`` in the model dtype), kept as ``w_f8`` [in, out] + ``block_scale``
    [in/128, out/128] with ZT_FP8_KEEP=1; the weight as an ml_dtypes array and
    as a torch tensor."""
    from zhilight_tpu.config import ModelConfig as JModelConfig
    from zhilight_tpu_torch.config import ModelConfig as TModelConfig
    from zhilight_tpu_torch.utils.convert import to_tensor

    monkeypatch.setenv("ZT_FP8_KEEP", "1" if keep else "0")
    w8, sc = _fp8_linear_tensors()
    O, I = w8.shape
    kw = dict(model_type="llama", num_layers=1, dim_model=I, num_heads=4, dim_head=32,
              num_kv_heads=2, dim_ff=O, vocab_size=64, dtype=dtype)
    names = ("model.layers.0.mlp.gate_proj.weight", "model.layers.0.mlp.gate_proj.weight_scale_inv")
    want = dict(_leaves(JH.map_hf_params(list(zip(names, (w8, sc))), JModelConfig(**kw),
                                         strict=False, quant_method="fp8")))
    assert sorted(want) == (["layers.0.mlp.gate_proj.block_scale", "layers.0.mlp.gate_proj.w_f8"]
                            if keep else ["layers.0.mlp.gate_proj.w"])
    for weight in (w8, to_tensor(w8)):
        got = dict(_leaves(TH.map_hf_params(list(zip(names, (weight, sc))), TModelConfig(**kw),
                                            strict=False, quant_method="fp8")))
        _assert_leaves_bit_equal(got, want)
    if keep:
        assert got["layers.0.mlp.gate_proj.w_f8"].shape == (I, O)
        assert got["layers.0.mlp.gate_proj.block_scale"].shape == (I // 128, O // 128)
        # a kept weight needs 2-D block scales
        with pytest.raises(ValueError, match="ZT_FP8_KEEP=1 requires 2-D block scales"):
            TH.map_hf_params([(names[0], w8), (names[1][:-4], np.full(O, 0.5, np.float32))],
                             TModelConfig(**kw), strict=False, quant_method="fp8")


def test_map_hf_params_fp8_scale_without_fp8_weight_matches_reference():
    """A scale beside a weight that is not one byte wide: the weight goes
    through the dense rule and the scale is recorded as ``block_scale``."""
    from zhilight_tpu.config import ModelConfig as JModelConfig
    from zhilight_tpu_torch.config import ModelConfig as TModelConfig

    w8, sc = _fp8_linear_tensors()
    kw = dict(model_type="llama", num_layers=1, dim_model=128, num_heads=4, dim_head=32,
              num_kv_heads=2, dim_ff=256, vocab_size=64, dtype="float32")
    tensors = [("model.layers.0.mlp.gate_proj.weight", w8.astype(np.float32)),
               ("model.layers.0.mlp.gate_proj.weight_scale_inv", sc)]
    want = dict(_leaves(JH.map_hf_params(tensors, JModelConfig(**kw), strict=False, quant_method="fp8")))
    got = dict(_leaves(TH.map_hf_params(tensors, TModelConfig(**kw), strict=False, quant_method="fp8")))
    assert sorted(want) == ["layers.0.mlp.gate_proj.block_scale", "layers.0.mlp.gate_proj.w"]
    _assert_leaves_bit_equal(got, want)


def test_fp8_dequant_host_scale_layouts_match_reference():
    """Block (2-D), per-channel (1-D) and per-tensor (0-D) scales, and none;
    a 3-D scale is a ValueError on both sides (tests/test_quant.py:351-372)."""
    w8, sc = _fp8_linear_tensors(seed=3, O=256, I=128)
    O = w8.shape[0]
    for scale in (sc, np.full(O, 0.25, np.float32), np.float32(0.5), None):
        for jdtype, tdtype in ((None, None), (np.float32, torch.float32)):
            want = JH._fp8_dequant_host(w8, scale, jdtype)
            got = TH._fp8_dequant_host(w8, scale, tdtype)
            _assert_leaves_bit_equal({"w": got}, {"w": want})
    for mod in (JH, TH):
        with pytest.raises(ValueError, match="fp8 weight_scale"):
            mod._fp8_dequant_host(w8, np.ones((2, 2, 2), np.float32), None)


@pytest.mark.parametrize("keep", [False, True])
def test_fp8_expert_stack_matches_reference(monkeypatch, keep):
    """Per-expert FP8 tensors of a MoE layer: dequantized at load they stack
    to the reference's dense ``w`` [E, in, out] and run; kept in FP8 they
    stack to ``w_f8`` [E, in, out] + ``block_scale``, which ``moe_layer``
    refuses in both packages (no FP8 expert kernel)."""
    from zhilight_tpu.config import ModelConfig as JModelConfig
    from zhilight_tpu.config import MoEConfig as JMoEConfig
    from zhilight_tpu.models.moe import moe_layer as j_moe_layer
    from zhilight_tpu_torch.config import ModelConfig as TModelConfig
    from zhilight_tpu_torch.config import MoEConfig as TMoEConfig
    from zhilight_tpu_torch.models.moe import moe_layer as t_moe_layer

    monkeypatch.setenv("ZT_FP8_KEEP", "1" if keep else "0")
    E, Dm, FFe = 4, 128, 256
    rng = np.random.RandomState(7)
    tensors = [("model.layers.0.mlp.gate.weight", rng.randn(E, Dm).astype(np.float32))]
    for e in range(E):
        for name, (O, I) in (("gate_proj", (FFe, Dm)), ("up_proj", (FFe, Dm)), ("down_proj", (Dm, FFe))):
            w8, sc = _fp8_linear_tensors(seed=10 * e + len(name), O=O, I=I)
            pre = f"model.layers.0.mlp.experts.{e}.{name}."
            tensors += [(pre + "weight", w8), (pre + "weight_scale_inv", sc * 0.05)]
    kw = dict(model_type="qwen2_moe", num_layers=1, dim_model=Dm, num_heads=2, dim_head=64,
              num_kv_heads=2, dim_ff=FFe, vocab_size=64, dtype="float32")
    moe = dict(num_experts=E, top_k=2, intermediate_size=FFe)
    jcfg, tcfg = JModelConfig(**kw, moe=JMoEConfig(**moe)), TModelConfig(**kw, moe=TMoEConfig(**moe))
    jtree = JH.map_hf_params(tensors, jcfg, strict=False, quant_method="fp8")
    ttree = TH.map_hf_params(tensors, tcfg, strict=False, quant_method="fp8")
    want, got = dict(_leaves(jtree)), dict(_leaves(ttree))
    _assert_leaves_bit_equal(got, want)
    stack = "layers.0.mlp.experts.down_proj."
    assert got[stack + ("w_f8" if keep else "w")].shape == (E, FFe, Dm)
    x = rng.randn(5, Dm).astype(np.float32)
    jmlp, tmlp = jtree["layers"]["0"]["mlp"], ttree["layers"]["0"]["mlp"]
    if keep:
        assert got[stack + "block_scale"].shape == (E, FFe // 128, Dm // 128)
        with pytest.raises(ValueError, match="unknown expert weight format"):
            j_moe_layer(jmlp, jcfg, jnp.asarray(x))
        with pytest.raises(ValueError, match="unknown expert weight format"):
            t_moe_layer(tmlp, tcfg, torch.from_numpy(x))
    else:
        np.testing.assert_allclose(t_moe_layer(tmlp, tcfg, torch.from_numpy(x)).numpy(),
                                   np.asarray(j_moe_layer(jmlp, jcfg, jnp.asarray(x))),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tie", [False, True])
def test_safetensors_checkpoint_leaves_match_reference(tmp_path, tie):
    """A tiny llama written by ``transformers``' ``save_pretrained`` as
    safetensors: the port's ``iter_safetensors`` yields the reference's
    tensors, and ``load_hf_state`` the reference's leaves, bit for bit (a
    tied head drops ``lm_head`` in both)."""
    transformers = pytest.importorskip("transformers")
    pytest.importorskip("safetensors")
    hf_cfg = transformers.LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, vocab_size=97, max_position_embeddings=128,
        tie_word_embeddings=tie, torch_dtype="float32")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(hf_cfg).save_pretrained(tmp_path, safe_serialization=True)
    assert any(p.suffix == ".safetensors" for p in tmp_path.iterdir())
    path = str(tmp_path)

    want = dict(JH.iter_safetensors(path))
    got = dict(TH.iter_safetensors(path))
    assert sorted(got) == sorted(want) and len(got) == 2 + 9 * 2 + (not tie)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)

    want = dict(_leaves(JH.load_hf_state(path, j_load_model_config(path)[0])))
    got = dict(_leaves(TH.load_hf_state(path, t_load_model_config(path)[0])))
    assert ("lm_head.w" in got) == (not tie)
    _assert_leaves_bit_equal(got, want)
