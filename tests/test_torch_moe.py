"""The port's MoE path against the JAX package on the CPU, in fp32: routing
(``select_experts``), ``moe_layer`` over dense, int4 and act-order int4 expert
stacks, and the HF loader's MoE and MLA leaves (DeepSeek, Qwen2-MoE and Mixtral
names; GPTQ experts with and without ``desc_act``).

Expert weights reach both packages through their own ``map_hf_params`` from
the same HF-named numpy tensors, so every ``moe_layer`` case also holds the
loaders' leaves equal, bit for bit. Tolerances: expert ids equal and routing
weights 1e-6; ``moe_layer`` 1e-4 against the JAX dequantize-and-grouped-dot
path (fp32 sums in another order) and 2e-2 of the largest output against the
JAX Pallas kernel in interpret mode, which rounds the activations to bf16.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from zhilight_tpu.config import CacheConfig as JCacheConfig
from zhilight_tpu.config import EngineConfig as JEngineConfig
from zhilight_tpu.config import MoEConfig as JMoEConfig
from zhilight_tpu.config import SchedulerConfig as JSchedulerConfig
from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config
from zhilight_tpu.config import load_model_config as j_load_model_config
from zhilight_tpu.engine import DynamicBatchGenerator as JGenerator
from zhilight_tpu.engine import GeneratorArg as JGeneratorArg
from zhilight_tpu.llm import LLM as JLLM
from zhilight_tpu.models import moe as JM
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu.utils.quant_convert import pack_gptq
from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
from zhilight_tpu_torch.config import MoEConfig as TMoEConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt_hf_config
from zhilight_tpu_torch.config import load_model_config as t_load_model_config
from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import moe as TM
from zhilight_tpu_torch.utils import hf_loader as TH
from zhilight_tpu_torch.utils.convert import params_to_torch

RTOL = ATOL = 1e-4
T = torch.from_numpy


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTING = {
    "greedy": dict(num_experts=8, top_k=2, norm_topk_prob=True),
    "greedy-unnormalized": dict(num_experts=8, top_k=3, norm_topk_prob=False,
                                routed_scaling_factor=1.5),
    "group_limited_greedy": dict(num_experts=8, top_k=2, n_group=4, topk_group=2,
                                 topk_method="group_limited_greedy", norm_topk_prob=False),
    "noaux_tc": dict(num_experts=16, top_k=4, n_group=4, topk_group=2, topk_method="noaux_tc",
                     scoring_func="sigmoid", norm_topk_prob=True, routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_select_experts_matches_jax(case):
    kw = ROUTING[case]
    rng = np.random.RandomState(len(case))
    logits = rng.randn(11, kw["num_experts"]).astype(np.float32) * 2
    bias = (rng.randn(kw["num_experts"]) * 0.5).astype(np.float32)
    want_w, want_ids = JM.select_experts(jnp.asarray(logits), JMoEConfig(**kw), jnp.asarray(bias))
    got_w, got_ids = TM.select_experts(T(logits), TMoEConfig(**kw), T(bias))
    assert got_ids.dtype == torch.int32 and got_w.dtype == torch.float32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-6)


def test_select_experts_refuses_an_unknown_score():
    with pytest.raises(ValueError):
        TM.select_experts(torch.zeros(2, 4), TMoEConfig(num_experts=4, scoring_func="tanh"))


# ---------------------------------------------------------------------------
# HF tensors of one MoE layer, in three naming schemes
# ---------------------------------------------------------------------------

D, F, E, GS = 256, 256, 4, 128


def _hf_config(family, **kw):
    base = dict(hidden_size=D, num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=4,
                intermediate_size=2 * F, vocab_size=64, rms_norm_eps=1e-6,
                max_position_embeddings=256, torch_dtype="float32", tie_word_embeddings=False)
    if family == "deepseek":
        base.update(model_type="deepseek_v2", moe_intermediate_size=F, n_routed_experts=E,
                    n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=0,
                    moe_layer_freq=1, norm_topk_prob=False, scoring_func="softmax",
                    topk_method="greedy", n_group=1, topk_group=1, routed_scaling_factor=1.0,
                    q_lora_rank=None, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                    v_head_dim=16)
    elif family == "qwen2_moe":
        base.update(model_type="qwen2_moe", moe_intermediate_size=F, num_experts=E,
                    num_experts_per_tok=2, shared_expert_intermediate_size=F, norm_topk_prob=True,
                    decoder_sparse_step=1, mlp_only_layers=[])
    else:
        base.update(model_type="mixtral", intermediate_size=F, num_local_experts=E,
                    num_experts_per_tok=2)
    base.update(kw)
    return base


def _gptq(rng, K, N, act_order=False):
    G = K // GS
    nib = rng.randint(0, 16, size=(K, N)).astype(np.int8)
    scales = ((rng.rand(G, N) + 0.5) * (2.0 / np.sqrt(K) / 8)).astype(np.float32)
    zeros = rng.randint(1, 16, size=(G, N)).astype(np.float32)
    qw, qz, sc = pack_gptq(nib, zeros, scales)
    g_idx = np.arange(K, dtype=np.int32) // GS
    if act_order:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    return dict(qweight=qw, qzeros=qz, scales=sc, g_idx=g_idx)


def moe_state(family, quant=None, ff=F, seed=0):
    """(HF name, numpy tensor) pairs of layer 0's feed-forward. ``quant``:
    None (dense fp32), "gptq" or "gptq-act-order" (experts 1 and 2 of gate and
    down with a shuffled g_idx, the others trivial)."""
    rng = np.random.RandomState(seed)
    pre = "model.layers.0."
    out = []

    def lin(name, K, N, act_order=False, quantized=quant is not None):
        if quantized:
            out.extend((f"{name}.{k}", v) for k, v in _gptq(rng, K, N, act_order).items())
        else:
            out.append((name + ".weight", (rng.randn(N, K) / np.sqrt(K)).astype(np.float32)))

    names = dict(gate="gate_proj", up="up_proj", down="down_proj")
    if family == "mixtral":
        names = dict(gate="w1", up="w3", down="w2")
        router, experts = pre + "block_sparse_moe.gate", pre + "block_sparse_moe.experts."
    else:
        router, experts = pre + "mlp.gate", pre + "mlp.experts."
    lin(router, D, E, quantized=False)
    for e in range(E):
        ao = quant == "gptq-act-order" and e in (1, 2)
        lin(f"{experts}{e}.{names['gate']}", D, ff, ao)
        lin(f"{experts}{e}.{names['up']}", D, ff)
        lin(f"{experts}{e}.{names['down']}", ff, D, ao)
    if family == "deepseek":
        out.append((pre + "mlp.gate.e_score_correction_bias", (rng.randn(E) * 0.1).astype(np.float32)))
        for m in ("gate", "up", "down"):
            lin(f"{pre}mlp.shared_experts.{m}_proj", *((D, F) if m != "down" else (F, D)))
        # MLA leaves beside the feed-forward
        for name, shape in (("q_proj", (4 * 24, D)), ("kv_a_proj_with_mqa", (40, D)),
                            ("kv_b_proj", (4 * 32, 32)), ("o_proj", (D, 64))):
            out.append((f"{pre}self_attn.{name}.weight", rng.randn(*shape).astype(np.float32)))
        out.append((pre + "self_attn.kv_a_layernorm.weight", rng.randn(32).astype(np.float32)))
    if family == "qwen2_moe":
        for m in ("gate", "up", "down"):
            lin(f"{pre}mlp.shared_expert.{m}_proj", *((D, F) if m != "down" else (F, D)))
        lin(pre + "mlp.shared_expert_gate", D, 1, quantized=False)
    return out


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _load_both(family, quant, dtype="float32", **state_kw):
    hf = _hf_config(family, torch_dtype=dtype, **({"intermediate_size": state_kw["ff"]}
                                                   if family == "mixtral" and "ff" in state_kw else {}))
    tensors = moe_state(family, quant, **state_kw)
    method = "gptq" if quant else None
    jcfg = j_adapt_hf_config(hf).replace(dtype=dtype)
    tcfg = t_adapt_hf_config(hf).replace(dtype=dtype)
    jp = JH.map_hf_params(tensors, jcfg, quant_method=method)
    tp = TH.map_hf_params(tensors, tcfg, quant_method=method)
    return jcfg, jp, tcfg, tp


def _assert_leaves_equal(jp, tp):
    want, got = dict(_leaves(jp)), dict(_leaves(tp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w, g = np.asarray(w), got[path]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(g.view(torch.uint16).numpy(), w.view(np.uint16), err_msg=path)
        else:
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name, path
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)


@pytest.mark.parametrize("family,quant,dtype", [
    ("deepseek", None, "float32"), ("deepseek", None, "bfloat16"), ("deepseek", "gptq", "bfloat16"),
    ("deepseek", "gptq-act-order", "float32"), ("qwen2_moe", None, "float32"),
    ("qwen2_moe", "gptq", "float32"), ("mixtral", None, "bfloat16"), ("mixtral", "gptq", "float32"),
])
def test_map_hf_params_moe_leaves_match_reference(family, quant, dtype):
    _, jp, _, tp = _load_both(family, quant, dtype)
    _assert_leaves_equal(jp, tp)
    mlp = tp["layers"]["0"]["mlp"]
    assert mlp["router"]["w"].dtype == torch.float32  # routers stay fp32
    gate = mlp["experts"]["gate_proj"]
    if quant:
        assert gate["w_p"].dtype == torch.uint8 and gate["w_p"].shape == (E, D // 2, F)
        assert gate["scales"].shape == (E, D // GS, F)
        assert ("perm" in gate) == (quant == "gptq-act-order")
    else:
        assert gate["w"].shape == (E, D, F)


def test_map_hf_params_pads_an_expert_k_the_planes_cannot_hold():
    """DeepSeek-V2-Lite's expert down_proj geometry (K 1408 at group 128): K is
    padded to 1536 with zero-scale groups in both loaders, leaves equal."""
    _, jp, _, tp = _load_both("mixtral", "gptq", ff=1408)
    _assert_leaves_equal(jp, tp)
    down = tp["layers"]["0"]["mlp"]["experts"]["down_proj"]
    assert down["w_p"].shape == (E, 1536 // 2, D) and down["scales"].shape == (E, 12, D)
    assert not down["scales"][:, 11].any()


# ---------------------------------------------------------------------------
# moe_layer
# ---------------------------------------------------------------------------

def _x(seed, n=9):
    return (np.random.RandomState(seed).randn(n, D) * 0.5).astype(np.float32)


@pytest.mark.parametrize("family", ["deepseek", "qwen2_moe", "mixtral"])
def test_moe_layer_dense_stacks_match_jax(family):
    """Dense expert stacks (the grouped product the reference runs through
    lax.ragged_dot), with DeepSeek's shared experts and Qwen2-MoE's gated one."""
    jcfg, jp, tcfg, tp = _load_both(family, None)
    x = _x(1)
    want = JM.moe_layer(jp["layers"]["0"]["mlp"], jcfg, jnp.asarray(x))
    got = TM.moe_layer(tp["layers"]["0"]["mlp"], tcfg, T(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_tokens", [9, 300])  # m-tiles of 8 rows, and of 64
@pytest.mark.parametrize("quant", ["gptq", "gptq-act-order"])
def test_moe_layer_int4_stacks_match_jax(monkeypatch, quant, n_tokens):
    jcfg, jp, tcfg, tp = _load_both("qwen2_moe", quant)
    jmlp, tmlp = jp["layers"]["0"]["mlp"], tp["layers"]["0"]["mlp"]
    x = _x(2, n_tokens)
    assert TM._use_quant_ragged(tmlp["experts"])
    got = TM.moe_layer(tmlp, tcfg, T(x)).numpy()

    # the JAX dequantize-and-grouped-dot fallback keeps fp32 activations, as
    # the port's plain ragged matmul does
    monkeypatch.delenv("ZT_PALLAS_INTERPRET", raising=False)
    assert not JM._use_quant_ragged(jmlp["experts"])
    want = np.asarray(JM.moe_layer(jmlp, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    # the JAX Pallas kernel (interpret mode) rounds the activations to bf16
    monkeypatch.setenv("ZT_PALLAS_INTERPRET", "1")
    assert JM._use_quant_ragged(jmlp["experts"])
    fused = np.asarray(JM.moe_layer(jmlp, jcfg, jnp.asarray(x)))
    assert np.abs(got - fused).max() <= 2e-2 * np.abs(got).max()

    # the port's own dequantized grouped product (what int8-nibble stacks
    # take) agrees with its ragged path
    monkeypatch.setattr(TM, "_use_quant_ragged", lambda *a: False)
    np.testing.assert_allclose(TM.moe_layer(tmlp, tcfg, T(x)).numpy(), got, rtol=RTOL, atol=ATOL)


def test_moe_layer_padded_down_k_matches_jax(monkeypatch):
    """K 1408 padded to 1536: the activations get zero columns and the
    pad groups contribute exact zeros."""
    jcfg, jp, tcfg, tp = _load_both("mixtral", "gptq", ff=1408)
    x = _x(3)
    monkeypatch.delenv("ZT_PALLAS_INTERPRET", raising=False)
    want = np.asarray(JM.moe_layer(jp["layers"]["0"]["mlp"], jcfg, jnp.asarray(x)))
    tmlp = tp["layers"]["0"]["mlp"]
    assert TM._use_quant_ragged(tmlp["experts"])
    np.testing.assert_allclose(TM.moe_layer(tmlp, tcfg, T(x)).numpy(), want, rtol=RTOL, atol=ATOL)


def _contribution_inputs():
    """Qwen2-MoE act-order int4 stacks (E 4: experts 1 and 2 with a
    permutation), 9 tokens' routing: (x, flat experts, pair weights, the
    port's and JAX's arrays per projection (w_p, scales, zeros, perm))."""
    _, _, tcfg, tp = _load_both("qwen2_moe", "gptq-act-order")
    tmlp = tp["layers"]["0"]["mlp"]
    x = T(_x(4))
    weights, ids = TM.select_experts(x @ tmlp["router"]["w"], tcfg.moe)
    t_arrs = []
    for nm in ("gate_proj", "up_proj", "down_proj"):
        pr = tmlp["experts"][nm]
        # a projection with a trivial g_idx takes the identity, as moe_layer gives it
        Kp = 2 * pr["w_p"].shape[1]
        perm = pr.get("perm", torch.arange(Kp, dtype=torch.int32).expand(E, Kp).contiguous())
        t_arrs += [pr["w_p"], pr["scales"], pr["zeros"], perm]
    assert "perm" in tmlp["experts"]["gate_proj"] and "perm" not in tmlp["experts"]["up_proj"]
    # the JAX loader's leaves are the port's, bit for bit (test_map_hf_params_moe_leaves_match_reference)
    j_arrs = [jnp.asarray(a.numpy()) for a in t_arrs]
    return x, ids.reshape(-1), weights.reshape(-1), t_arrs, j_arrs, tcfg


def test_quant_experts_contribution_refuses_expert_parallelism(monkeypatch):
    """Expert parallelism, which this function once refused: the share of
    experts ``[e0, e0 + E / n)`` of an n-way split (n = 2 and 4, every e0)
    against JAX's ``quant_experts_contribution`` at the same ``e0`` through
    its Pallas kernel in interpret mode (2e-2 of the largest output: the
    kernel rounds x to bf16), and the shares' fp32 sum against the unsharded
    contribution (1e-5)."""
    x, flat, pair_w, t_arrs, j_arrs, tcfg = _contribution_inputs()
    K, act = tcfg.moe.top_k, tcfg.activate_fn
    whole = TM.quant_experts_contribution(x, flat, pair_w, t_arrs, False, K, 0, act, has_perm=True)
    for n in (2, 4):
        El = E // n
        shares = []
        for e0 in range(0, E, El):
            local = [a[e0:e0 + El] for a in t_arrs]
            got = TM.quant_experts_contribution(x, flat, pair_w, local, False, K, e0, act,
                                                has_perm=True)
            want = np.asarray(JM.quant_experts_contribution(
                jnp.asarray(x.numpy()), jnp.asarray(flat.numpy()), jnp.asarray(pair_w.numpy()),
                [a[e0:e0 + El] for a in j_arrs], False, K, e0, act, interpret=True,
                has_perm=True))
            assert got.dtype == torch.float32 and got.abs().max() > 0
            assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max(), (n, e0)
            shares.append(got)
        np.testing.assert_allclose(sum(shares).numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_quant_experts_contribution_masks_remote_pairs(monkeypatch):
    """The rows of pairs routed to another shard's experts are never
    written by the kernel (tiles past ``num_occ``): filled with NaN here,
    they never reach the sum."""
    x, flat, pair_w, t_arrs, _, tcfg = _contribution_inputs()
    K, act = tcfg.moe.top_k, tcfg.activate_fn
    local = [a[2:4] for a in t_arrs]
    want = TM.quant_experts_contribution(x, flat, pair_w, local, False, K, 2, act, has_perm=True)
    matmul = TM.quant_ragged.w4a16_ragged_matmul

    def unwritten(xin, w_p, scales, zeros, tile_expert, num_occ):
        out = matmul(xin, w_p, scales, zeros, tile_expert, num_occ)
        TM_ = xin.shape[0] // tile_expert.shape[0]
        out[int(num_occ[0]) * TM_:] = float("nan")
        return out

    monkeypatch.setattr(TM.quant_ragged, "w4a16_ragged_matmul", unwritten)
    got = TM.quant_experts_contribution(x, flat, pair_w, local, False, K, 2, act, has_perm=True)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_ragged_tile_and_expert_weight():
    assert [TM._ragged_tile(n) for n in (1, 48, 512, 513, 3072)] == [8, 8, 8, 64, 64]
    with pytest.raises(ValueError):
        TM._expert_weight({"w_f8": torch.zeros(1)}, torch.float32)


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------

def test_params_to_torch_keeps_moe_dtypes():
    """The JAX loader's tree cast to bf16: dense stacks and MLA leaves follow
    the model dtype, routers stay fp32, int4 stacks keep uint8 / fp32 / int32."""
    _, jp, _, _ = _load_both("deepseek", "gptq-act-order")
    tp = params_to_torch(jp, "cpu", torch.bfloat16)
    layer = tp["layers"]["0"]
    assert layer["mlp"]["router"]["w"].dtype == torch.float32
    assert layer["mlp"]["router"]["e_score_correction_bias"].dtype == torch.float32
    gate = layer["mlp"]["experts"]["gate_proj"]
    assert (gate["w_p"].dtype, gate["scales"].dtype, gate["zeros"].dtype, gate["perm"].dtype) == (
        torch.uint8, torch.float32, torch.float32, torch.int32)
    assert layer["attn"]["kv_b_proj"]["w"].dtype == torch.bfloat16
    assert layer["mlp"]["shared_expert"]["up_proj"]["scales"].dtype == torch.float32
    _, jp, _, _ = _load_both("mixtral", None)
    tp = params_to_torch(jp, "cpu", torch.bfloat16)
    assert tp["layers"]["0"]["mlp"]["experts"]["up_proj"]["w"].dtype == torch.bfloat16
    assert tp["layers"]["0"]["mlp"]["experts"]["up_proj"]["w"].shape == (E, D, F)


# ---------------------------------------------------------------------------
# a checkpoint directory end to end
# ---------------------------------------------------------------------------

def test_llm_model_path_deepseek_gptq_matches_reference(tmp_path):
    """``LLM(model_path=...)`` in both packages on a one-layer DeepSeek-V2
    checkpoint (``pytorch_model.bin`` + ``config.json``) with MLA attention and
    GPTQ expert stacks, in fp32: the quantization config reaches the expert
    stacks and the greedy tokens are identical."""
    rng = np.random.RandomState(11)
    state = dict(moe_state("deepseek", "gptq"))
    state.update({
        "model.embed_tokens.weight": (rng.randn(64, D) * 0.5).astype(np.float32),
        "model.layers.0.input_layernorm.weight": (1 + 0.1 * rng.randn(D)).astype(np.float32),
        "model.layers.0.post_attention_layernorm.weight": (1 + 0.1 * rng.randn(D)).astype(np.float32),
        "model.norm.weight": (1 + 0.1 * rng.randn(D)).astype(np.float32),
        "lm_head.weight": (rng.randn(64, D) * 0.1).astype(np.float32),
    })
    for name in ("q_proj", "kv_a_proj_with_mqa", "kv_b_proj", "o_proj"):
        state[f"model.layers.0.self_attn.{name}.weight"] *= 0.1  # O(1) activations
    torch.save({k: T(np.ascontiguousarray(v)) for k, v in state.items()}, tmp_path / "pytorch_model.bin")
    hf = _hf_config("deepseek", quantization_config={
        "quant_method": "gptq", "bits": 4, "group_size": GS, "desc_act": False, "sym": True})
    (tmp_path / "config.json").write_text(json.dumps(hf))
    (tmp_path / "generation_config.json").write_text(json.dumps({"eos_token_id": 1}))

    sched = dict(max_batch=4, chunk_size=16, prefill_buckets=(8, 16), decode_multi_step=4)
    jcfg, _, _ = j_load_model_config(str(tmp_path))
    tcfg, tq, _ = t_load_model_config(str(tmp_path))
    assert tq.quant_type.name == "GPTQ" and tcfg.mla.enabled and tcfg.moe.enabled
    jllm = JLLM(model_path=str(tmp_path), model_config=dataclasses.replace(jcfg, dtype="float32"),
                engine_config=JEngineConfig(max_model_len=64, cache=JCacheConfig(page_size=4, num_pages=64),
                                            scheduler=JSchedulerConfig(**sched)))
    tllm = LLM(model_path=str(tmp_path), model_config=dataclasses.replace(tcfg, dtype="float32"),
               device="cpu",
               engine_config=EngineConfig(max_model_len=64, cache=CacheConfig(page_size=4, num_pages=64),
                                          scheduler=SchedulerConfig(**sched)))
    mlp = tllm.executor.params["layers"]["0"]["mlp"]
    assert mlp["experts"]["down_proj"]["w_p"].dtype == torch.uint8
    assert mlp["router"]["w"].dtype == torch.float32 and tllm.executor.cache.is_latent
    prompts = [rng.randint(2, 64, size=n).tolist() for n in (3, 9, 18, 37)]

    def serve(llm, gen_cls, arg_cls):
        with gen_cls(llm) as gen:
            res = gen.batch_generate(prompts, [arg_cls(max_length=8) for _ in prompts], timeout=300)
        return [r.outputs[0].token_ids for r in res]

    got = serve(tllm, DynamicBatchGenerator, GeneratorArg)
    assert got == serve(jllm, JGenerator, JGeneratorArg) and all(len(t) > 0 for t in got)
