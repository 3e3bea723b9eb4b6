"""MoE and MLA under tensor parallelism in the port (zhilight_tpu_torch) on
the CPU: a tiny DeepSeek-V2 model (MLA over a latent pool, a dense first
layer, then MoE layers of 8 routed experts, top 2, and a shared expert), one
process a rank over gloo, held against the single-process port and against
the JAX package's ``ParallelConfig(tp=N)`` on the 8 virtual CPU devices of
tests/conftest.py.

- The rule table: ``param_shard_dim`` gives the dim the reference's
  ``param_pspec`` shards on a DeepSeek tree with bf16 and with GPTQ expert
  stacks (``g_idx`` / ``perm`` included) and on a Qwen2-MoE tree with a
  shared-expert gate; ``shard_params`` slices int4 expert stacks on the
  expert dim and a GPTQ shared expert as a dense MLP.
- The forward: a prefill chunk and one decode step at TP=2 and TP=4, in
  fp32, with dense and with GPTQ int4 expert stacks, against the
  single-process port and the JAX forward on a tp mesh, within 2e-4. The JAX
  side keeps the int4 stacks' activations in fp32 (its dequantize-and-dot
  path; its Pallas kernel rounds them to bf16, ROADMAP queue 3, "int4
  activations"). Every rank routes every token to the same experts, holds
  ``E / tp`` of them, and every collective a MoE layer issues is an fp32
  ``[T, D]`` all-reduce.
- The engine: greedy tokens at TP=2 against the JAX engine at
  ``ParallelConfig(tp=2)`` over the latent pool, per step and under swap
  preemption, and with ``ZT_WINDOW_KV=1`` and ``ZT_FUSED_KV=1`` against the
  single-process port: the JAX engine runs both at tp=2, but in interpret
  mode they take about 20 s and 8 s more, which would take this file past its
  minute; tests/test_torch_window.py and tests/test_torch_fused.py hold the
  single-process port's modes against the JAX engine's. Both ranks finish
  every request alike and route alike.
- The loader: ``map_hf_params(..., shard=(rank, tp))`` keeps only the rank's
  experts, bf16 and GPTQ, and never converts another rank's expert tensor.
- The raises: ``num_experts``, ``num_heads`` or the shared expert's width
  that tp does not divide.

The rank processes are tests/test_torch_tp.py's (``Ranks``), one pair and
one quartet for the forward and one pair for the engine, started together
and run in the background while the JAX side runs in this process.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from test_torch_moe import _load_both
from test_torch_tp import (DECODE_TOKEN, ENG_SCHED, FWD_TOKENS, PRESSURE_PROMPTS, PRESSURE_SCHED,
                           PROMPTS, Ranks, _flat, _jax_forward, _jax_tokens, _load, _port_forward,
                           _save, _spec_dim, _tree)
from zhilight_tpu.config import adapt_hf_config as j_adapt_hf_config
from zhilight_tpu.parallel.sharding import param_pspec
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu.utils.quant_convert import pack_gptq
from zhilight_tpu_torch.config import EngineConfig, ParallelConfig
from zhilight_tpu_torch.config import adapt_hf_config as t_adapt_hf_config
from zhilight_tpu_torch.llm import LLM
from zhilight_tpu_torch.models import moe as TM
from zhilight_tpu_torch.parallel.comm import LAUNCH_VARS
from zhilight_tpu_torch.parallel.sharding import check_tp, param_shard_dim, shard_params
from zhilight_tpu_torch.utils import hf_loader as TH
from zhilight_tpu_torch.utils.convert import params_to_torch

E, D, V, GS = 8, 64, 128, 32
# deepseek-ai/DeepSeek-V2-Lite's config.json fields, at tiny sizes
HF = dict(model_type="deepseek_v2", hidden_size=D, num_hidden_layers=3, num_attention_heads=4,
          num_key_value_heads=4, intermediate_size=128, vocab_size=V, moe_intermediate_size=32,
          n_routed_experts=E, n_shared_experts=1, num_experts_per_tok=2, first_k_dense_replace=1,
          moe_layer_freq=1, kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
          qk_rope_head_dim=8, v_head_dim=16, rms_norm_eps=1e-6, max_position_embeddings=256,
          tie_word_embeddings=False, norm_topk_prob=False, scoring_func="softmax",
          topk_method="greedy", routed_scaling_factor=1.0, torch_dtype="float32")
# the forward's models: dense expert stacks with q LoRA (q_a / q_b), GPTQ
# stacks (experts 1 and 5 act-order) with a direct q_proj
MODELS = {"dense": dict(q_lora_rank=24), "gptq": dict()}
ACT_ORDER = (1, 5)


def _gptq(rng, K, N, act_order):
    nib = rng.randint(0, 16, size=(K, N)).astype(np.int8)
    scales = ((rng.rand(K // GS, N) + 0.5) * (2.0 / np.sqrt(K) / 8)).astype(np.float32)
    zeros = rng.randint(1, 16, size=(K // GS, N)).astype(np.float32)
    qw, qz, sc = pack_gptq(nib, zeros, scales)
    g_idx = np.arange(K, dtype=np.int32) // GS
    if act_order:
        g_idx = rng.permutation(g_idx).astype(np.int32)
    return dict(qweight=qw, qzeros=qz, scales=sc, g_idx=g_idx)


def _hf(name):
    return dict(HF, **MODELS[name])


def deepseek_state(hf, quant, seed=0):
    """(HF name, numpy tensor) pairs of a whole tiny DeepSeek-V2 checkpoint;
    with ``quant`` the routed experts are GPTQ (group 32), nothing else."""
    rng = np.random.RandomState(seed)
    d, H, L = hf["hidden_size"], hf["num_attention_heads"], hf["num_hidden_layers"]
    nope, rope, vd, lora = (hf[k] for k in ("qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
                                             "kv_lora_rank"))
    f, fe, n_exp = hf["intermediate_size"], hf["moe_intermediate_size"], hf["n_routed_experts"]
    out = [("model.embed_tokens.weight", rng.randn(V, d).astype(np.float32)),
           ("model.norm.weight", (1 + 0.1 * rng.randn(d)).astype(np.float32)),
           ("lm_head.weight", (rng.randn(V, d) / np.sqrt(d)).astype(np.float32))]

    def lin(name, K, N, gptq=False, act_order=False):
        if gptq:
            out.extend((f"{name}.{k}", v) for k, v in _gptq(rng, K, N, act_order).items())
        else:
            out.append((name + ".weight", (rng.randn(N, K) / np.sqrt(K)).astype(np.float32)))

    def norm(name, n):
        out.append((name + ".weight", (1 + 0.1 * rng.randn(n)).astype(np.float32)))

    for i in range(L):
        pre = f"model.layers.{i}."
        norm(pre + "input_layernorm", d)
        norm(pre + "post_attention_layernorm", d)
        att = pre + "self_attn."
        if hf["q_lora_rank"]:
            lin(att + "q_a_proj", d, hf["q_lora_rank"])
            norm(att + "q_a_layernorm", hf["q_lora_rank"])
            lin(att + "q_b_proj", hf["q_lora_rank"], H * (nope + rope))
        else:
            lin(att + "q_proj", d, H * (nope + rope))
        lin(att + "kv_a_proj_with_mqa", d, lora + rope)
        norm(att + "kv_a_layernorm", lora)
        lin(att + "kv_b_proj", lora, H * (nope + vd))
        lin(att + "o_proj", H * vd, d)
        if i < hf["first_k_dense_replace"]:
            for m, (K, N) in (("gate", (d, f)), ("up", (d, f)), ("down", (f, d))):
                lin(f"{pre}mlp.{m}_proj", K, N)
            continue
        lin(pre + "mlp.gate", d, n_exp)
        for e in range(n_exp):
            ao = e in ACT_ORDER
            lin(f"{pre}mlp.experts.{e}.gate_proj", d, fe, quant, ao)
            lin(f"{pre}mlp.experts.{e}.up_proj", d, fe, quant)
            lin(f"{pre}mlp.experts.{e}.down_proj", fe, d, quant, ao)
        fs = fe * hf["n_shared_experts"]
        for m, (K, N) in (("gate", (d, fs)), ("up", (d, fs)), ("down", (fs, d))):
            lin(f"{pre}mlp.shared_experts.{m}_proj", K, N)
    return out


def configs(hf):
    return (j_adapt_hf_config(hf).replace(dtype="float32"),
            t_adapt_hf_config(hf).replace(dtype="float32"))


def jax_tree(name):
    """The JAX loader's tree of model ``name`` (numpy leaves), its configs."""
    hf = _hf(name)
    jcfg, tcfg = configs(hf)
    method = "gptq" if name == "gptq" else None
    tree = JH.map_hf_params(deepseek_state(hf, method), jcfg, quant_method=method)
    return jax.device_get(tree), jcfg, tcfg


def _routes(fn):
    """``fn()``'s every routing's expert ids, in the single process."""
    seen, select = [], TM.select_experts

    def recorded(*a, **kw):
        weights, ids = select(*a, **kw)
        seen.append(ids.tolist())
        return weights, ids

    TM.select_experts = recorded
    try:
        return fn(), seen
    finally:
        TM.select_experts = select


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

ENGINE = {
    "per_step": dict(),
    "window": dict(env={"ZT_WINDOW_KV": "1"}),
    "fused": dict(env={"ZT_FUSED_KV": "1"}),
    "swap": dict(pressure="swap"),
    # the same weights as an HF checkpoint directory: LLM(model_path=...) on
    # each rank, the loader reading the rank's shard (the server's path)
    "checkpoint": dict(checkpoint=True),
}


def _checkpoint(path, hf):
    """The dense model's HF tensors as ``pytorch_model.bin`` beside its
    ``config.json``."""
    path.mkdir()
    (path / "config.json").write_text(json.dumps(dict(hf, architectures=["DeepseekV2ForCausalLM"])))
    torch.save({k: torch.from_numpy(v) for k, v in deepseek_state(hf, None)},
               path / "pytorch_model.bin")
    return str(path)


def _engine_case(name, model, params_path, checkpoint=None):
    spec = ENGINE[name]
    case = dict(model=model, params=params_path, env=spec.get("env", {}), max_model_len=64)
    if spec.get("checkpoint"):
        case["model_path"] = checkpoint
    if "pressure" in spec:
        case.update(cache=dict(page_size=4, num_pages=8),
                    sched=dict(PRESSURE_SCHED, preempt_mode=spec["pressure"]),
                    prompts=PRESSURE_PROMPTS, arg=dict(max_length=20))
    else:
        case.update(cache=dict(page_size=4, num_pages=64), sched=ENG_SCHED, prompts=PROMPTS,
                    arg=dict(max_length=8))
    return case


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One pair of ranks for the TP=2 forward of both models and every engine
    case, and a quartet for the TP=4 forward, started together."""
    tmp = tmp_path_factory.mktemp("tp_moe")
    fwd, trees = {}, {}
    for name in MODELS:
        tree, jcfg, tcfg = jax_tree(name)
        path = _save(tree, tmp / f"fwd_{name}.npz")
        trees[name] = (path, jcfg, tcfg)
        fwd[name] = dict(model=dataclasses.asdict(tcfg), params=path, tokens=FWD_TOKENS,
                         decode_token=DECODE_TOKEN)
    path, jcfg, tcfg = trees["dense"]
    ckpt = _checkpoint(tmp / "checkpoint", _hf("dense"))
    eng = {name: _engine_case(name, dataclasses.asdict(tcfg), path, ckpt) for name in ENGINE}
    for sub in ("tp2", "tp4"):
        (tmp / sub).mkdir()
    pair = Ranks(dict(forward=fwd, engine=eng), 2, tmp / "tp2")
    yield {
        "tp2": pair,
        "tp4": Ranks(dict(forward=fwd), 4, tmp / "tp4"),
        "engine": pair,
        "trees": trees,
        "cases": eng,
    }


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------

def _rule_tree(tree):
    """(JAX leaves, port tree, its config) of a rule-table case."""
    if tree == "qwen2_moe-gate":
        _, jp, tcfg, tp = _load_both("qwen2_moe", None)
        assert "shared_expert_gate" in tp["layers"]["0"]["mlp"]
    else:
        name = "dense" if tree == "deepseek-bf16" else "gptq"
        jp, _, tcfg = jax_tree(name)
        tp = TH.map_hf_params(deepseek_state(_hf(name), "gptq" if name == "gptq" else None), tcfg,
                              quant_method="gptq" if name == "gptq" else None)
        if tree == "deepseek-bf16":
            tp = params_to_torch(tp, "cpu", torch.bfloat16)
    return jp, tp, tcfg


@pytest.mark.parametrize("tree", ["deepseek-bf16", "deepseek-gptq", "qwen2_moe-gate"])
def test_rule_table_matches_param_pspec(tree):
    """Every leaf's sharded dim as the reference's rules give it (the raw
    checkpoint's ``g_idx`` among the names), and each rank's shard of the
    port's tree: its ``E / tp`` experts (int4 ``w_p`` / ``scales`` /
    ``zeros`` / ``perm`` too), the ranks' slices together the whole."""
    jp, tp, tcfg = _rule_tree(tree)
    leaves = [(path, np.ndim(x)) for path, x in _flat(jp)]
    if tree == "deepseek-gptq":
        assert any(path.endswith("experts.gate_proj.perm") for path, _ in leaves)
        leaves += [("layers.1.mlp.experts.gate_proj.g_idx", 2),
                   ("layers.1.mlp.experts.down_proj.g_idx", 2)]
    for path, ndim in leaves:
        assert param_shard_dim(path, ndim) == _spec_dim(param_pspec(path, ndim)), path
    full = dict(_flat(tp))
    shards = [dict(_flat(shard_params(tp, r, 2, tcfg))) for r in range(2)]
    for path, leaf in full.items():
        dim = param_shard_dim(path, leaf.dim())
        if ".mlp.experts." in path:
            assert dim == 0 and shards[0][path].shape[0] == leaf.shape[0] // 2, path
        parts = [s[path] for s in shards]
        got = leaf if dim is None else torch.cat(parts, dim)
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), path
        assert all(p.is_contiguous() for p in parts), path


def test_shard_params_refuses_a_quantized_dense_linear():
    """GPTQ shared experts are dense quantized linears, refused until quantized
    linears under tensor parallelism were ported: now each rank holds its
    half of the shared expert's gate/up columns and of its down_proj rows
    (or the whole down_proj where half its rows would cut a group), and the
    ranks' column slices put back together give the whole."""
    _, _, tcfg, tp = _load_both("deepseek", "gptq")
    down = tp["layers"]["0"]["mlp"]["shared_expert"]["down_proj"]
    assert "w_p" in down
    shards = [shard_params(tp, r, 2, tcfg) for r in range(2)]
    mlp = [s["layers"]["0"]["mlp"]["shared_expert"] for s in shards]
    gate = tp["layers"]["0"]["mlp"]["shared_expert"]["gate_proj"]
    for key in ("w_p", "scales", "zeros"):
        assert torch.equal(torch.cat([m["gate_proj"][key] for m in mlp], -1),
                           torch.as_tensor(gate[key])), key
    K = down["w_p"].shape[0] * (2 if down["w_p"].dtype == torch.uint8 else 1)
    rows = [m["down_proj"]["w_p"].shape[0] * (2 if m["down_proj"]["w_p"].dtype == torch.uint8
                                               else 1) for m in mlp]
    assert all(r < K for r in rows) or all(r == K for r in rows)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_single_process_and_jax_mesh(ranks, name, tp, monkeypatch):
    path, jcfg, tcfg = ranks["trees"][name]
    params = _tree(_load(path))
    # the JAX int4 stacks through its dequantize-and-dot path (fp32 activations)
    monkeypatch.delenv("ZT_PALLAS_INTERPRET", raising=False)
    want_pre, want_dec = _jax_forward(jcfg, params, tp)
    (one_pre, one_dec), one_routes = _routes(
        lambda: _port_forward(tcfg, params_to_torch(params, "cpu", torch.float32)))
    outs = [r["forward"][name] for r in ranks[f"tp{tp}"].result()]
    # every rank holds the whole latent pool and E / tp experts
    assert outs[0]["pool"] == [1, 32 * 4, tcfg.mla.latent_dim]
    for out in outs:
        assert out["expert_counts"] == [E // tp]
        assert out["prefill"] == outs[0]["prefill"] and out["decode"] == outs[0]["decode"]
        # the same experts for every token on every rank, and the single process's
        assert out["experts"] == outs[0]["experts"] == one_routes
        # a MoE layer's collectives: the routed sum and the shared expert's
        # row-parallel product, each an fp32 [T, D] all-reduce
        moe_layers = tcfg.num_layers - tcfg.moe.first_k_dense_replace
        assert len(out["moe_collectives"]) == 2 * 2 * moe_layers
        for op, dtype, shape in out["moe_collectives"]:
            assert (op, dtype) == ("all_reduce", "torch.float32") and shape in ([16, D], [2, D])
    got_pre, got_dec = np.asarray(outs[0]["prefill"]), np.asarray(outs[0]["decode"])
    assert got_pre.shape == (V,)
    for got, one, want in ((got_pre, one_pre, want_pre), (got_dec, one_dec, want_dec)):
        np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _port_tokens(case, monkeypatch):
    """The single-process port's greedy tokens on the case, its mode on."""
    from zhilight_tpu_torch.config import CacheConfig, SchedulerConfig
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg

    _, tcfg = configs(_hf("dense"))
    with monkeypatch.context() as m:
        for key, value in case["env"].items():
            m.setenv(key, value)
        llm = LLM(model_config=tcfg, params=_tree(_load(case["params"])), device="cpu",
                  engine_config=EngineConfig(max_model_len=case["max_model_len"],
                                             cache=CacheConfig(**case["cache"]),
                                             scheduler=SchedulerConfig(**case["sched"])))
        with DynamicBatchGenerator(llm) as gen:
            res = gen.batch_generate(case["prompts"], GeneratorArg(**case["arg"]), timeout=300)
    return [r.outputs[0].token_ids for r in res]


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_tokens_match_tp2_reference(ranks, name, monkeypatch):
    """Per step and swap: the JAX engine at ParallelConfig(tp=2); window and
    fused: the single-process port in the same mode; the checkpoint read by
    each rank's loader: the per-step case's tokens (the same weights)."""
    case = ranks["cases"][name]
    results = ranks["engine"].result()
    if case.get("model_path"):
        want = results[0]["engine"]["per_step"]["greedy"]
    elif case["env"]:
        want = _port_tokens(case, monkeypatch)
    else:
        want, jllm = _jax_tokens(case, monkeypatch, jcfg=ranks["trees"]["dense"][1])
        assert jllm.executor.cache.latent is not None
    r0, r1 = (r["engine"][name] for r in results)
    assert r0["greedy"] == want and all(len(t) >= 1 for t in want)
    # both ranks finished every request alike, routed every token alike and
    # hold half the experts beside a whole latent pool
    assert r0["finished"] and r0["finished"] == r1["finished"]
    assert r0["routings"] > 0 and (r0["routings"], r0["experts"]) == (r1["routings"],
                                                                      r1["experts"])
    assert r0["expert_counts"] == r1["expert_counts"] == [E // 2]
    latent = _hf("dense")["kv_lora_rank"] + _hf("dense")["qk_rope_head_dim"]
    assert r0["pool"] == [1, r0["num_pages"] * 4, latent]
    # the latent bytes a token are not divided by tp
    assert r0["kv_bytes"] == HF["num_hidden_layers"] * latent * 2
    if name == "window":
        assert r0["window_kv"] and r0["window_steps"] > 0 and r1["window_steps"] > 0
    if name == "fused":
        assert r0["fused_kv"] and r1["fused_kv"]
    if name == "swap":
        assert r0["preemptions"] >= 1 and r0["preemptions"] == r1["preemptions"]


def test_init_params_shard_keeps_the_full_draw_slice():
    """``init_params(..., shard=(rank, tp))`` on an MLA + MoE model draws the
    same tensors, a layer at a time, and keeps the rank's slices: the shard
    of the full draw, leaf for leaf, ``E / tp`` experts a stack."""
    from zhilight_tpu_torch.models import llama as TL

    _, tcfg = configs(_hf("dense"))
    for rank in range(2):
        want = dict(_flat(shard_params(TL.init_params(tcfg, 3, "cpu"), rank, 2, tcfg)))
        got = dict(_flat(TL.init_params(tcfg, 3, "cpu", shard=(rank, 2))))
        assert want.keys() == got.keys()
        assert all(torch.equal(want[k], got[k]) for k in want)
        assert got["layers.1.mlp.experts.down_proj.w"].shape[0] == E // 2


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_loader_reads_only_the_rank_experts(name, monkeypatch):
    """``map_hf_params(..., shard=(rank, 2))`` gives the shard of the full
    tree, and no other rank's expert tensor is ever converted (so none
    reaches the rank's device)."""
    hf = _hf(name)
    _, tcfg = configs(hf)
    method = "gptq" if name == "gptq" else None
    state = deepseek_state(hf, method)
    full = TH.map_hf_params(state, tcfg, quant_method=method)
    seen = []
    for fn in ("to_tensor", "_numpy"):
        real = getattr(TH, fn)
        monkeypatch.setattr(TH, fn, lambda a, _real=real: (seen.append(id(a)), _real(a))[1])
    for rank in range(2):
        seen.clear()
        got = dict(_flat(TH.map_hf_params(state, tcfg, quant_method=method, shard=(rank, 2))))
        want = dict(_flat(shard_params(full, rank, 2, tcfg)))
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
        lo, hi = rank * E // 2, (rank + 1) * E // 2
        remote = {id(a) for n, a in state if ".experts." in n
                  and not lo <= int(n.split(".experts.")[1].split(".")[0]) < hi}
        assert remote and not remote & set(seen)


# ---------------------------------------------------------------------------
# the raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,change", [
    ("num_experts", dict(n_routed_experts=6)),
    ("num_heads", dict(num_attention_heads=3, num_key_value_heads=3)),
    ("shared_expert_intermediate_size", dict(n_shared_experts=3, moe_intermediate_size=10)),
])
def test_sizes_tp_does_not_divide_raise(what, change, monkeypatch):
    _, tcfg = configs(dict(HF, **change))
    with pytest.raises(ValueError, match=what):
        check_tp(tcfg, 4)
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=what):
        LLM(model_config=tcfg, params={}, device="cpu",
            engine_config=EngineConfig(parallel=ParallelConfig(tp=4)))
    if what == "num_experts":
        # the leaf itself: no padding
        tree = TH.map_hf_params(deepseek_state(dict(HF, **change), None), tcfg)
        with pytest.raises(ValueError, match="does not divide by tp=4"):
            shard_params(tree, 0, 4, tcfg)
