"""Quantized linears under tensor parallelism in the port (zhilight_tpu_torch)
on the CPU: int4 (GPTQ, AWQ), FP8 (block, per-channel, per-tensor) and W8A8
(AUTO_INT8, SmoothQuant) linears and fused ``qkv_proj`` / ``gate_up_proj``
leaves, one process a rank over gloo, held against the single-process port
and the JAX package's forward on a tp mesh, whose rules replicate every
quantized leaf (``j_shard_params``).

- ``shard_linear``: each format and role, the ranks' slices put back
  together give the whole entry (planar int4 rows unpacked and repacked
  across the planes, each shard padded on its own), the leaves kept whole (an
  act-order ``perm``, a cut group or FP8 block, a shard whose padding would
  make it as wide as the whole), fused parts sliced part by part, and the
  loader's shard equal to the shard of its whole tree.
- The forward: a prefill chunk and one decode step at TP=2 (GPTQ also at
  TP=4), in fp32, within 2e-4 of the single-process port and of the JAX
  forward on a tp mesh; the collectives each row-parallel format issues.
  A tiny DeepSeek-V2 with GPTQ attention, shared expert and expert stacks.
- W8A8's row-parallel int32 accumulator equals the unsharded one exactly;
  AUTO_INT8's rank scales are the whole weight's.
- The reference's compiled row-parallel products: int4 and FP8 reduce f32,
  int8 all-reduces the per-token absmax.
- The engine: greedy tokens of checkpoint directories at TP=2 (each rank
  loading its shard through ``LLM(model_path)``): GPTQ, per step and with
  ``ZT_WINDOW_KV=1``, against the JAX engine's at ``ParallelConfig(tp=2)``;
  AWQ, FP8 (kept and dequantized at load) and AUTO_INT8 against the
  single-process port's on the same directory.

The rank processes are tests/test_torch_tp.py's (``Ranks``), one pair and one
quartet, started together and run in the background while the JAX side runs
in this process.
"""

import dataclasses
import json
import threading

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from test_torch_tp import (DECODE_TOKEN, ENG_MODEL, ENG_SCHED, FWD_MODEL, FWD_TOKENS, PROMPTS,
                           Ranks, _flat, _jax_forward, _jax_tokens, _params, _port_forward)
from test_torch_tp_moe import HF as DS_HF
from test_torch_tp_moe import configs as ds_configs
from test_torch_tp_moe import deepseek_state
from zhilight_tpu.config import ModelConfig as JModelConfig
from zhilight_tpu.parallel import TP_AXIS, make_mesh
from zhilight_tpu.utils import hf_loader as JH
from zhilight_tpu.utils import quant_convert as JQC
from zhilight_tpu_torch.config import ModelConfig
from zhilight_tpu_torch.ops import quant as TQ
from zhilight_tpu_torch.ops.linear import in_rows
from zhilight_tpu_torch.parallel.sharding import shard_linear, shard_params
from zhilight_tpu_torch.utils import hf_loader as TH
from zhilight_tpu_torch.utils import quant_convert as TQC
from zhilight_tpu_torch.utils.convert import params_to_torch

GS = 32
LINEARS = ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.o_proj", "mlp.gate_proj",
           "mlp.up_proj", "mlp.down_proj")


# ---------------------------------------------------------------------------
# quantized entries (numpy, the reference's canonical formats)
# ---------------------------------------------------------------------------

def int4_entry(rng, K, N, gs=GS, sym=True, perm=False, planar=True):
    """Random int4 ``{"w_p", "scales", "zeros", "perm"?}`` of a [K, N]
    linear; planar-packed where K allows."""
    G = K // gs
    nib = rng.randint(0, 16, size=(K, N)).astype(np.int8)
    scales = ((rng.rand(G, N) + 0.5) * (2.0 / np.sqrt(K) / 8)).astype(np.float32)
    # asymmetric zeros 1..15: what a GPTQ checkpoint stores (zero - 1) holds them
    zeros = (np.full((G, N), 8.0) if sym else rng.randint(1, 16, size=(G, N))).astype(np.float32)
    out = {"w_p": nib, "scales": scales, "zeros": zeros}
    if planar and K % 256 == 0 and K % (2 * gs) == 0:
        out["w_p"] = TQ.pack_int4(torch.from_numpy(nib)).numpy()
    if perm:
        out["perm"] = rng.permutation(K).astype(np.int32)
    return out


def fp8_entry(rng, K, N, block=None, channel=False):
    """Random e4m3 weights with block scales ``[K / Bk, N / Bn]`` (``block``
    = (Bk, Bn)), a per-channel ``[N]`` or a per-tensor scale."""
    w = (rng.randn(K, N) * 2.0).astype(ml_dtypes.float8_e4m3fn)
    if block is not None:
        scale = {"block_scale": ((rng.rand(K // block[0], N // block[1]) * 0.05 + 0.02)
                                 / np.sqrt(K)).astype(np.float32)}
    elif channel:
        scale = {"scale": ((rng.rand(N) + 0.5) * 0.1 / np.sqrt(K)).astype(np.float32)}
    else:
        scale = {"scale": np.float32(0.1 / np.sqrt(K))}
    return {"w_f8": w, **scale}


def dequant(entry):
    """An entry's weight as fp32 [K, N] numpy (int4 in its stored rows)."""
    t = params_to_torch(entry, "cpu")
    if "w" in t:
        return t["w"].float().numpy()
    if "w_p" in t:
        return TQ.dequant_int4(t["w_p"], t["scales"], t["zeros"], torch.float32).numpy()
    if "w_q" in t:
        return (t["w_q"].float() * t["scale"]).numpy()
    w = t["w_f8"].float()
    if "block_scale" in t:
        bs = t["block_scale"]
        K, N = w.shape
        w = (w.reshape(bs.shape[0], K // bs.shape[0], bs.shape[1], N // bs.shape[1])
             * bs[:, None, :, None]).reshape(K, N)
        return w.numpy()
    return (w * t["scale"]).numpy()


def _replace(tree, fn):
    """``tree`` with each layer's linear entry replaced by ``fn(path, w)``."""
    for i, layer in tree["layers"].items():
        for name in LINEARS:
            group, proj = name.split(".")
            w = layer[group][proj]["w"]
            layer[group][proj] = fn(f"layers.{i}.{name}", np.asarray(w))
    return tree


# ---------------------------------------------------------------------------
# the models of the forward
# ---------------------------------------------------------------------------

def _gptq_tree(seed, sym=True, perm=(), gs=None):
    rng = np.random.RandomState(seed)
    gs = gs or {}
    return _replace(_params(JModelConfig(**FWD_MODEL)), lambda path, w: int4_entry(
        rng, *w.shape, gs=gs.get(path.split(".")[-1], GS), sym=sym,
        perm=path.split(".")[-1] in perm))


# the FP8 model's scales, layer by layer: 32 x 32 blocks, per-channel ("channel")
# or per-tensor ("tensor"); layer 1's down_proj in 128-row blocks, which half
# its K would cut: kept whole
FP8_SCALES = {
    "0": dict(q_proj="block", k_proj="channel", v_proj="tensor", o_proj="block",
              gate_proj="block", up_proj="channel", down_proj="tensor"),
    "1": dict(q_proj="channel", k_proj="block", v_proj="block", o_proj="channel",
              gate_proj="tensor", up_proj="block", down_proj="block128"),
}


def _fp8_tree(seed):
    rng = np.random.RandomState(seed)

    def entry(path, w):
        K, N = w.shape
        _, i, _, proj = path.split(".")
        kind = FP8_SCALES[i][proj]
        if kind.startswith("block"):
            return fp8_entry(rng, K, N, block=(128, 32) if kind == "block128" else (32, 32))
        return fp8_entry(rng, K, N, channel=kind == "channel")
    return _replace(_params(JModelConfig(**FWD_MODEL)), entry)


def _fused(tree):
    """q/k/v and gate/up fused ([q | k | v], [gate | up]): layer 0's qkv_proj
    int4 and gate_up_proj dense, layer 1's the other way round."""
    rng = np.random.RandomState(7)
    for i, layer in tree["layers"].items():
        a, m = layer["attn"], layer["mlp"]
        qkv = np.concatenate([a.pop(k)["w"] for k in ("q_proj", "k_proj", "v_proj")], axis=1)
        gu = np.concatenate([m.pop(k)["w"] for k in ("gate_proj", "up_proj")], axis=1)
        a["qkv_proj"], m["gate_up_proj"] = {"w": qkv}, {"w": gu}
        if i == "0":
            a["qkv_proj"] = int4_entry(rng, *qkv.shape)
        else:
            m["gate_up_proj"] = int4_entry(rng, *gu.shape, sym=False)
    return tree


def _smooth_tree():
    tree = _params(JModelConfig(**FWD_MODEL))
    rng = np.random.RandomState(11)
    scales = {}
    for i, layer in tree["layers"].items():
        for name in LINEARS:
            group, proj = name.split(".")
            K = layer[group][proj]["w"].shape[0]
            scales[f"layers.{i}.{name}"] = (rng.rand(K) * 4 + 0.1).astype(np.float32)
    return jax.device_get(JQC.quantize_int8_params(tree, scales, 0.5))


def _hf_state(tree, method, seed=0):
    """The HF tensors of a dense tree, every linear GPTQ or AWQ (group
    GS): q_proj and down_proj act-order with asymmetric zeros under GPTQ."""
    rng = np.random.RandomState(seed)
    state = {"model.embed_tokens.weight": tree["embedding"]["w"],
             "model.norm.weight": tree["final_norm"]["w"],
             "lm_head.weight": np.ascontiguousarray(tree["lm_head"]["w"].T)}
    for i, layer in tree["layers"].items():
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = layer["ln_attn"]["w"]
        state[pre + "post_attention_layernorm.weight"] = layer["ln_ff"]["w"]
        for name in LINEARS:
            group, proj = name.split(".")
            K, N = layer[group][proj]["w"].shape
            hf = pre + ("self_attn." if group == "attn" else "mlp.") + proj
            act = method == "gptq" and proj in ("q_proj", "down_proj")
            e = int4_entry(rng, K, N, sym=method == "gptq" and not act, planar=False)
            if method == "gptq":
                qw, qz, sc = JQC.pack_gptq(e["w_p"], e["zeros"], e["scales"])
                g_idx = np.arange(K, dtype=np.int32) // GS
                if act:
                    g_idx = rng.permutation(g_idx).astype(np.int32)
                state.update({hf + ".qweight": qw, hf + ".qzeros": qz, hf + ".scales": sc,
                              hf + ".g_idx": g_idx})
            else:
                qw, qz, sc = JQC.pack_awq(e["w_p"], e["zeros"], e["scales"])
                state.update({hf + ".qweight": qw, hf + ".qzeros": qz, hf + ".scales": sc})
    return {k: np.asarray(v) for k, v in state.items()}


def _ds_state():
    """A tiny DeepSeek-V2 (tests/test_torch_tp_moe.py's, no q LoRA) whose q
    and o projections and shared expert are GPTQ too, beside its GPTQ expert
    stacks (kv_b_proj stays dense: both packages split its weight into the
    absorbed W_UK and W_UV)."""
    hf = dict(DS_HF)
    rng = np.random.RandomState(3)
    out = []
    quant = ("self_attn.q_proj", "self_attn.o_proj", "shared_experts.")
    for name, arr in deepseek_state(hf, "gptq"):
        if name.endswith(".weight") and any(q in name for q in quant):
            N, K = arr.shape
            e = int4_entry(rng, K, N, sym=False, planar=False)
            qw, qz, sc = JQC.pack_gptq(e["w_p"], e["zeros"], e["scales"])
            base = name[: -len(".weight")]
            out += [(base + ".qweight", qw), (base + ".qzeros", qz), (base + ".scales", sc)]
        else:
            out.append((name, arr))
    return hf, out


def _fp8_npz(tree, path):
    """An ``.npz`` of a tree, FP8 payloads as their bytes."""
    flat = {k: (np.asarray(v).view(np.uint8) if k.endswith("w_f8") else np.asarray(v))
            for k, v in _flat(tree)}
    np.savez(path, **flat)
    return str(path)


# name -> (what makes the JAX tree, the ranks' source: "tree", "hf:<method>" or "auto_int8")
FORWARD = {
    "gptq_sym": (lambda: _gptq_tree(1), "tree"),
    # act-order o_proj: kept whole, its input all-gathered; down_proj in groups
    # of 64: one group a rank at TP=2, whose padding would make it as wide as
    # the whole, and a cut group at TP=4: whole at both
    "gptq_asym_perm": (lambda: _gptq_tree(2, sym=False, perm=("o_proj",),
                                          gs={"down_proj": 64}), "tree"),
    "gptq_loader": (None, "hf:gptq"),
    "awq_loader": (None, "hf:awq"),
    "fp8": (lambda: _fp8_tree(3), "tree"),
    "w8a8_auto": (lambda: _params(JModelConfig(**FWD_MODEL)), "auto_int8"),
    "w8a8_smooth": (_smooth_tree, "tree"),
    "fused": (lambda: _fused(_params(JModelConfig(**FWD_MODEL))), "tree"),
    "deepseek_gptq": (None, "hf:gptq"),
}
TP4 = ("gptq_sym", "gptq_asym_perm")
CASES = [(name, 2) for name in FORWARD] + [(name, 4) for name in TP4]


def _model(name):
    if name == "deepseek_gptq":
        return dataclasses.asdict(ds_configs(DS_HF)[1])
    return dict(FWD_MODEL)


def _jax_cfg(name):
    if name == "deepseek_gptq":
        return ds_configs(DS_HF)[0]
    return JModelConfig(**FWD_MODEL)


# ---------------------------------------------------------------------------
# the engine's GPTQ checkpoint directory
# ---------------------------------------------------------------------------

# each checkpoint's quantization_config
QUANT_CONFIGS = {
    "gptq": dict(quant_method="gptq", bits=4, group_size=GS, desc_act=True, sym=False),
    "awq": dict(quant_method="awq", bits=4, group_size=GS, zero_point=True, version="gemm"),
    "fp8": dict(quant_method="fp8", fmt="e4m3", activation_scheme="dynamic",
                weight_block_size=[32, 32]),
    "int8": dict(quant_method="int8"),
}


def _checkpoint(path, state, method):
    """A checkpoint directory of ENG_MODEL's geometry: config.json with the
    method's quantization_config, the tensors as ``pytorch_model.bin``."""
    path.mkdir()
    m = ENG_MODEL
    cfg = dict(architectures=["LlamaForCausalLM"], model_type="llama",
               hidden_size=m["dim_model"], intermediate_size=m["dim_ff"],
               num_hidden_layers=m["num_layers"], num_attention_heads=m["num_heads"],
               num_key_value_heads=m["num_kv_heads"], vocab_size=m["vocab_size"],
               max_position_embeddings=512, rms_norm_eps=1e-6, tie_word_embeddings=False,
               torch_dtype="float32", quantization_config=QUANT_CONFIGS[method])
    (path / "config.json").write_text(json.dumps(cfg))
    torch.save({k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                for k, v in state.items()}, path / "pytorch_model.bin")
    return str(path)


def _dense_state(tree, method=None, seed=0):
    """The HF tensors of a dense tree; ``method="fp8"``: every linear as e4m3
    ``.weight`` [out, in] with 32 x 32 ``.weight_scale_inv`` blocks."""
    rng = np.random.RandomState(seed)
    state = {"model.embed_tokens.weight": tree["embedding"]["w"],
             "model.norm.weight": tree["final_norm"]["w"],
             "lm_head.weight": np.ascontiguousarray(tree["lm_head"]["w"].T)}
    for i, layer in tree["layers"].items():
        pre = f"model.layers.{i}."
        state[pre + "input_layernorm.weight"] = layer["ln_attn"]["w"]
        state[pre + "post_attention_layernorm.weight"] = layer["ln_ff"]["w"]
        for name in LINEARS:
            group, proj = name.split(".")
            w = np.asarray(layer[group][proj]["w"])
            hf = pre + ("self_attn." if group == "attn" else "mlp.") + proj
            if method == "fp8":
                e = fp8_entry(rng, *w.shape, block=(32, 32))
                state[hf + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(e["w_f8"].view(np.uint8).T)).view(torch.float8_e4m3fn)
                state[hf + ".weight_scale_inv"] = np.ascontiguousarray(e["block_scale"].T)
            else:
                state[hf + ".weight"] = np.ascontiguousarray(w.T)
    return state


# the engine cases: a GPTQ checkpoint against the JAX engine (per step and
# with side-buffered windows); AWQ, FP8 (kept, and dequantized at load) and
# AUTO_INT8 checkpoints against the single-process port on the same directory
ENGINE = {"gptq_per_step": ("gptq", {}), "gptq_window": ("gptq", {"ZT_WINDOW_KV": "1"}),
          "awq": ("awq", {}), "fp8_kept": ("fp8", {"ZT_FP8_KEEP": "1"}), "fp8": ("fp8", {}),
          "int8": ("int8", {})}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """A pair for every TP=2 forward and the engine cases, a quartet for the
    TP=4 forwards, started together; the JAX trees beside."""
    tmp = tmp_path_factory.mktemp("tp_quant")
    fwd, jtrees = {}, {}
    for name, (build, source) in FORWARD.items():
        f = dict(model=_model(name), tokens=FWD_TOKENS, decode_token=DECODE_TOKEN)
        if source.startswith("hf:"):
            method = source[3:]
            if name == "deepseek_gptq":
                hf, items = _ds_state()
                state = dict(items)
                jtree = JH.map_hf_params(items, _jax_cfg(name), quant_method=method)
            else:
                state = _hf_state(_params(JModelConfig(**FWD_MODEL)), method)
                jtree = JH.map_hf_params(list(state.items()), _jax_cfg(name), quant_method=method)
            np.savez(tmp / f"hf_{name}.npz", **state)
            f.update(hf=str(tmp / f"hf_{name}.npz"), method=method)
            jtrees[name] = jax.device_get(jtree)
        else:
            tree = build()
            jtrees[name] = tree
            f["params"] = _fp8_npz(tree, tmp / f"fwd_{name}.npz")
            f["auto_int8"] = source == "auto_int8"
        fwd[name] = f
    dense = _params(JModelConfig(**ENG_MODEL), seed=5)
    states = {"gptq": _hf_state(dense, "gptq", seed=9), "awq": _hf_state(dense, "awq", seed=9),
              "fp8": _dense_state(dense, "fp8"), "int8": _dense_state(dense)}
    ckpts = {m: _checkpoint(tmp / f"ckpt_{m}", st, m) for m, st in states.items()}
    jeng = jax.device_get(JH.map_hf_params(list(states["gptq"].items()),
                                           JModelConfig(**ENG_MODEL), quant_method="gptq"))
    eng_params = _fp8_npz(jeng, tmp / "eng.npz")
    eng = {name: dict(model=dict(ENG_MODEL), params=eng_params, model_path=ckpts[method], env=env,
                      max_model_len=64, cache=dict(page_size=4, num_pages=64), sched=ENG_SCHED,
                      prompts=PROMPTS, arg=dict(max_length=8))
           for name, (method, env) in ENGINE.items()}
    for sub in ("tp2", "tp4"):
        (tmp / sub).mkdir()
    yield {
        "tp2": Ranks(dict(forward=fwd, engine=eng), 2, tmp / "tp2"),
        "tp4": Ranks(dict(forward={k: fwd[k] for k in TP4}), 4, tmp / "tp4"),
        "jtrees": jtrees,
        "cases": eng,
    }


# ---------------------------------------------------------------------------
# shard_linear
# ---------------------------------------------------------------------------

def _shards(path, entry, tp, parts=None):
    return [shard_linear(path, entry, r, tp, parts) for r in range(tp)]


def _bits(t):
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _whole(entry, shards):
    full = params_to_torch(entry, "cpu")
    for s in shards:
        assert s.keys() == full.keys()
        assert all(s[k].dtype == full[k].dtype and torch.equal(_bits(s[k]), _bits(full[k]))
                   for k in full)


@pytest.mark.parametrize("case", [
    "int4_planar_row", "int4_nibble_row", "int4_padded_row", "int4_col", "int4_perm_col",
    "int4_perm_row", "int4_group_cut_row", "int4_padded_whole", "int4_pad_as_wide_row",
    "int8_row", "int8_col", "fp8_block_row", "fp8_block_col", "fp8_block_cut_row",
    "fp8_channel_row", "fp8_channel_col", "fp8_tensor_col", "fused_qkv_int4",
    "fused_gate_up_int8", "fused_qkv_dense_bias", "fp8_block_col_cut_raises"])
def test_shard_linear_reassembles_the_entry(case):
    """Each rank's entry, and the ranks' entries put back together: the whole
    entry (rows: the weight's rows, dequantized, per-shard padding dropped;
    columns: every column-side leaf concatenated), or the whole on every rank
    where the slice would not be exact."""
    rng = np.random.RandomState(0)
    row, col = "layers.0.attn.o_proj", "layers.0.attn.q_proj"
    tp = 4 if case in ("int4_padded_row", "int4_group_cut_row") else 2
    if case == "int4_planar_row":
        entry, path = int4_entry(rng, 1024, 48), row  # shards of 512 rows: planar again
    elif case == "int4_nibble_row":
        entry, path = int4_entry(rng, 256, 48, sym=False), row  # 128-row shards: nibbles
    elif case == "int4_padded_row":
        entry, path = int4_entry(rng, 384, 16, gs=32), row  # 96 rows = 3 groups, padded to 4
    elif case == "int4_col":
        entry, path = int4_entry(rng, 512, 64, sym=False), col
    elif case == "int4_perm_col":
        entry, path = int4_entry(rng, 128, 64, perm=True), col
    elif case == "int4_perm_row":
        entry, path = int4_entry(rng, 512, 64, perm=True), row
    elif case == "int4_group_cut_row":
        entry, path = int4_entry(rng, 256, 64, gs=128), row  # 64 rows a rank cut a group
    elif case == "int4_padded_whole":
        # the loader's padded entry (3 groups -> 4, the last of zero scales): kept whole
        entry = TQ.pad_int4_groups(params_to_torch(int4_entry(rng, 96, 16, planar=False), "cpu"))
        path = row
    elif case == "int4_pad_as_wide_row":
        entry, path = int4_entry(rng, 64, 16, planar=False), row  # 1 group a rank -> 2
    elif case in ("int8_row", "int8_col"):
        w = rng.randn(256, 64).astype(np.float32)
        entry = {k: np.asarray(v) for k, v in TQC.auto_int8_from_fp(torch.from_numpy(w)).items()}
        entry["smooth"] = (rng.rand(256) + 0.5).astype(np.float32)
        entry["b"] = rng.randn(64).astype(np.float32)
        path = row if case == "int8_row" else col
    elif case.startswith("fp8_block"):
        entry = fp8_entry(rng, 256, 256, block=(256 if case == "fp8_block_cut_row" else 64, 64))
        path = row if "row" in case else col
        if case == "fp8_block_col_cut_raises":
            entry, path = fp8_entry(rng, 256, 128, block=(64, 128)), col
            with pytest.raises(ValueError, match="cuts its 128-column FP8 scale blocks"):
                shard_linear(path, entry, 0, 2)
            return
    elif case.startswith("fp8_channel"):
        entry, path = fp8_entry(rng, 256, 128, channel=True), row if "row" in case else col
    elif case == "fp8_tensor_col":
        entry, path = fp8_entry(rng, 256, 128), col
    elif case == "fused_qkv_int4":
        entry, path, parts = int4_entry(rng, 256, 128 + 64 + 64), "layers.0.attn.qkv_proj", [
            128, 64, 64]
    elif case == "fused_gate_up_int8":
        w = rng.randn(64, 256).astype(np.float32)
        entry = {k: np.asarray(v) for k, v in TQC.auto_int8_from_fp(torch.from_numpy(w)).items()}
        path, parts = "layers.0.mlp.gate_up_proj", [128, 128]
    elif case == "fused_qkv_dense_bias":
        entry = {"w": rng.randn(64, 256).astype(np.float32),
                 "b": rng.randn(256).astype(np.float32)}
        path, parts = "layers.0.attn.qkv_proj", [128, 64, 64]
    parts = parts if case.startswith("fused") else None
    shards = _shards(path, entry, tp, parts)
    full = params_to_torch(entry, "cpu")
    assert all(v.is_contiguous() for s in shards for v in s.values())
    if case in ("int4_perm_row", "int4_group_cut_row", "int4_padded_whole",
                "int4_pad_as_wide_row", "fp8_block_cut_row"):
        _whole(entry, shards)
        assert in_rows(shards[0]) == in_rows(full)  # the model gathers its input
        return
    if path == row:
        K = in_rows(full)
        k = K // tp
        if case == "int4_planar_row":
            assert all(s["w_p"].dtype == torch.uint8 and s["w_p"].shape[0] == k // 2 for s in shards)
        if case == "int4_nibble_row":
            assert all(s["w_p"].dtype == torch.int8 for s in shards)
        for s in shards:  # a shard holds fewer rows than tp times its input
            assert in_rows(s) < tp * k
        got = np.concatenate([dequant(s)[:k] for s in shards])
        np.testing.assert_array_equal(got, dequant(entry))
        for key in ("scale", "b"):
            if key in full:
                assert all(torch.equal(s[key], full[key]) for s in shards)
        if "smooth" in full:
            assert torch.equal(torch.cat([s["smooth"] for s in shards]), full["smooth"])
        return
    # columns: part by part
    widths = parts or [dequant(entry).shape[1]]
    want = dequant(entry)
    offs = np.cumsum([0] + widths)
    for r, s in enumerate(shards):
        cols = np.concatenate([np.arange(o + r * n // tp, o + (r + 1) * n // tp)
                               for o, n in zip(offs, widths)])
        np.testing.assert_array_equal(dequant(s), want[:, cols])
        if "b" in full:
            assert torch.equal(s["b"], full["b"][cols])
        for key in ("perm", "smooth"):
            if key in full:
                assert torch.equal(s[key], full[key])
        if "scale" in full and full["scale"].dim() == 0:
            assert torch.equal(s["scale"], full["scale"])


# a layer whose int4 linears go planar: K 256 (q/k/v, o, gate/up) and 512
# (down); a rank's column shards keep K 256, o_proj's row shard has 128 rows
PLANAR_MODEL = dict(FWD_MODEL, num_layers=1, dim_model=256, num_heads=4, num_kv_heads=2,
                    dim_ff=512)


@pytest.mark.parametrize("method", ["gptq", "awq", "fp8", "fp8_kept", "gptq_planar",
                                    "awq_planar"])
def test_loader_shard_is_the_shard_of_the_whole(method, monkeypatch):
    """``map_hf_params(..., shard=(rank, 2))`` converts each quantized linear
    and keeps the rank's entry: the shard of the tree it builds whole (FP8
    dequantized at load, and kept in FP8). At K a multiple of 256 every int4
    entry a rank keeps is packed planar where its rows allow, as the whole
    tree's are: the column shards (act-order q_proj under GPTQ too), a
    row shard of 256 rows, an act-order down_proj kept whole."""
    planar = method.endswith("_planar")
    method = method.replace("_planar", "")
    model = PLANAR_MODEL if planar else FWD_MODEL
    cfg = ModelConfig(**model)
    if method == "fp8_kept":
        monkeypatch.setenv("ZT_FP8_KEEP", "1")
        method = "fp8"
    else:
        monkeypatch.delenv("ZT_FP8_KEEP", raising=False)
    if method == "fp8":
        rng = np.random.RandomState(1)
        tree = _params(JModelConfig(**FWD_MODEL))
        state = {"model.embed_tokens.weight": tree["embedding"]["w"],
                 "model.norm.weight": tree["final_norm"]["w"],
                 "lm_head.weight": np.ascontiguousarray(tree["lm_head"]["w"].T)}
        for name in LINEARS:
            group, proj = name.split(".")
            K, N = tree["layers"]["0"][group][proj]["w"].shape
            e = fp8_entry(rng, K, N, block=(32, 32))
            hf = "model.layers.0." + ("self_attn." if group == "attn" else "mlp.") + proj
            state[hf + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(e["w_f8"].view(np.uint8).T)).view(torch.float8_e4m3fn)
            state[hf + ".weight_scale_inv"] = np.ascontiguousarray(e["block_scale"].T)
        items = list(state.items())
        cfg = cfg.replace(num_layers=1)
    else:
        items = list(_hf_state(_params(JModelConfig(**model)), method).items())
    full = TH.map_hf_params(items, cfg, dtype=torch.float32, quant_method=method)
    for rank in range(2):
        want = dict(_flat(shard_params(full, rank, 2, cfg)))
        got = dict(_flat(TH.map_hf_params(items, cfg, dtype=torch.float32, quant_method=method,
                                          shard=(rank, 2))))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and torch.equal(_bits(got[k]), _bits(want[k])), k
        if planar:
            rows = {"attn.o_proj": 128, "mlp.down_proj": 512 if method == "gptq" else 256}
            for name in LINEARS:
                w_p = got[f"layers.0.{name}.w_p"]
                k = rows.get(name, 256)
                assert (w_p.dtype, w_p.shape[0]) == ((torch.uint8, k // 2) if k % 256 == 0
                                                     else (torch.int8, k)), name


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _port_one(name, jtree):
    cfg = ModelConfig(**FWD_MODEL) if name != "deepseek_gptq" else ds_configs(DS_HF)[1]
    params = params_to_torch(jtree, "cpu", torch.float32)
    if name == "w8a8_auto":
        params = TQC.quantize_int8_params(params)
    return _port_forward(cfg, params)


@pytest.mark.parametrize("name,tp", CASES)
def test_forward_matches_single_process_and_jax_mesh(ranks, name, tp, monkeypatch):
    jtree = ranks["jtrees"][name]
    jcfg = _jax_cfg(name)
    jparams = jax.device_get(JQC.quantize_int8_params(jtree)) if name == "w8a8_auto" else jtree
    monkeypatch.delenv("ZT_PALLAS_INTERPRET", raising=False)
    want_pre, want_dec = _jax_forward(jcfg, jparams, tp)
    one_pre, one_dec = _port_one(name, jtree)
    outs = [r["forward"][name] for r in ranks[f"tp{tp}"].result()]
    for out in outs:
        assert out["prefill"] == outs[0]["prefill"] and out["decode"] == outs[0]["decode"]
    got_pre, got_dec = np.asarray(outs[0]["prefill"]), np.asarray(outs[0]["decode"])
    for got, one, want in ((got_pre, one_pre, want_pre), (got_dec, one_dec, want_dec)):
        np.testing.assert_allclose(got, one, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    _check_collectives(name, tp, outs[0])


def _check_collectives(name, tp, out):
    """The prefill's collectives: the embedding's all-reduce, each layer's
    row-parallel products (an fp32 all-reduce; W8A8: an fp32 MAX of the
    per-token absmax, then an int32 sum; a leaf kept whole: an all-gather of
    its input), the logits' all-gather."""
    ops = [(op, dtype, how) for op, dtype, shape, how in out["collectives"]]
    leaves = out["leaves"]
    L = FWD_MODEL["num_layers"]
    gathers = [o for o in ops if o[0] == "all_gather"]
    if name == "deepseek_gptq":
        # its o_proj (one group a rank, padded as wide as the whole: 64 rows)
        # on every layer and its shared expert's down_proj (half a group) on
        # the two MoE layers stay whole, their inputs gathered
        assert leaves["layers.1.attn.o_proj.w_p"][1][0] == 64
        assert len(gathers) == 1 + 3 + 2
    elif name in ("gptq_asym_perm", "gptq_loader"):
        # o_proj kept whole (perm), down_proj whole (a group a rank, or perm)
        whole = 2 * L if name == "gptq_asym_perm" else L
        assert len(gathers) == 1 + whole
        if name == "gptq_asym_perm":
            assert in_rows_of(leaves["layers.0.attn.o_proj.w_p"]) == FWD_MODEL["num_heads"] * 64
    elif name in ("w8a8_auto", "w8a8_smooth"):
        assert ops.count(("all_reduce", "torch.float32", "max")) == 2 * L
        assert ops.count(("all_reduce", "torch.int32", "sum")) == 2 * L
        assert len(gathers) == 1
    elif name == "fp8":
        # layer 1's down_proj in 128-row blocks: whole, gathered
        assert len(gathers) == 2
    else:
        assert len(gathers) == 1
        reduces = [o for o in ops if o[0] == "all_reduce"]
        assert len(reduces) == 1 + 2 * L and all(o[1] == "torch.float32" for o in reduces)


def in_rows_of(leaf):
    """The input rows of an int4 ``w_p`` leaf recorded as [dtype, shape]."""
    dtype, shape = leaf
    return shape[0] * (2 if dtype == "torch.uint8" else 1)


# ---------------------------------------------------------------------------
# W8A8: the int32 accumulator, AUTO_INT8's scales
# ---------------------------------------------------------------------------

class _ThreadGroup:
    """The collectives of ``world`` ranks run as threads of this process."""

    def __init__(self, world):
        self.world, self.barrier, self.slots = world, threading.Barrier(world), [None] * world

    def rank(self, r):
        group = self

        class Rank:
            rank, world = r, group.world

            def all_reduce(self, x, op=None):
                group.slots[r] = x.clone()
                group.barrier.wait()
                stack = torch.stack(group.slots)
                group.barrier.wait()
                return stack.amax(0) if "MAX" in str(op) else stack.sum(0)

        return Rank()


def _run_ranks(fn, world=2):
    group, out, errors = _ThreadGroup(world), [None] * world, []

    def run(r):
        try:
            out[r] = fn(group.rank(r), r)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return out


def test_w8a8_row_parallel_accumulator_is_exact(monkeypatch):
    """A row-parallel W8A8 shard on each rank: the codes (from the whole
    row's absmax), the int32 accumulator and the result equal the unsharded
    ones bit for bit, with and without a smooth vector."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(5, 256).astype(np.float32))
    x[2, 200] = 40.0  # an outlier in rank 1's half
    w = torch.from_numpy(rng.randn(256, 48).astype(np.float32))
    for smooth in (False, True):
        p = TQC.auto_int8_from_fp(w)
        if smooth:
            p["smooth"] = torch.from_numpy((rng.rand(256) + 0.5).astype(np.float32))
        accs = []
        real = TQ._int8_matmul
        monkeypatch.setattr(TQ, "_int8_matmul", lambda a, b: accs.append(real(a, b)) or accs[-1])
        whole = TQ.int8_linear(p, x)
        whole_acc = accs.pop()
        shards = [shard_linear("layers.0.mlp.down_proj", p, r, 2) for r in range(2)]
        outs = _run_ranks(lambda g, r: TQ.int8_linear(shards[r], x[:, r * 128:(r + 1) * 128], g))
        monkeypatch.setattr(TQ, "_int8_matmul", real)
        assert torch.equal(outs[0], whole) and torch.equal(outs[1], whole)
        # each rank's partial int32 products sum to the unsharded accumulator
        assert len(accs) == 2 and torch.equal(accs[0] + accs[1], whole_acc)


def test_auto_int8_rank_scales_are_the_whole_weights():
    """``quantize_int8_params(shard, tp=group)``: a row-parallel shard's
    scales are the whole weight's column absmax (a MAX over the ranks), its
    codes the whole codes' rows; a column-parallel shard's are its own."""
    cfg = ModelConfig(**FWD_MODEL)
    tree = params_to_torch(_params(JModelConfig(**FWD_MODEL)), "cpu", torch.float32)
    whole = TQC.quantize_int8_params(tree)
    shards = [shard_params(tree, r, 2, cfg=cfg) for r in range(2)]
    got = _run_ranks(lambda g, r: TQC.quantize_int8_params(shards[r], tp=g))
    for r in range(2):
        want, have = dict(_flat(shard_params(whole, r, 2, cfg=cfg))), dict(_flat(got[r]))
        assert want.keys() == have.keys()
        assert all(torch.equal(want[k], have[k]) for k in want)
        assert torch.equal(have["layers.0.mlp.down_proj.scale"],
                           whole["layers"]["0"]["mlp"]["down_proj"]["scale"])


# ---------------------------------------------------------------------------
# the reference's compiled reductions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["int4", "fp8", "int8"])
def test_reference_reduces_quantized_row_parallel_products(fmt):
    """The reference's ``linear`` on a 2-device mesh, its quantized leaves
    replicated (its rules name none), x sharded on K, output replicated,
    compiled: int4 and FP8 all-reduce an f32 product; int8 all-reduces the
    f32 per-token absmax [T] (then gathers the codes and runs the whole
    int32 dot, which the port's exact int32 all-reduce matches)."""
    from zhilight_tpu.ops.linear import linear as j_linear

    rng = np.random.RandomState(0)
    mesh = make_mesh(tp=2, dp=1, devices=jax.devices()[:2])
    rep = NamedSharding(mesh, P())
    if fmt == "int4":
        p = int4_entry(rng, 256, 64)
    elif fmt == "fp8":
        p = fp8_entry(rng, 256, 128, block=(128, 128))
    else:
        w = rng.randn(256, 64).astype(np.float32)
        p = {k: np.asarray(v) for k, v in TQC.auto_int8_from_fp(torch.from_numpy(w)).items()}
    p = {k: jax.device_put(jnp.asarray(v), rep) for k, v in p.items()}
    x = jax.device_put(jnp.ones((8, 256), jnp.bfloat16), NamedSharding(mesh, P(None, TP_AXIS)))
    fn = jax.jit(lambda p, x: j_linear(p, x), out_shardings=rep)
    hlo = fn.lower(p, x).compile().as_text()
    reduces = [line for line in hlo.splitlines() if "all-reduce(" in line]
    assert reduces, hlo[-3000:]
    if fmt in ("int4", "fp8"):
        assert all("= f32[8,64]" in r or "= f32[8,128]" in r for r in reduces), reduces
    else:
        assert any(("= f32[8]" in r or "= f32[8,1]" in r) for r in reduces), reduces


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _port_tokens(case, monkeypatch):
    """The single-process port's greedy tokens, ``LLM(model_path)`` on the
    case's checkpoint directory with its environment."""
    from zhilight_tpu_torch.config import CacheConfig, EngineConfig, SchedulerConfig
    from zhilight_tpu_torch.engine import DynamicBatchGenerator, GeneratorArg
    from zhilight_tpu_torch.llm import LLM

    with monkeypatch.context() as m:
        for key in ("ZT_WINDOW_KV", "ZT_FP8_KEEP"):
            m.delenv(key, raising=False)
        for key, value in case["env"].items():
            m.setenv(key, value)
        llm = LLM(model_path=case["model_path"], model_config=ModelConfig(**case["model"]),
                  device="cpu", engine_config=EngineConfig(
                      max_model_len=case["max_model_len"], cache=CacheConfig(**case["cache"]),
                      scheduler=SchedulerConfig(**case["sched"])))
        with DynamicBatchGenerator(llm) as gen:
            res = gen.batch_generate(case["prompts"], GeneratorArg(**case["arg"]), timeout=120)
    return [r.outputs[0].token_ids for r in res]


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_tokens_match_jax_tp2(ranks, name, monkeypatch):
    """Checkpoint directories served at TP=2, each rank's ``LLM(model_path)``
    loading its shard. The GPTQ one (act-order q_proj and down_proj): the JAX
    engine's greedy tokens at ParallelConfig(tp=2) on the same checkpoint's
    tree, per step; its window case (``ZT_WINDOW_KV=1`` on the ranks) is held
    to the same tokens: the JAX engine's window mode computes the same
    function (tests/test_torch_window.py holds the port's against it), and
    running it here in interpret mode would take this file past its minute.
    AWQ, FP8 (``ZT_FP8_KEEP=1`` and dequantized at load) and AUTO_INT8: the
    single-process port's tokens on the same directory, which
    tests/test_torch_loader.py, test_torch_fp8.py and test_torch_w8a8.py hold
    to the JAX engine's (their forward at TP=2 is held to the JAX mesh's
    above)."""
    case = ranks["cases"][name]
    if name.startswith("gptq"):
        if "jax_tokens" not in ranks:
            ranks["jax_tokens"] = _jax_tokens(ranks["cases"]["gptq_per_step"], monkeypatch)[0]
        want = ranks["jax_tokens"]
    else:
        want = _port_tokens(case, monkeypatch)
    r0, r1 = (r["engine"][name] for r in ranks["tp2"].result())
    assert r0["greedy"] == want and all(len(t) >= 1 for t in want)
    assert r0["finished"] and r0["finished"] == r1["finished"]
    if name == "gptq_window":
        assert r0["window_kv"] and r0["window_steps"] > 0 and r1["window_steps"] > 0
