"""HF checkpoint loading: safetensors / torch ``.bin`` -> the port's params.

Counterpart of ``zhilight_tpu/utils/hf_loader.py``, its dense and int4
parts: the HF -> internal name mapping (dense, MLA, and the MoE names of
Qwen2-MoE, DeepSeek and Mixtral), the GPTQ/AWQ conversion into the
``ops/quant.py`` int4 format, per-expert tensors stacked into ``[E, ...]``
leaves, and the checkpoint readers. Leaves are torch
tensors in the reference's nesting and layout, on the CPU unless ``device``
is given. HF stores linear weights [out, in]; the port stores [in, out]
(x @ W), so dense kernels are transposed on load. With ``device`` given,
each tensor is moved there first and transposed, cast or (GPTQ planar fast
path) repacked there: a GPU does those passes over a 14B model's weights
far faster than the host.

FP8 checkpoints are a later slice and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config.model_config import ModelConfig
from ..ops.quant import pack_expert_int4, pack_int4
from .convert import to_tensor
from .quant_convert import convert_quant_tensors, planar_from_gptq

__all__ = ["load_hf_state", "map_hf_params", "map_hf_name", "iter_checkpoint", "iter_safetensors"]

Tensors = Iterable[Tuple[str, Any]]


# ---------------------------------------------------------------------------
# raw tensor iteration
# ---------------------------------------------------------------------------

def iter_safetensors(model_path: str) -> Tensors:
    """Yield (name, tensor) from every *.safetensors file in a directory."""
    try:
        from safetensors import safe_open
    except ImportError as e:
        raise RuntimeError("safetensors not available") from e

    files = sorted(f for f in os.listdir(model_path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {model_path}")
    for fname in files:
        with safe_open(os.path.join(model_path, fname), framework="pt") as f:
            for name in f.keys():
                yield name, f.get_tensor(name)


def _iter_torch_bin(model_path: str) -> Tensors:
    """Yield (name, tensor) from every *.bin / *.pt torch checkpoint file."""
    files = sorted(f for f in os.listdir(model_path) if f.endswith((".bin", ".pt")))
    for fname in files:
        state = torch.load(
            os.path.join(model_path, fname), map_location="cpu", mmap=True, weights_only=True
        )
        yield from state.items()


def iter_checkpoint(model_path: str) -> Tensors:
    if any(n.endswith(".safetensors") for n in os.listdir(model_path)):
        return iter_safetensors(model_path)
    return _iter_torch_bin(model_path)


# ---------------------------------------------------------------------------
# name mapping
# ---------------------------------------------------------------------------

# (hf regex, target template, needs_transpose). {i} = layer, {e} = expert.
# Target path "-" means: intentionally dropped.
_DENSE_RULES: List[Tuple[str, str, bool]] = [
    (r"^(model|language_model(\.model)?)\.embed_tokens\.weight$", "embedding.w", False),
    (r"^(model|language_model(\.model)?)\.norm\.weight$", "final_norm.w", False),
    (r"^lm_head\.weight$", "lm_head.w", True),
    (r"L\.input_layernorm\.weight$", "layers.{i}.ln_attn.w", False),
    (r"L\.post_attention_layernorm\.weight$", "layers.{i}.ln_ff.w", False),
    # attention
    (r"L\.self_attn\.(q|k|v|o)_proj\.weight$", "layers.{i}.attn.{m}_proj.w", True),
    (r"L\.self_attn\.(q|k|v|o)_proj\.bias$", "layers.{i}.attn.{m}_proj.b", False),
    (r"L\.self_attn\.(q|k)_norm\.weight$", "layers.{i}.attn.{m}_norm.w", False),
    # MLA (deepseek)
    (r"L\.self_attn\.q_a_proj\.weight$", "layers.{i}.attn.q_a_proj.w", True),
    (r"L\.self_attn\.q_a_layernorm\.weight$", "layers.{i}.attn.q_a_norm.w", False),
    (r"L\.self_attn\.q_b_proj\.weight$", "layers.{i}.attn.q_b_proj.w", True),
    (r"L\.self_attn\.kv_a_proj_with_mqa\.weight$", "layers.{i}.attn.kv_a_proj.w", True),
    (r"L\.self_attn\.kv_a_layernorm\.weight$", "layers.{i}.attn.kv_a_norm.w", False),
    (r"L\.self_attn\.kv_b_proj\.weight$", "layers.{i}.attn.kv_b_proj.w", True),
    # dense mlp
    (r"L\.mlp\.(gate|up|down)_proj\.weight$", "layers.{i}.mlp.{m}_proj.w", True),
    # qwen2-moe / deepseek shared + routed experts
    (r"L\.mlp\.gate\.weight$", "layers.{i}.mlp.router.w", True),
    (r"L\.mlp\.gate\.e_score_correction_bias$", "layers.{i}.mlp.router.e_score_correction_bias", False),
    (r"L\.mlp\.shared_expert\.(gate|up|down)_proj\.weight$", "layers.{i}.mlp.shared_expert.{m}_proj.w", True),
    (r"L\.mlp\.shared_experts\.(gate|up|down)_proj\.weight$", "layers.{i}.mlp.shared_expert.{m}_proj.w", True),
    (r"L\.mlp\.shared_expert_gate\.weight$", "layers.{i}.mlp.shared_expert_gate.w", True),
    (r"L\.mlp\.experts\.E\.(gate|up|down)_proj\.weight$", "layers.{i}.mlp.experts.{m}_proj.w.{e}", True),
    # mixtral
    (r"L\.block_sparse_moe\.gate\.weight$", "layers.{i}.mlp.router.w", True),
    (r"L\.block_sparse_moe\.experts\.E\.w1\.weight$", "layers.{i}.mlp.experts.gate_proj.w.{e}", True),
    (r"L\.block_sparse_moe\.experts\.E\.w3\.weight$", "layers.{i}.mlp.experts.up_proj.w.{e}", True),
    (r"L\.block_sparse_moe\.experts\.E\.w2\.weight$", "layers.{i}.mlp.experts.down_proj.w.{e}", True),
    # rotary inv_freq buffers occasionally stored in checkpoints
    (r"rotary_emb\.inv_freq$", "-", False),
]
_LAYER = r"^(?:model|language_model(?:\.model)?)\.layers\.(?P<i>\d+)"
_EXPERT = r"(?P<e>\d+)"


def _compile_rules():
    return [(re.compile(pat.replace("L", _LAYER).replace("E", _EXPERT)), target, tr)
            for pat, target, tr in _DENSE_RULES]


_COMPILED_RULES = _compile_rules()


def map_hf_name(name: str) -> Optional[Tuple[str, bool, Optional[int]]]:
    """HF tensor name -> (target path, transpose?, expert index or None), or
    None if dropped or unknown."""
    for pat, target, tr in _COMPILED_RULES:
        mobj = pat.search(name)
        if not mobj:
            continue
        if target == "-":
            return None
        # {m} = the matched projection letter/name: the last non-index group
        m = next((g for g in reversed(mobj.groups()) if g is not None and not g.isdigit()), None)
        path = target
        if "{i}" in path:
            path = path.replace("{i}", mobj.group("i"))
        if "{m}" in path:
            path = path.replace("{m}", m)
        e = mobj.groupdict().get("e")
        return path.replace(".{e}", ""), tr, int(e) if e is not None else None
    return None


def map_hf_name_is_dropped(name: str) -> bool:
    return name.endswith("rotary_emb.inv_freq") or ".vision" in name


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def _set_path(tree: Dict[str, Any], path: str, value):
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _numpy(arr: Any) -> np.ndarray:
    """A quant tensor as numpy (bf16 scales widen to their exact f32)."""
    if isinstance(arr, torch.Tensor):
        return (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
    return np.asarray(arr)


_QUANT_SUFFIXES = ("qweight", "qzeros", "scales", "g_idx")


def map_hf_params(
    tensors: Tensors,
    cfg: ModelConfig,
    dtype: Optional[torch.dtype] = None,
    strict: bool = True,
    quant_method: Optional[str] = None,
    device=None,
) -> Dict[str, Any]:
    """Build the nested param dict from (hf_name, array or tensor) pairs,
    its leaves on ``device`` (default: the CPU).

    ``quant_method`` ("gptq" | "awq") converts the packed checkpoint tensors
    of each quantized linear into the int4 format of ``ops/quant.py``."""
    if quant_method == "fp8":
        raise NotImplementedError("FP8 checkpoints are not ported yet")
    dtype = dtype or cfg.torch_dtype
    tree: Dict[str, Any] = {}
    expert_stash: Dict[str, Dict[int, torch.Tensor]] = {}  # stack path -> expert -> [in, out]
    quant_stash: Dict[str, Dict[str, Any]] = {}  # linear path -> kind -> array (or expert -> array)
    unmapped: List[str] = []

    for name, arr in tensors:
        # quantized linear tensors: strip the kind suffix, map the base name
        kind = next((s for s in _QUANT_SUFFIXES if name.endswith("." + s)), None)
        if kind is not None:
            mapped = map_hf_name(name[: -(len(kind) + 1)] + ".weight")
            if mapped is None:
                unmapped.append(name)
                continue
            path, _, e = mapped
            entry = quant_stash.setdefault(path[: -len(".w")], {})
            if e is not None:
                entry.setdefault(kind, {})[e] = _numpy(arr)
            else:
                entry[kind] = _numpy(arr)
            continue

        mapped = map_hf_name(name)
        if mapped is None:
            if not map_hf_name_is_dropped(name):
                unmapped.append(name)
            continue
        path, transpose, e = mapped
        t = to_tensor(arr).to(device)
        if transpose:
            t = t.t().contiguous()
        if e is not None:
            expert_stash.setdefault(path, {})[e] = t.to(dtype)
        else:
            _set_path(tree, path, t.to(_target_dtype(path, dtype)))

    for path, experts in expert_stash.items():
        _set_path(tree, path, torch.stack([experts[i] for i in range(max(experts) + 1)]))

    if quant_stash:
        _convert_quant_stash(tree, quant_stash, quant_method, device)

    if strict and unmapped:
        raise ValueError(f"unmapped checkpoint tensors: {unmapped[:10]}")
    return tree


def _target_dtype(path: str, dtype: torch.dtype) -> torch.dtype:
    # routers stay fp32 for routing numerics
    return torch.float32 if ".router." in path else dtype


def _gptq_trivial_gidx(entry) -> bool:
    g = entry.get("g_idx")
    if g is None or len(g) == 0:
        return True
    gs = len(g) // entry["scales"].shape[0]
    return bool(np.array_equal(g, np.arange(len(g)) // gs))


def _planar_fast_path_ok(entry) -> bool:
    """The direct int32 -> planar pack needs K % 256 == 0 and every group
    inside one nibble plane (K % (2*gs) == 0); otherwise go canonical so
    _pad_canon_int4 can pad."""
    K = entry["qweight"].shape[0] * 8
    gs = K // entry["scales"].shape[0]
    return K % 256 == 0 and K % (2 * gs) == 0


def _convert_expert_stack(entry, quant_method):
    """Per-expert quant tensors {kind: {expert: array}} -> one canonical
    stack {"w_p" int8 [E, K, N], "scales", "zeros" [E, G, N], "perm"? [E, K]},
    its K padded like a single linear's."""
    E = max(max(v) for v in entry.values()) + 1
    parts = [convert_quant_tensors({k: v[e] for k, v in entry.items()}, quant_method)
             for e in range(E)]
    if any("perm" in p for p in parts):
        # act_order expert stacks: every expert's rows were group-sorted by its
        # own g_idx; experts with a trivial g_idx get the identity, so the
        # stack is uniform. models/moe.py gathers each row's activations with
        # its expert's permutation.
        K = parts[0]["w_p"].shape[0]
        for p in parts:
            p.setdefault("perm", np.arange(K, dtype=np.int32))
    return _pad_canon_int4({k: np.stack([p[k] for p in parts], axis=0) for k in parts[0]})


def _convert_quant_stash(tree, quant_stash, quant_method, device):
    for path, entry in quant_stash.items():
        if isinstance(next(iter(entry.values())), dict):  # per-expert quant tensors
            for k, v in _convert_expert_stack(entry, quant_method).items():
                t = torch.from_numpy(v.astype({"w_p": np.int8, "perm": np.int32}.get(k, np.float32)))
                t = t.to(device)
                if k == "w_p" and v.shape[1] % 2 == 0:
                    # 4 bits a weight, each expert planar-packed on its own
                    # (ops/quant.pack_expert_int4), packed on the device
                    t = pack_expert_int4(t)
                _set_path(tree, f"{path}.{k}", t)
            continue
        if (
            quant_method == "gptq"
            and "qweight" in entry
            and _planar_fast_path_ok(entry)
            and _gptq_trivial_gidx(entry)
        ):
            # checkpoint int32 -> planar-packed uint8 directly (no int8 [K, N]
            # intermediate); zeros/scales through the canonical converter
            meta = convert_quant_tensors(
                {"qweight": entry["qweight"][:1], "qzeros": entry["qzeros"],
                 "scales": entry["scales"]},
                quant_method,
            )
            qweight = torch.from_numpy(entry["qweight"]).to(device)
            _set_path(tree, f"{path}.w_p", planar_from_gptq(qweight))
            _set_path(tree, f"{path}.scales", torch.from_numpy(meta["scales"]).to(device))
            _set_path(tree, f"{path}.zeros", torch.from_numpy(meta["zeros"]).to(device))
            continue
        canon = convert_quant_tensors(entry, quant_method)
        if canon is None:
            continue
        for k, v in _pad_canon_int4(canon).items():
            t = torch.from_numpy(v.astype({"w_p": np.int8, "perm": np.int32}.get(k, np.float32)))
            if k == "w_p" and _packable_int4(v.shape):
                # 4 bits/weight in device memory (ops/quant.pack_int4 layout)
                t = pack_int4(t)
            _set_path(tree, f"{path}.{k}", t.to(device))


def _pad_canon_int4(canon):
    """Pad the canonical int4 K dim to a multiple of 2*group_size.

    The planar packed layout needs every quant group inside one nibble plane.
    Padding K at the end with zero-SCALE groups keeps the dequant exact, and
    the activations are padded with zero columns at call time
    (ops/quant.int4_linear)."""
    w = canon["w_p"]  # [K, N] int8 nibbles
    K = w.shape[-2]
    G = canon["scales"].shape[-2]
    gs = K // G
    K2 = -(-K // (2 * gs)) * (2 * gs)
    if K2 == K:
        return canon
    pad_w = [(0, 0)] * w.ndim
    pad_w[-2] = (0, K2 - K)
    canon["w_p"] = np.pad(w, pad_w)
    pad_s = [(0, 0)] * canon["scales"].ndim
    pad_s[-2] = (0, K2 // gs - G)
    canon["scales"] = np.pad(canon["scales"], pad_s)  # zero scales
    canon["zeros"] = np.pad(canon["zeros"], pad_s)
    if "perm" in canon:
        p = canon["perm"]
        extra = np.broadcast_to(np.arange(K, K2, dtype=p.dtype), p.shape[:-1] + (K2 - K,))
        canon["perm"] = np.concatenate([p, extra], axis=-1)
    return canon


def _packable_int4(shape) -> bool:
    return len(shape) == 2 and shape[0] % 256 == 0


def load_hf_state(
    model_path: str, cfg: ModelConfig, dtype=None, quant=None, device=None
) -> Dict[str, Any]:
    """Load a full HF checkpoint directory into the port's param dict, its
    leaves on ``device``.

    ``quant`` is the QuantConfig of the checkpoint's ``quantization_config``;
    it selects the packed-tensor conversion."""
    method = None
    if quant is not None and quant.enabled:
        from ..config.quant_config import QuantType

        method = {
            QuantType.GPTQ: "gptq",
            QuantType.AWQ: "awq",
            QuantType.FP8: "fp8",
            QuantType.FP8_BLOCK: "fp8",
        }.get(quant.quant_type)
    params = map_hf_params(
        iter_checkpoint(model_path), cfg, dtype=dtype, strict=False, quant_method=method,
        device=device,
    )
    if cfg.tie_lm_head and "lm_head" in params:
        del params["lm_head"]
    return params
