"""HF checkpoint loading: safetensors / torch ``.bin`` -> the port's params.

Counterpart of ``zhilight_tpu/utils/hf_loader.py``: the HF -> internal name
mapping (dense, MLA, and the MoE names of Qwen2-MoE, DeepSeek and Mixtral),
the GPTQ/AWQ conversion into the ``ops/quant.py`` int4 format, FP8 checkpoints
(e4m3 weights with block, per-channel or per-tensor scales: dequantized at
load by default, kept in FP8 with ``ZT_FP8_KEEP=1``), per-expert tensors
stacked into ``[E, ...]`` leaves, and the checkpoint readers. Leaves are torch
tensors in the reference's nesting and layout, on the CPU unless ``device``
is given. HF stores linear weights [out, in]; the port stores [in, out]
(x @ W), so dense kernels are transposed on load. With ``device`` given,
each tensor is moved there first and transposed, cast, (GPTQ planar fast
path) repacked or (FP8) decoded and scaled there: a GPU does those passes
over a 14B model's weights far faster than the host.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config.model_config import ModelConfig
from ..ops.quant import pack_expert_int4, pack_int4, packable_int4, pad_int4_groups
from ..parallel.sharding import shard_leaf, shard_linear
from .convert import to_tensor
from .quant_convert import convert_quant_tensors, planar_from_gptq

__all__ = ["load_hf_state", "map_hf_params", "map_hf_name", "iter_checkpoint", "iter_safetensors"]

Tensors = Iterable[Tuple[str, Any]]


# ---------------------------------------------------------------------------
# raw tensor iteration
# ---------------------------------------------------------------------------

def iter_safetensors(model_path: str, keep=None) -> Tensors:
    """Yield (name, tensor) from every *.safetensors file in a directory;
    with ``keep`` (a predicate on the name) only the tensors it keeps, the
    others never read."""
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
                if keep is None or keep(name):
                    yield name, f.get_tensor(name)


def _iter_torch_bin(model_path: str, keep=None) -> Tensors:
    """Yield (name, tensor) from every *.bin / *.pt torch checkpoint file
    (memory-mapped: a tensor that ``keep`` skips is never paged in)."""
    files = sorted(f for f in os.listdir(model_path) if f.endswith((".bin", ".pt")))
    for fname in files:
        state = torch.load(
            os.path.join(model_path, fname), map_location="cpu", mmap=True, weights_only=True
        )
        yield from ((n, t) for n, t in state.items() if keep is None or keep(n))


def iter_checkpoint(model_path: str, keep=None) -> Tensors:
    if any(n.endswith(".safetensors") for n in os.listdir(model_path)):
        return iter_safetensors(model_path, keep)
    return _iter_torch_bin(model_path, keep)


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
_LAYER_OF = re.compile(_LAYER + r"\.")


def in_layers(name: str, layers: Optional[Tuple[int, int]]) -> bool:
    """Whether the HF tensor ``name`` is kept by a stage of ``layers`` =
    (lo, hi): a tensor of layer i where lo <= i < hi, and every tensor
    outside the layers (embedding, final norm, head). Everything is kept
    where ``layers`` is None."""
    if layers is None:
        return True
    m = _LAYER_OF.match(name)
    return m is None or layers[0] <= int(m.group("i")) < layers[1]


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


_QUANT_SUFFIXES = ("qweight", "qzeros", "scales", "g_idx", "weight_scale", "weight_scale_inv")
# kinds of an FP8 linear: stashed as torch tensors (numpy has no FP8 type)
_FP8_KINDS = ("weight", "weight_scale", "weight_scale_inv")


def _itemsize(arr: Any) -> int:
    return arr.element_size() if isinstance(arr, torch.Tensor) else np.asarray(arr).dtype.itemsize


def map_hf_params(
    tensors: Tensors,
    cfg: ModelConfig,
    dtype: Optional[torch.dtype] = None,
    strict: bool = True,
    quant_method: Optional[str] = None,
    device=None,
    shard: Optional[Tuple[int, int]] = None,
    layers: Optional[Tuple[int, int]] = None,
) -> Dict[str, Any]:
    """Build the nested param dict from (hf_name, array or tensor) pairs,
    its leaves on ``device`` (default: the CPU).

    With ``layers=(lo, hi)`` (a pipeline stage's) the tensors of every other
    layer are skipped as they come, quantized ones and their scales
    included, before anything is converted or stashed; the embedding, the
    final norm and the head are kept. It composes with ``shard``.

    ``quant_method`` ("gptq" | "awq" | "fp8") converts the checkpoint tensors
    of each quantized linear into the formats of ``ops/quant.py``. With
    ``shard=(rank, tp)`` each dense tensor is sliced to rank ``rank``'s shard
    as it is read (``parallel.sharding.shard_leaf``), so that no rank holds
    more than one full tensor at a time; each quantized linear is converted
    whole (an int4 one to its unpadded canonical or planar form) and then
    cut to the rank's entry (``parallel.sharding.shard_linear``: its columns
    or rows with their scales, an int4 row shard padded and packed on its
    own), the whole freed before the next; and only the tensors of the
    rank's experts ``[rank * E / tp, (rank + 1) * E / tp)`` are read into its
    expert stacks (bf16, int4 or FP8)."""
    dtype = dtype or cfg.torch_dtype
    # under tensor parallelism a rank keeps experts [e0, e0 + E / tp) (their
    # stack index e - e0) and never converts or places another rank's
    e_lo, e_n = 0, None
    if shard is not None and shard[1] > 1 and cfg.moe.enabled:
        e_n = cfg.moe.num_experts // shard[1]
        e_lo = shard[0] * e_n

    def mine(e):
        return e is None or e_n is None or e_lo <= e < e_lo + e_n

    tree: Dict[str, Any] = {}
    expert_stash: Dict[str, Dict[int, torch.Tensor]] = {}  # stack path -> expert -> [in, out]
    quant_stash: Dict[str, Dict[str, Any]] = {}  # linear path -> kind -> array (or expert -> array)
    unmapped: List[str] = []

    for name, arr in tensors:
        if not in_layers(name, layers):
            continue
        # quantized linear tensors: strip the kind suffix, map the base name
        kind = next((s for s in _QUANT_SUFFIXES if name.endswith("." + s)), None)
        base = name if kind is None else name[: -(len(kind) + 1)] + ".weight"
        if (kind is None and quant_method == "fp8" and name.endswith(".weight")
                and _itemsize(arr) == 1):
            # an FP8 checkpoint keeps the projection under its plain .weight
            # name: stash the payload, so that its scales are applied at conversion
            kind = "weight"
        if kind is not None:
            mapped = map_hf_name(base)
            if mapped is None:
                unmapped.append(name)
                continue
            path, _, e = mapped
            if not mine(e):
                continue
            e = None if e is None else e - e_lo
            entry = quant_stash.setdefault(path[: -len(".w")], {})
            value = to_tensor(arr) if kind in _FP8_KINDS else _numpy(arr)
            if e is not None:
                entry.setdefault(kind, {})[e] = value
            else:
                entry[kind] = value
            continue

        mapped = map_hf_name(name)
        if mapped is None:
            if not map_hf_name_is_dropped(name):
                unmapped.append(name)
            continue
        path, transpose, e = mapped
        if not mine(e):
            continue
        t = to_tensor(arr).to(device)
        if transpose:
            t = t.t()
        if shard is not None and e is None:
            t = shard_leaf(path, t, *shard)
        elif transpose:
            t = t.contiguous()
        if e is not None:
            expert_stash.setdefault(path, {})[e - e_lo] = t.to(dtype)
        else:
            _set_path(tree, path, t.to(_target_dtype(path, dtype)))

    for path, experts in expert_stash.items():
        _set_path(tree, path, torch.stack([experts[i] for i in range(max(experts) + 1)]))

    if quant_stash:
        _convert_quant_stash(tree, quant_stash, quant_method, dtype, device, shard)

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
    pad_int4_groups can pad."""
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
    return pad_int4_groups(_int4_tensors({k: np.stack([p[k] for p in parts], axis=0)
                                          for k in parts[0]}))


def _as_e4m3(t: torch.Tensor) -> torch.Tensor:
    """A one-byte tensor's bits as float8_e4m3fn."""
    return t if t.dtype == torch.float8_e4m3fn else t.view(torch.uint8).view(torch.float8_e4m3fn)


def _fp8_dequant_host(w_oi, scale_oi, dtype=None, device=None) -> torch.Tensor:
    """[out, in] FP8 + block/channel/tensor scales -> [in, out] dequantized in
    fp32 and rounded to ``dtype`` (default bf16), on ``device`` (default: the
    host). Scales may be 2-D [out/B, in/B] (block), 1-D [out] (per-channel),
    0-D (per-tensor) or None."""
    t = _as_e4m3(to_tensor(w_oi)).to(device).float()
    if scale_oi is not None:
        s = to_tensor(scale_oi).to(device).float()
        if s.dim() == 2:
            (O, I), (so, si) = t.shape, s.shape
            t = (t.reshape(so, O // so, si, I // si) * s[:, None, :, None]).reshape(O, I)
        elif s.dim() == 1:  # per-output-channel
            t = t * s[:, None]
        elif s.dim() == 0:  # per-tensor
            t = t * s
        else:
            raise ValueError(f"unsupported fp8 weight_scale layout: ndim={s.dim()}")
    return t.t().contiguous().to(dtype or torch.bfloat16)


def _convert_fp8_entry(path, entry, dtype, device) -> Dict[str, torch.Tensor]:
    """One FP8 linear (or per-expert stack): apply its scales; returns its
    entry.

    By default the weight is dequantized at load to the model dtype and
    served as a dense ``w`` (experts stacked ``[E, in, out]``).
    ``ZT_FP8_KEEP=1`` keeps the FP8 payload ``w_f8`` [in, out] and its
    ``block_scale`` [in/128, out/128] (the checkpoint's [out, in] layouts
    transposed) for the ``fp8_block_matmul`` kernel: half the bytes in device
    memory and per decode step."""
    w = entry.get("weight")
    scale = entry.get("weight_scale_inv", entry.get("weight_scale"))
    keep = os.environ.get("ZT_FP8_KEEP") == "1"
    if w is None:
        # a scale without a stashed weight (the weight was not one byte wide
        # and went through the dense rule): record the scale
        return {} if scale is None else {"block_scale": scale.to(device).float().t().contiguous()}
    per_expert = isinstance(w, dict)
    if per_expert:
        E = max(w) + 1
        ws = [w[e] for e in range(E)]
        ss = [scale[e] if isinstance(scale, dict) else scale for e in range(E)]
    else:
        ws, ss = [w], [scale]
    if keep:
        if any(s is None or s.dim() != 2 for s in ss):
            raise ValueError(
                f"ZT_FP8_KEEP=1 requires 2-D block scales for every fp8 weight; {path} has "
                f"scale={[None if s is None else tuple(s.shape) for s in ss]}")
        # FP8 tensors are transposed and stacked as bytes
        wt = [_as_e4m3(x.to(device)).view(torch.uint8).t().contiguous() for x in ws]
        st = [s.to(device).float().t().contiguous() for s in ss]
        w_f8 = (torch.stack(wt) if per_expert else wt[0]).view(torch.float8_e4m3fn)
        return {"w_f8": w_f8, "block_scale": torch.stack(st) if per_expert else st[0]}
    deq = [_fp8_dequant_host(x, s, dtype, device) for x, s in zip(ws, ss)]
    return {"w": torch.stack(deq) if per_expert else deq[0]}


def _int4_tensors(canon) -> Dict[str, torch.Tensor]:
    """A canonical int4 entry's numpy arrays as torch tensors (nibbles int8,
    perm int32, scales and zeros f32)."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype({"w_p": np.int8, "perm": np.int32}.get(k, np.float32)))) for k, v in canon.items()}


def _convert_quant_stash(tree, quant_stash, quant_method, dtype, device, shard=None):
    """Convert each stashed quantized linear, and set it; under ``shard``
    (rank, tp) a linear that is not an expert stack is cut to the rank's
    entry first (``shard_linear``)."""
    for path, entry in quant_stash.items():
        per_expert = isinstance(next(iter(entry.values())), dict)
        if quant_method == "fp8":
            out = _convert_fp8_entry(path, entry, dtype, device)
        elif per_expert:  # per-expert quant tensors
            out = {}
            for k, t in _convert_expert_stack(entry, quant_method).items():
                t = t.to(device)
                if k == "w_p" and t.shape[1] % 2 == 0:
                    # 4 bits a weight, each expert planar-packed on its own
                    # (ops/quant.pack_expert_int4), packed on the device
                    t = pack_expert_int4(t)
                out[k] = t
        elif (
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
            out = {"w_p": planar_from_gptq(qweight),
                   "scales": torch.from_numpy(meta["scales"]).to(device),
                   "zeros": torch.from_numpy(meta["zeros"]).to(device)}
        else:
            canon = convert_quant_tensors(entry, quant_method)
            if canon is None:
                continue
            out = {k: v.to(device) for k, v in _int4_tensors(canon).items()}
        if shard is not None and not per_expert and any(k in out for k in ("w", "w_p", "w_f8")):
            # the rank's entry, cut from the unpadded canonical one so that
            # no rank holds another's padding; the whole goes with ``out``
            out = shard_linear(path, out, *shard)
        if not per_expert and "w_p" in out and out["w_p"].dtype == torch.int8:
            # int4 nibbles (whole, a rank's columns, or a leaf kept whole)
            # padded to whole planes and, where the rows allow, packed: 4
            # bits a weight in device memory (ops/quant.pack_int4 layout)
            out = pad_int4_groups(out)
            if packable_int4(out["w_p"].shape[0]):
                out["w_p"] = pack_int4(out["w_p"])
        for k, v in out.items():
            _set_path(tree, f"{path}.{k}", v)


def load_hf_state(
    model_path: str, cfg: ModelConfig, dtype=None, quant=None, device=None, shard=None,
    layers=None,
) -> Dict[str, Any]:
    """Load a full HF checkpoint directory into the port's param dict, its
    leaves on ``device``; with ``shard=(rank, tp)`` rank ``rank``'s shard
    of it, each tensor sliced as it is read; with ``layers=(lo, hi)`` only
    those layers (a pipeline stage's) beside the embedding, the final norm
    and the head, the other layers' tensors never read.

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
        iter_checkpoint(model_path, keep=lambda name: in_layers(name, layers)), cfg,
        dtype=dtype, strict=False, quant_method=method, device=device, shard=shard,
        layers=layers,
    )
    if cfg.tie_lm_head and "lm_head" in params:
        del params["lm_head"]
    return params
