"""Tensor-parallel parameter sharding (counterpart of
``zhilight_tpu/parallel/sharding.py``).

The reference declares a ``PartitionSpec`` per parameter name and lets XLA
insert the collectives. The port keeps the same rule table with the sharded
dimension in place of each spec: each rank holds one ``1 / tp`` slice of that
dimension, and the model (``models/llama.py``) all-reduces the row-parallel
products and all-gathers the vocab-sharded logits itself.

Linear weights are stored ``[in, out]`` (x @ W). "Column parallel" (COL)
shards the output dim, "row parallel" (ROW) the input dim (its product is a
partial sum), and REP leaves the leaf whole on every rank.

Quantized linears (int4, FP8, W8A8; ``ops/quant.py``) and fused ``qkv_proj``
/ ``gate_up_proj`` leaves are sharded a linear at a time
(:func:`shard_linear`), their role read from the rule of the linear's
``.w``. The reference names no rule for ``w_p``, ``scales``, ``w_f8``...
and replicates them; the port shards them with their scales, so that a rank
holds and reads ``1 / tp`` of the weight bytes (PERF.md, "why shard"). A
row-parallel leaf that a slice of ``K / tp`` rows would not keep exact (an
int4 leaf with an act-order ``perm``, a cut quant group or 128-row scale
block) stays whole on every rank, as the reference keeps it: the model then
gathers the rank's input and runs the whole product (``models/llama.py``
``_reduce_linear``, which tells the two apart by the rows the leaf holds).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from ..config.model_config import ModelConfig
from ..ops.linear import in_rows
from ..ops.quant import pack_int4, packable_int4, pad_int4_groups, unpack_int4
from ..utils.convert import to_tensor

__all__ = [
    "COL",
    "ROW",
    "REP",
    "param_shard_dim",
    "shard_params",
    "shard_leaf",
    "shard_linear",
    "check_tp",
    "rank_config",
]

COL = 1      # [in, out] kernels: the output dim  (qkv, gate, up)
ROW = 0      # [in, out] kernels: the input dim   (o_proj, down)
REP = None   # replicated                         (norms, biases of row-parallel outs)

# name pattern -> sharded dim, matched against flattened parameter paths such
# as "layers.0.attn.q_proj.w"; the first match wins. The reference's table
# (zhilight_tpu/parallel/sharding.py:38-84) row for row, its MoE and MLA rows
# included.
_RULES = [
    # attention projections
    (r"\.attn\.(q_proj|k_proj|v_proj|qkv_proj)\.w$", COL),
    (r"\.attn\.(q_proj|k_proj|v_proj|qkv_proj)\.b$", 0),
    (r"\.attn\.o_proj\.w$", ROW),
    (r"\.attn\.o_proj\.b$", REP),
    # qk-norm scales are per-head-dim, replicated
    (r"\.attn\.(q_norm|k_norm)\.", REP),
    # MLA: low-rank a-projections replicated (small), b-projections head-sharded
    (r"\.attn\.(q_a_proj|kv_a_proj)\.w$", REP),
    (r"\.attn\.(q_a_norm|kv_a_norm)\.", REP),
    (r"\.attn\.(q_b_proj|kv_b_proj)\.w$", COL),
    # dense mlp
    (r"\.mlp\.(gate_proj|up_proj|gate_up_proj)\.w$", COL),
    (r"\.mlp\.down_proj\.w$", ROW),
    (r"\.mlp\.(gate_proj|up_proj|gate_up_proj)\.b$", 0),
    (r"\.mlp\.down_proj\.b$", REP),
    # MoE: experts stacked on dim 0, sharded over tp (expert parallelism)
    (r"\.mlp\.experts\.(gate_proj|up_proj|gate_up_proj)\.w$", 0),
    (r"\.mlp\.experts\.down_proj\.w$", 0),
    # quantized expert stacks shard the expert dim too
    (r"\.mlp\.experts\.(gate_proj|up_proj|gate_up_proj|down_proj)\.(w_p|scales|zeros)$", 0),
    (r"\.mlp\.experts\.(gate_proj|up_proj|gate_up_proj|down_proj)\.(g_idx|perm)$", 0),
    (r"\.mlp\.router\.", REP),
    (r"\.mlp\.shared_expert(_gate)?\.(gate_proj|up_proj|gate_up_proj)\.w$", COL),
    (r"\.mlp\.shared_expert\.down_proj\.w$", ROW),
    # embeddings: vocab-sharded
    (r"(^|\.)embedding\.w$", 0),
    (r"(^|\.)lm_head\.w$", COL),
    # norms replicated
    (r"\.(ln_attn|ln_ff|ln_final|input_layernorm|post_attention_layernorm)\.", REP),
    (r"(^|\.)final_norm\.", REP),
]

_COMPILED = [(re.compile(pat), dim) for pat, dim in _RULES]

# the keys that mark a quantized linear (ops/linear.py)
_QUANT_KEYS = ("w_p", "w_q", "w_f8")
# fused projections, whose parts a single column slice would cut across
_FUSED = ("qkv_proj", "gate_up_proj")
# the leaves of a linear entry that stay whole in a column slice: input-side
# vectors (an int4 act-order perm, a SmoothQuant smooth)
_INPUT_SIDE = ("perm", "smooth")
# a path inside an expert stack
_EXPERTS = re.compile(r"\.mlp\.experts\.")


def param_shard_dim(path: str, ndim: int) -> Optional[int]:
    """The dim of the leaf at ``path`` that tensor parallelism shards, or None
    for a replicated leaf. Layer-stacked leaves (``layer_stack.``) carry a
    leading [L] axis, so a sharded dim moves one to the right, as the
    reference prepends an unsharded dim to the matched spec."""
    stacked = path.startswith("layer_stack.") or ".layer_stack." in path
    for pat, dim in _COMPILED:
        if pat.search(path):
            if dim is None:
                return None
            return dim + 1 if stacked else dim
    return None


def shard_leaf(path: str, leaf: Any, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of one leaf as a contiguous tensor of its own (so
    that the full leaf can be freed), or the leaf itself where it is
    replicated. Raises ``ValueError`` where the sharded dim does not divide by
    ``tp``, as placing the leaf on the reference's mesh does; nothing is
    padded."""
    t = to_tensor(leaf)
    dim = param_shard_dim(path, t.dim())
    if dim is None or tp == 1:
        return t
    n = t.shape[dim]
    if n % tp:
        raise ValueError(f"{path}: dim {dim} of {tuple(t.shape)} does not divide by tp={tp}")
    return t.narrow(dim, rank * (n // tp), n // tp).clone(memory_format=torch.contiguous_format)


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


def _out_cols(entry: Dict[str, Any]) -> int:
    """The output columns of a linear entry's weight, in any format."""
    return to_tensor(next(entry[k] for k in ("w", "w_p", "w_q", "w_f8") if k in entry)).shape[-1]


def _col_part(path: str, entry: Dict[str, torch.Tensor], off: int, n: int) -> Dict[str, torch.Tensor]:
    """Output columns ``[off, off + n)`` of a linear entry: the weight's
    columns (an int4 one's packed bytes are per column), their scales,
    zeros and bias; input-side vectors and a per-tensor scale whole. FP8
    block scales take their blocks: the slice must not cut one."""
    N = _out_cols(entry)
    out = {}
    for k, t in entry.items():
        if k == "block_scale":
            bn = N // t.shape[-1]
            if off % bn or n % bn:
                raise ValueError(f"{path}: the column slice [{off}, {off + n}) cuts its "
                                 f"{bn}-column FP8 scale blocks")
            out[k] = t[..., off // bn:(off + n) // bn]
        elif k in _INPUT_SIDE or t.dim() == 0:
            out[k] = t
        else:  # w, w_p, w_q, w_f8, scales, zeros, a per-channel scale, b
            out[k] = t[..., off:off + n]
    return out


def _row_part(entry: Dict[str, torch.Tensor], rank: int, tp: int) -> Optional[Dict[str, torch.Tensor]]:
    """Rank ``rank``'s ``K / tp`` input rows of a quantized linear entry, or
    None where the slice would not be exact and the leaf stays whole: an
    act-order ``perm`` (its sorted groups draw on every input row), K that tp
    does not divide, a slice that cuts an int4 group or a 128-row FP8 scale
    block, an int4 leaf already padded (a trailing zero-scale group, from
    ``pad_int4_groups``), or an int4 shard whose own padding would make it
    as wide as the whole (so that the model can tell a shard from a whole
    leaf by its rows). Output-side scales and the bias stay whole; an int4
    shard is padded on its own and repacked planar where its rows allow."""
    K = in_rows(entry)
    if "perm" in entry or K % tp:
        return None
    k = K // tp
    lo = rank * k
    out = {}
    if "w_p" in entry:
        scales = entry["scales"]
        gs = K // scales.shape[-2]
        if k % gs or not scales[-1].any():
            return None
        w = entry["w_p"]
        nib = unpack_int4(w) if w.dtype == torch.uint8 else w
        shard = pad_int4_groups({"w_p": nib[lo:lo + k], "scales": scales[lo // gs:(lo + k) // gs],
                                 "zeros": entry["zeros"][lo // gs:(lo + k) // gs]})
        rows = shard["w_p"].shape[0]
        if rows >= tp * k:
            return None
        if packable_int4(rows):
            shard["w_p"] = pack_int4(shard["w_p"])
        out.update(shard)
    elif "block_scale" in entry:
        bs = entry["block_scale"]
        bk = K // bs.shape[0]
        if k % bk:
            return None
        out["w_f8"], out["block_scale"] = entry["w_f8"][lo:lo + k], bs[lo // bk:(lo + k) // bk]
    else:
        wk = next(key for key in ("w", "w_q", "w_f8") if key in entry)
        out[wk] = entry[wk][lo:lo + k]
        if "smooth" in entry:
            out["smooth"] = entry["smooth"][lo:lo + k]
    for key in ("scale", "b"):
        if key in entry:
            out[key] = entry[key]
    return out


def shard_linear(path: str, entry: Dict[str, Any], rank: int, tp: int,
                 parts: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s entry of the linear at ``path`` (as
    ``"layers.0.attn.o_proj"``), dense or quantized (``ops/linear.py``'s
    formats), every leaf its own contiguous tensor so that the whole entry
    can be freed. The role is the rule of ``path + ".w"``:

    - COL: the rank's output columns of the weight, its scales, zeros and
      bias; with ``parts`` (the column widths of a fused leaf: q, k, v or
      gate, up) the rank's slice of each part, concatenated ``[q_r | k_r |
      v_r]``, so that the rank's output splits as the whole one does. Raises
      ``ValueError`` where tp does not divide a part, or a part's slice would
      cut an FP8 scale block.
    - ROW: the rank's ``K / tp`` input rows with their groups (an int4
      planar weight unpacked, sliced, padded and repacked on its own) or
      scale blocks, its smooth vector's rows; the output-side scale and the
      bias whole. Where that would not be exact (:func:`_row_part`) the entry
      stays whole on every rank.
    - REP (MLA's a-projections): whole."""
    entry = {k: to_tensor(v) for k, v in entry.items()}
    role = param_shard_dim(path + ".w", 2)
    if tp == 1 or role is None:
        return entry
    if role == COL:
        N = _out_cols(entry)
        widths = list(parts or [N])
        if sum(widths) != N:
            raise ValueError(f"{path}: parts {widths} do not make its {N} columns")
        pieces, off = [], 0
        for n in widths:
            if n % tp:
                raise ValueError(f"{path}: a part of {n} columns does not divide by tp={tp}")
            pieces.append(_col_part(path, entry, off + rank * (n // tp), n // tp))
            off += n
        return {k: _copy(pieces[0][k]) if k in _INPUT_SIDE or entry[k].dim() == 0
                else torch.cat([p[k] for p in pieces], dim=-1).contiguous() for k in entry}
    if "w" in entry:  # a dense row-parallel leaf: sliced as shard_leaf slices it
        return {k: shard_leaf(f"{path}.{k}", v, rank, tp) for k, v in entry.items()}
    part = _row_part(entry, rank, tp)
    return {k: _copy(v) for k, v in (entry if part is None else part).items()}


def fused_parts(name: str, entry: Dict[str, Any], cfg: ModelConfig) -> Optional[list]:
    """The column widths of a fused projection's parts (``gate_up_proj``:
    two halves; ``qkv_proj``: q, k and v by the model's heads), or None for
    any other linear."""
    if name == "gate_up_proj":
        N = _out_cols(entry)
        return [N // 2, N // 2]
    if name == "qkv_proj":
        q, kv = cfg.num_heads * cfg.dim_head, cfg.num_kv_heads * cfg.dim_head
        return [q, kv, kv]
    return None


def shard_params(params: Dict[str, Any], rank: int, tp: int, cfg: ModelConfig,
                 prefix: str = "") -> Dict[str, Any]:
    """Rank ``rank``'s shard of a nested parameter tree of the model ``cfg``
    (``prefix`` is the tree's own path in the model's, for a subtree). Dense
    leaves are sliced leaf by leaf; a quantized linear or a fused
    ``qkv_proj`` / ``gate_up_proj`` a linear at a time (:func:`shard_linear`;
    a fused ``qkv_proj``'s parts by ``cfg``'s heads). An expert stack (``.mlp.experts.``), fused or
    quantized, is sliced on its expert dim, as the reference's rules slice
    it."""

    def walk(tree, path):
        name = path.rsplit(".", 1)[-1]
        if (tp > 1 and not _EXPERTS.search(path + ".")
                and (any(k in tree for k in _QUANT_KEYS) or (name in _FUSED and "w" in tree))):
            return shard_linear(path, tree, rank, tp, fused_parts(name, tree, cfg))
        return {k: walk(v, f"{path}.{k}" if path else k) if isinstance(v, dict)
                else shard_leaf(f"{path}.{k}" if path else k, v, rank, tp)
                for k, v in tree.items()}

    return walk(params, prefix)


def check_tp(cfg, tp: int) -> None:
    """The model-level conditions of tensor parallelism over ``tp`` ranks:
    every size a rank slices divides by tp, as the reference's mesh
    placement requires: the vocab (the embedding's rows and the head's
    columns), the query heads (MLA's head-sharded projections too), the KV
    heads of a KV pool (an MLA model's latent pool is whole on every rank),
    ``dim_ff`` where a layer is dense, the routed experts (a rank holds
    ``num_experts / tp`` whole experts) and the shared expert's width.
    Raises ``ValueError``."""
    if tp <= 1:
        return
    sizes = [("vocab_size", cfg.vocab_size)]
    if not cfg.mla.enabled:
        sizes.append(("num_kv_heads", cfg.num_kv_heads))
    sizes.append(("num_heads", cfg.num_heads))
    if not all(cfg.is_moe_layer(i) for i in range(cfg.num_layers)):
        sizes.append(("dim_ff", cfg.dim_ff))
    if cfg.moe.enabled:
        sizes += [("num_experts", cfg.moe.num_experts),
                  ("shared_expert_intermediate_size", cfg.moe.shared_expert_intermediate_size)]
    for what, n in sizes:
        if n % tp:
            raise ValueError(f"{what} {n} does not divide by tp={tp}")


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The configuration one rank of a ``tp``-rank model computes with: its
    ``num_heads / tp`` query and ``num_kv_heads / tp`` KV heads (MLA's
    reshapes see the rank's heads) and its ``dim_ff / tp`` columns of a dense
    MLP. The vocabulary stays global (the logits are all-gathered to it), and
    so does the MoE configuration: the replicated router routes over every
    expert, each expert is whole on its rank, and the shared expert's width
    is read from its weights."""
    check_tp(cfg, tp)
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                       dim_ff=cfg.dim_ff // tp)


def is_shard(params: Dict[str, Any], cfg: ModelConfig, tp: int) -> bool:
    """Whether ``params`` is already one rank's shard (``init_params(...,
    shard=...)``, ``load_hf_state(..., shard=...)``) rather than the full
    tree: its embedding holds ``vocab_size / tp`` rows."""
    return tp > 1 and to_tensor(params["embedding"]["w"]).shape[0] == cfg.vocab_size // tp
