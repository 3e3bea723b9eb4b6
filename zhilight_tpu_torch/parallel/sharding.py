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
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from ..config.model_config import ModelConfig
from ..utils.convert import to_tensor

__all__ = [
    "COL",
    "ROW",
    "REP",
    "param_shard_dim",
    "shard_params",
    "shard_leaf",
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

# the keys that mark a quantized linear (ops/linear.py); only expert stacks shard them
_QUANT_KEYS = ("w_p", "w_q", "w_f8")
# fused projections, whose parts a single column slice would cut across
_FUSED = ("qkv_proj", "gate_up_proj")
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


def shard_params(params: Dict[str, Any], rank: int, tp: int, prefix: str = "") -> Dict[str, Any]:
    """Rank ``rank``'s shard of a nested parameter tree, leaf by leaf
    (``prefix`` is the tree's own path in the model's, for a subtree). An
    int4 expert stack (``.mlp.experts.``) is sliced on its expert dim, as the
    reference's rules slice it; any other quantized linear raises: the
    reference replicates dense quantized leaves, and serving them under
    tensor parallelism waits for its own slice."""

    def walk(tree, path):
        # an expert stack keeps whole experts, fused or quantized: it shards on the expert dim
        experts = _EXPERTS.search(path + ".")
        if tp > 1 and not experts and any(k in tree for k in _QUANT_KEYS):
            raise NotImplementedError(
                f"{path}: quantized linears under tensor parallelism are not ported yet "
                "(ROADMAP, queue 1)")
        if tp > 1 and not experts and any(k in tree for k in _FUSED):
            # one slice of [q | k | v] or [gate | up] would not be the rank's heads or columns
            raise NotImplementedError(f"{path}: split fused projections {_FUSED} into their "
                                      "parts before sharding them")
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
