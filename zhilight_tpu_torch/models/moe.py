"""Mixture-of-experts feed-forward (counterpart of ``zhilight_tpu/models/moe.py``).

Softmax or sigmoid scoring; greedy, group_limited_greedy (DeepSeek-V2) and
noaux_tc (DeepSeek-V3) top-k routing; ``norm_topk_prob``;
``routed_scaling_factor``; shared experts with an optional gate (Qwen2-MoE);
grouped expert products with no capacity dropping.

Int4 expert stacks (``w_p`` uint8 ``[E, in/2, out]``) go through
``ops.cuda.quant_ragged.w4a16_ragged_matmul``: the (token, expert) pairs are
laid out in expert-aligned tiles (``ops.quant.ragged_layout``) and every
routed expert's weights stream once at 4 bits a weight. The kernel runs for
CUDA tensors, its plain version for CPU tensors. Dense stacks
(``w`` ``[E, in, out]``) and int8-nibble stacks run the grouped product of
:func:`_grouped_experts` (``lax.ragged_dot`` in the
reference). Nothing on these paths reads a count back to the host: tile
counts are static worst cases and the occupied count stays on the device.
Expert parallelism (``e0 > 0``) is a later slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config.model_config import ModelConfig, MoEConfig
from ..ops.activations import gated_act
from ..ops.cuda import quant_ragged
from ..ops.linear import linear
from ..ops.quant import dequant_expert_int4, ragged_layout

__all__ = ["moe_layer", "select_experts", "init_moe_params"]

Params = Dict[str, torch.Tensor]


def select_experts(
    router_logits: torch.Tensor,  # [T, E] float32
    m: MoEConfig,
    correction_bias: Optional[torch.Tensor] = None,  # [E] for noaux_tc
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing: returns (weights [T, K] float32, expert_ids [T, K] int32).

      greedy               plain top-k over the scores
      group_limited_greedy DeepSeek-V2: top groups by max score, then top-k
      noaux_tc             DeepSeek-V3: sigmoid + correction bias, groups by
                           the sum of their top 2, weights from the
                           uncorrected scores
    """
    T, E = router_logits.shape
    if m.scoring_func == "softmax":
        scores = torch.softmax(router_logits.float(), dim=-1)
    elif m.scoring_func == "sigmoid":
        scores = torch.sigmoid(router_logits.float())
    else:
        raise ValueError(f"unknown scoring_func {m.scoring_func!r}")

    choice = scores + correction_bias[None, :] if m.topk_method == "noaux_tc" else scores

    if m.topk_method in ("group_limited_greedy", "noaux_tc") and m.n_group > 1:
        g = choice.reshape(T, m.n_group, E // m.n_group)
        if m.topk_method == "noaux_tc":
            group_scores = torch.topk(g, 2, dim=-1).values.sum(dim=-1)  # [T, n_group]
        else:
            group_scores = g.amax(dim=-1)
        top_groups = torch.topk(group_scores, m.topk_group, dim=-1).indices
        group_mask = torch.zeros((T, m.n_group), dtype=torch.bool, device=choice.device)
        group_mask.scatter_(1, top_groups, True)
        expert_mask = group_mask.repeat_interleave(E // m.n_group, dim=-1)
        choice = torch.where(expert_mask, choice, -torch.inf)

    expert_ids = torch.topk(choice, m.top_k, dim=-1).indices  # [T, K]
    weights = scores.gather(-1, expert_ids)
    if m.norm_topk_prob:
        weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    weights = weights * m.routed_scaling_factor
    return weights, expert_ids.to(torch.int32)


def _expert_weight(p: Params, dtype: torch.dtype) -> torch.Tensor:
    """Stacked expert weight [E, in, out]; int4 stacks are dequantized into
    ``dtype`` (the fallback beside the fused kernel)."""
    if "w" in p:
        return p["w"]
    if "w_p" in p:
        w = dequant_expert_int4(p["w_p"], p["scales"], p["zeros"], dtype)
        if "perm" in p:
            # act_order stacks store rows group-sorted by each expert's g_idx
            # (w_sorted[i] = w_orig[perm[i]]); scatter them back so the
            # fallback consumes unpermuted activations
            idx = p["perm"].long()[:, :, None].expand_as(w)
            w = torch.zeros_like(w).scatter_(1, idx, w)
        return w
    raise ValueError(f"unknown expert weight format: {sorted(p)}")


def _ragged_tile(num_rows: int) -> int:
    """m-tile of the fused grouped product: small tiles keep the alignment
    padding negligible at decode row counts; prefill rows amortize bigger ones."""
    return 8 if num_rows <= 512 else 64


def _use_quant_ragged(p_experts: Params) -> bool:
    """Whether the expert stacks go through ``w4a16_ragged_matmul``: all of
    them planar uint8 (on CUDA tensors the kernel raises on a shape it does
    not take; nothing routes around it)."""
    return all(proj.get("w_p") is not None and proj["w_p"].dtype == torch.uint8
               for proj in p_experts.values())


def quant_experts_contribution(
    x: torch.Tensor,             # [T, D] token activations
    flat_experts: torch.Tensor,  # [R = T*K] expert of each (token, k) pair
    pair_weights: torch.Tensor,  # [R] f32 routing weight per pair
    expert_arrays,               # flat (w_p, scales, zeros[, perm]) per projection
    fused: bool,                 # True => [gate_up, down]; else [gate, up, down]
    top_k: int,
    e0: int,
    act: str,
    has_perm: bool = False,      # act_order stacks: a K-permutation per expert
) -> torch.Tensor:
    """Weighted contribution [T, D] (fp32) of the int4 expert stacks to every
    token. Pair r = t*K + k keeps its place: the rows are gathered into
    expert-aligned tiles, multiplied, and read back per pair, so each token's
    K contributions are summed in a fixed order."""
    if e0 != 0:
        raise NotImplementedError("expert parallelism is not ported yet")
    T, D = x.shape
    E = expert_arrays[0].shape[0]
    R = flat_experts.shape[0]
    TM = _ragged_tile(R)
    sort_idx, dest, tile_expert, num_occ, mp = ragged_layout(flat_experts, E + 1, TM, occ_experts=E)
    xp = torch.zeros((mp, D), dtype=x.dtype, device=x.device)
    xp[dest] = x[sort_idx // top_k]
    stride = 4 if has_perm else 3
    # expert of each padded row (tile_expert is capped at E - 1)
    row_expert = tile_expert.long().repeat_interleave(TM) if has_perm else None

    def mm(i, xin):
        w_p, scales, zeros = expert_arrays[stride * i : stride * i + 3]
        Kw = 2 * w_p.shape[1]
        if xin.shape[1] < Kw:
            # loader-padded K (zero-scale groups): zero activation columns
            xin = torch.nn.functional.pad(xin, (0, Kw - xin.shape[1]))
        if has_perm:
            # act_order: gather each row's activations with its expert's permutation
            perm = expert_arrays[stride * i + 3]  # [E, K_proj]
            xin = xin.gather(1, perm[row_expert].long())
        return quant_ragged.w4a16_ragged_matmul(xin, w_p, scales, zeros, tile_expert, num_occ)

    if fused:
        g, u = mm(0, xp).chunk(2, dim=-1)
        down_i = 1
    else:
        g, u, down_i = mm(0, xp), mm(1, xp), 2
    down = mm(down_i, gated_act(g, u, act))

    # padded row of each pair in its original (token, k) order
    pair_row = torch.empty_like(dest)
    pair_row[sort_idx] = dest
    out = down[pair_row].float() * pair_weights.float()[:, None]
    return out.reshape(T, top_k, D).sum(dim=1)


def _grouped_mm(x_sorted: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """Rows sorted by expert times their expert's weight: [R, in] x [E, in,
    out] -> [R, out]. bf16 on CUDA goes to the library's grouped GEMM with the
    group ends on the device; otherwise one masked product per expert."""
    if x_sorted.is_cuda and x_sorted.dtype == torch.bfloat16:
        ends = torch.cumsum(group_sizes, 0).to(torch.int32)
        return torch._grouped_mm(x_sorted, w, offs=ends)
    ends = torch.cumsum(group_sizes, 0)
    starts = ends - group_sizes
    rows = torch.arange(x_sorted.shape[0], device=x_sorted.device)
    out = torch.zeros((x_sorted.shape[0], w.shape[-1]), dtype=x_sorted.dtype, device=x_sorted.device)
    for e in range(w.shape[0]):
        mine = ((rows >= starts[e]) & (rows < ends[e]))[:, None]
        out = out + torch.where(mine, x_sorted, 0) @ w[e]
    return out


def _grouped_experts(
    p_experts: Params,           # stacked weights [E, in, out] per projection
    x_sorted: torch.Tensor,      # [T*K, D] tokens sorted by expert
    group_sizes: torch.Tensor,   # [E]
    act: str,
) -> torch.Tensor:
    dt = x_sorted.dtype

    def w_of(name, width):
        # loader-padded int4 stacks carry zero-value pad rows past the
        # activation width: slice them off
        w = _expert_weight(p_experts[name], dt)
        return w[:, :width] if w.shape[1] > width else w

    if "gate_up_proj" in p_experts:
        gu = _grouped_mm(x_sorted, w_of("gate_up_proj", x_sorted.shape[-1]), group_sizes)
        g, u = gu.chunk(2, dim=-1)
    else:
        g = _grouped_mm(x_sorted, w_of("gate_proj", x_sorted.shape[-1]), group_sizes)
        u = _grouped_mm(x_sorted, w_of("up_proj", x_sorted.shape[-1]), group_sizes)
    h = gated_act(g, u, act)
    return _grouped_mm(h, w_of("down_proj", h.shape[-1]), group_sizes)


def moe_layer(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] -> [T, D]."""
    m = cfg.moe
    T, D = x.shape
    K, E = m.top_k, m.num_experts

    router_logits = torch.matmul(x.float(), p["router"]["w"].float())
    bias = p["router"].get("e_score_correction_bias")
    weights, expert_ids = select_experts(router_logits, m, bias)

    flat_experts = expert_ids.reshape(-1)  # [T*K]
    pair_w = weights.reshape(-1)           # [T*K] f32
    experts = p["experts"]
    if _use_quant_ragged(experts):
        fused = "gate_up_proj" in experts
        names = ("gate_up_proj", "down_proj") if fused else ("gate_proj", "up_proj", "down_proj")
        has_perm = any("perm" in experts[nm] for nm in names)
        arrs = []
        for nm in names:
            pr = experts[nm]
            arrs += [pr["w_p"], pr["scales"], pr["zeros"]]
            if has_perm:
                # projections quantized with a trivial g_idx get the identity,
                # so the operand layout stays uniform
                perm = pr.get("perm")
                if perm is None:
                    Kp = 2 * pr["w_p"].shape[1]
                    perm = torch.arange(Kp, dtype=torch.int32, device=x.device).expand(E, Kp)
                arrs.append(perm)
        routed = quant_experts_contribution(
            x, flat_experts, pair_w, arrs, fused, K, 0, cfg.activate_fn, has_perm=has_perm
        ).to(x.dtype)
    else:
        flat = flat_experts.long()
        sort_idx = torch.argsort(flat, stable=True)
        x_sorted = x[sort_idx // K]
        # a count by comparison: torch.bincount reads its maximum back to the host
        group_sizes = (flat[:, None] == torch.arange(E, device=x.device)[None, :]).sum(0)
        out_sorted = _grouped_experts(experts, x_sorted, group_sizes, cfg.activate_fn)
        out_sorted = out_sorted * pair_w[sort_idx][:, None].to(out_sorted.dtype)
        # back to (token, k) order: each token's K contributions sum in a fixed order
        out_pairs = torch.empty_like(out_sorted)
        out_pairs[sort_idx] = out_sorted
        routed = out_pairs.reshape(T, K, D).sum(dim=1).to(x.dtype)

    if "shared_expert" in p:
        from .llama import dense_mlp

        shared = dense_mlp(p["shared_expert"], cfg, x)
        if "shared_expert_gate" in p:
            gate = torch.sigmoid(linear(p["shared_expert_gate"], x).float())
            shared = (shared.float() * gate).to(x.dtype)
        routed = routed + shared
    return routed


def init_moe_params(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype, device=None) -> Params:
    """Random MoE weights in the reference's layout and scales (normal /
    sqrt(fan_in); fp32 router; dense expert stacks)."""
    m = cfg.moe
    d, f, E = cfg.dim_model, m.intermediate_size, m.num_experts

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w / math.sqrt(fan_in)).to(dtype)

    p: Params = {
        "router": {"w": dense((d, E), d).float()},
        "experts": {
            "gate_proj": {"w": dense((E, d, f), d)},
            "up_proj": {"w": dense((E, d, f), d)},
            "down_proj": {"w": dense((E, f, d), f)},
        },
    }
    if m.topk_method == "noaux_tc":
        p["router"]["e_score_correction_bias"] = torch.zeros(E, dtype=torch.float32, device=device)
    if m.shared_expert_intermediate_size:
        sf = m.shared_expert_intermediate_size
        p["shared_expert"] = {
            "gate_proj": {"w": dense((d, sf), d)},
            "up_proj": {"w": dense((d, sf), d)},
            "down_proj": {"w": dense((sf, d), sf)},
        }
        if m.shared_expert_gate:
            p["shared_expert_gate"] = {"w": dense((d, 1), d)}
    return p
