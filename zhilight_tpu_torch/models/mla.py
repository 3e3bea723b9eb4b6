"""Multi-head Latent Attention, DeepSeek-V2/V3 (counterpart of
``zhilight_tpu/models/mla.py``).

Low-rank q (``q_a_proj`` / ``q_b_proj``, or a direct ``q_proj``) and kv
(``kv_a_proj`` / ``kv_b_proj``) projections; the cache stores one compressed
latent row of ``kv_lora_rank + qk_rope_head_dim`` elements per token
(``kvcache.paged.new_latent_cache``). Decode runs entirely in latent space as
single-"head" MQA with the up-projections absorbed:

  q_latent[h]  = q_nope[h] @ W_UK[h]
  score        = q_latent . c_kv + q_pe . k_pe
  out_latent   = softmax(score) . c_kv
  out[h]       = out_latent @ W_UV[h]

On CUDA tensors the middle two lines are the hand-written latent decode kernel
(``ops.cuda.attn_headmajor.paged_mla_decode``) on ``q_latent`` rounded to the
model dtype, and the last product runs in fp32, as the reference does around
its Pallas kernel; CPU tensors take :func:`_mla_decode`, the plain absorbed
path over gathered latents. Prefill decompresses gathered latents through
``kv_b_proj`` block by block with an online softmax, in plain torch as the
reference leaves it to XLA. The softmax scale follows DeepSeek's YaRN:
``qk_head_dim ** -0.5 * yarn_mscale(factor, mscale_all_dim) ** 2``.
Before attending, a prefill chunk or decode step rotates q_pe and k_pe and
writes its latent rows ``c_kv | rope(k_pe)`` in one kernel, the latent pool's
attention prologue (``kvcache.paged.rope_write_latent``); ``rms_norm`` of
c_kv stays outside it.

In a decode window with side-buffered writes (``side``, ``ZT_WINDOW_KV=1``)
the step's latent row goes into the window's side buffer instead of the pool;
the latent decode kernel returns flash partials over the pool and
:func:`_side_window_mla` merges the window's rows in plain torch
(``zhilight_tpu/models/mla.py:215-281``). A decode step with
``DecodeMeta.fused`` (``ZT_FUSED_KV=1``; the side buffer takes precedence)
skips the prologue's row write and calls ``ops.cuda.paged_attention``'s
``paged_mla_decode_fused``, which writes the latent row and attends in one
kernel, on the CPU too through its plain version
(``zhilight_tpu/models/mla.py:175-179, 190-212``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config.model_config import ModelConfig
from ..kvcache.paged import KVCache, gather_latent, rope_write_latent
from ..ops.attention import NEG_INF, merge_window
from ..ops.cuda import attn_headmajor, paged_attention
from ..ops.linear import linear
from ..ops.norms import rms_norm
from ..ops.rope import RopeTable, apply_rope_rot
from .base import PackedPrefillMeta

__all__ = ["mla_attention_layer", "mla_softmax_scale"]

Params = Dict[str, torch.Tensor]


def _yarn_mscale(scale: float, mscale: float) -> float:
    if scale <= 1.0:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def mla_softmax_scale(cfg: ModelConfig) -> float:
    scale = 1.0 / math.sqrt(cfg.mla.qk_head_dim)
    r = cfg.rope
    if r.type == "yarn" and r.mscale_all_dim:
        m = _yarn_mscale(r.factor, r.mscale_all_dim)
        scale = scale * m * m
    return scale


def _project_q(p: Params, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_nope [T, H, nope], q_pe [T, H, rope])."""
    m = cfg.mla
    if m.q_lora_rank:
        qa = rms_norm(linear(p["q_a_proj"], x), p["q_a_norm"]["w"], cfg.eps)
        q = linear(p["q_b_proj"], qa)
    else:
        q = linear(p["q_proj"], x)
    q = q.reshape(x.shape[0], cfg.num_heads, m.qk_head_dim)
    return q[..., : m.qk_nope_head_dim], q[..., m.qk_nope_head_dim :]


def _kv_b_weights(p: Params, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split kv_b_proj [lora, H*(nope+v)] into W_UK [lora, H, nope] and
    W_UV [lora, H, v] (views)."""
    m = cfg.mla
    w = p["kv_b_proj"]["w"].reshape(
        m.kv_lora_rank, cfg.num_heads, m.qk_nope_head_dim + m.v_head_dim
    )
    return w[..., : m.qk_nope_head_dim], w[..., m.qk_nope_head_dim :]


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum with fp32 accumulation and an fp32 result (the reference's
    ``preferred_element_type=float32``)."""
    return torch.einsum(eq, a.float(), b.float())


def mla_attention_layer(
    p: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    x: torch.Tensor,  # [T, D]
    positions: torch.Tensor,
    cache: KVCache,
    layer_idx: int,
    meta,
    mode: str,
    rot=None,
    side=None,
    tp=None,
):
    """MLA over the latent pool: write this step's latent rows, then attend
    (prefill chunk, packed chunks or decode step). With ``side`` (a decode
    window's side buffer) nothing is written and ``(out, cache, side_rows)``
    is returned. Under tensor parallelism (``tp``, the group; ``cfg`` the
    rank's, its ``num_heads / tp`` heads) the rank projects and attends its
    heads over its replica of the latent pool, which every rank writes
    alike, and ``o_proj`` is row parallel: its fp32 partials are
    all-reduced (``llama._reduce_linear``)."""
    from .llama import _o_proj

    m = cfg.mla
    T = x.shape[0]
    scale = mla_softmax_scale(cfg)

    q_nope, q_pe = _project_q(p, cfg, x)
    cos_f, sin_f = rot if rot is not None else rope.rot_values(positions)
    kv_a = linear(p["kv_a_proj"], x)  # [T, lora + rope]
    c_kv = rms_norm(kv_a[..., : m.kv_lora_rank], p["kv_a_norm"]["w"], cfg.eps)
    k_pe = kv_a[..., m.kv_lora_rank :]  # [T, rope], a view
    w_uk, w_uv = _kv_b_weights(p, cfg)

    if side is None and not (mode == "decode" and meta.fused):
        # the latent pool's prologue: q_pe and k_pe rotated, the latent row
        # c_kv | rope(k_pe) written, one kernel launch
        q_pe = rope_write_latent(cache, layer_idx, q_pe, c_kv, k_pe, cos_f, sin_f,
                                 rope.neox_style, meta.slot_mapping)
    else:
        q_pe = apply_rope_rot(q_pe, cos_f, sin_f, rope.neox_style)
        k_pe = apply_rope_rot(k_pe[:, None, :], cos_f, sin_f, rope.neox_style)[:, 0]
        latent = torch.cat([c_kv, k_pe], dim=-1)  # [T, latent_dim]
        if side is not None:
            out, rows = _side_window_mla(cache, layer_idx, q_nope, q_pe, latent, w_uk, w_uv,
                                         meta, side, scale, m)
            return _o_proj(p, out, tp), cache, rows
        out = _mla_decode_fused(q_nope, q_pe, latent, cache, layer_idx, w_uk, w_uv, meta, scale, m)
        return _o_proj(p, out, tp), cache

    if mode == "prefill" and isinstance(meta, PackedPrefillMeta):
        # the projections above ran on the fused [NS*TC] token batch;
        # attention masks per segment
        NS = meta.num_segments
        TC = T // NS
        outs = []
        for s in range(NS):
            sl = slice(s * TC, (s + 1) * TC)
            ctx_s = gather_latent(cache, layer_idx, meta.page_tables[s])
            outs.append(_mla_prefill(q_nope[sl], q_pe[sl], ctx_s, w_uk, w_uv,
                                     meta.cache_lens[s], meta.q_lens[s], scale, m))
        out = torch.cat(outs, dim=0)
    elif mode == "prefill":
        ctx = gather_latent(cache, layer_idx, meta.page_table)  # [KV, latent]
        out = _mla_prefill(q_nope, q_pe, ctx, w_uk, w_uv, meta.cache_len, meta.q_len, scale, m)
    elif x.is_cuda:
        out = _mla_decode_kernel(q_nope, q_pe, cache, layer_idx, w_uk, w_uv, meta, scale, m)
    else:
        ctx = gather_latent(cache, layer_idx, meta.page_tables)  # [B, KV, latent]
        out = _mla_decode(q_nope, q_pe, ctx, w_uk, w_uv, meta.context_lens, scale, m)

    return _o_proj(p, out, tp), cache


def _q_eff(q_nope: torch.Tensor, q_pe: torch.Tensor, w_uk: torch.Tensor) -> torch.Tensor:
    """Absorb W_UK into q and append the rope part: [B, H, lora + rope]."""
    q_latent = _einsum_f32("bhn,lhn->bhl", q_nope, w_uk).to(q_nope.dtype)
    return torch.cat([q_latent, q_pe.to(q_nope.dtype)], dim=-1)


def _mla_decode_kernel(q_nope, q_pe, cache, layer_idx, w_uk, w_uv, meta, scale, m):
    """Absorbed latent MQA through the latent decode kernel; the output
    up-projection multiplies in fp32."""
    out_latent = attn_headmajor.paged_mla_decode(
        _q_eff(q_nope, q_pe, w_uk),
        cache.latent[layer_idx][0],
        meta.page_tables,
        meta.context_lens,
        cache.page_size,
        scale,
        v_dim=m.kv_lora_rank,
    )
    return _einsum_f32("bhl,lhv->bhv", out_latent, w_uv).to(q_nope.dtype)


def _mla_decode_fused(q_nope, q_pe, latent, cache, layer_idx, w_uk, w_uv, meta, scale, m):
    """The step's latent rows written and attended in one kernel; the output
    up-projection multiplies in fp32."""
    out_latent = paged_attention.paged_mla_decode_fused(
        _q_eff(q_nope, q_pe, w_uk),
        cache.latent[layer_idx],
        latent,
        meta.slot_mapping,
        meta.page_tables,
        meta.context_lens,
        cache.page_size,
        scale,
        v_dim=m.kv_lora_rank,
    )
    return _einsum_f32("bhl,lhv->bhv", out_latent, w_uv).to(q_nope.dtype)


def _side_window_mla(cache, layer_idx, q_nope, q_pe, latent, w_uk, w_uv, meta, side, scale, m):
    """Absorbed latent MQA of a window step: the step's latent row goes into
    column ``side["step"]`` of the side rows [B, Kw, latent_dim] (in place),
    the latent decode kernel gives flash partials over the first
    ``side["pool_lens"][b]`` pool rows, the window's valid rows are attended
    in fp32 and merged exactly, and the up-projection multiplies in fp32.
    Returns (out [B, H, v_head_dim], side_rows)."""
    rows = side["rows"]
    rows[:, side["step"]] = latent.to(rows.dtype)
    q_eff = _q_eff(q_nope, q_pe, w_uk)  # [B, H, lora + rope]
    partial = attn_headmajor.paged_mla_decode(
        q_eff, cache.latent[layer_idx][0], meta.page_tables, side["pool_lens"], cache.page_size,
        scale, v_dim=m.kv_lora_rank, emit_partial=True,
    )  # fp32 (m [B, H], l [B, H], acc [B, H, lora])
    side_f = rows.float()
    scores = torch.einsum("bhx,bkx->bhk", q_eff.float(), side_f) * scale
    out_latent = merge_window(partial, scores, side["valid"][:, None, :],
                              lambda p: torch.einsum("bhk,bkv->bhv", p,
                                                     side_f[..., : m.kv_lora_rank]))
    return _einsum_f32("bhl,lhv->bhv", out_latent, w_uv).to(q_nope.dtype), rows


def _mla_decode(
    q_nope: torch.Tensor,  # [B, H, nope]
    q_pe: torch.Tensor,    # [B, H, rope]
    ctx: torch.Tensor,     # [B, KV, lora + rope]
    w_uk: torch.Tensor,    # [lora, H, nope]
    w_uv: torch.Tensor,    # [lora, H, v]
    context_lens: torch.Tensor,
    scale: float,
    m,
) -> torch.Tensor:
    """Absorbed-weight MQA in latent space over gathered latents."""
    dt = q_nope.dtype
    c_kv = ctx[..., : m.kv_lora_rank]
    k_pe = ctx[..., m.kv_lora_rank : m.kv_lora_rank + m.qk_rope_head_dim]

    q_latent = _einsum_f32("bhn,lhn->bhl", q_nope, w_uk).to(dt)
    scores = _einsum_f32("bhl,bsl->bhs", q_latent, c_kv)
    scores = scores + _einsum_f32("bhr,bsr->bhs", q_pe, k_pe)
    scores = scores * scale

    k_pos = torch.arange(ctx.shape[1], device=ctx.device)[None, :]
    mask = k_pos < context_lens[:, None]
    scores = torch.where(mask[:, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)

    out_latent = _einsum_f32("bhs,bsl->bhl", probs.to(c_kv.dtype), c_kv).to(dt)
    return _einsum_f32("bhl,lhv->bhv", out_latent, w_uv).to(dt)


# kv tokens decompressed per block: bounds the transient K, V and scores at
# O(block * H * (nope + v)) instead of O(context * H * (nope + v))
_MLA_PREFILL_BLOCK = 256


def _mla_prefill(
    q_nope: torch.Tensor,  # [T, H, nope]
    q_pe: torch.Tensor,    # [T, H, rope]
    ctx: torch.Tensor,     # [KV, lora + rope]
    w_uk: torch.Tensor,
    w_uv: torch.Tensor,
    cache_len: torch.Tensor,
    q_len: torch.Tensor,
    scale: float,
    m,
) -> torch.Tensor:
    """Chunk prefill: stream the context latents in blocks, decompress each
    block through kv_b_proj, attend with an online softmax, discard. The
    non-absorbed form, because prefill is bound by operations: decompressing a
    token once costs H*(nope+v) per latent element, the absorbed path
    2*T*H*(lora+rope) per token. Every block of the page table is visited
    (nothing is read back to cut the loop short); masked blocks change
    nothing."""
    T, H = q_nope.shape[0], q_nope.shape[1]
    KV = ctx.shape[0]
    dt = q_nope.dtype
    dev = ctx.device
    blk = min(_MLA_PREFILL_BLOCK, KV)

    q_pos = cache_len + torch.arange(T, dtype=torch.int32, device=dev)  # [T]
    total = cache_len + q_len
    m_run = torch.full((H, T, 1), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((H, T, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((H, T, m.v_head_dim), dtype=torch.float32, device=dev)

    for start in range(0, KV, blk):
        cb = ctx[start : start + blk]
        if cb.shape[0] < blk:  # the reference pads the last block with zero rows
            cb = torch.nn.functional.pad(cb, (0, 0, 0, blk - cb.shape[0]))
        c_kv = cb[..., : m.kv_lora_rank]
        k_pe = cb[..., m.kv_lora_rank : m.kv_lora_rank + m.qk_rope_head_dim]
        k_nope = _einsum_f32("sl,lhn->shn", c_kv, w_uk).to(dt)
        v = _einsum_f32("sl,lhv->shv", c_kv, w_uv).to(dt)
        s = _einsum_f32("thn,shn->hts", q_nope, k_nope)
        s = (s + _einsum_f32("thr,sr->hts", q_pe, k_pe)) * scale
        k_pos = start + torch.arange(blk, dtype=torch.int32, device=dev)[None, :]
        mask = (k_pos <= q_pos[:, None]) & (k_pos < total)
        s = torch.where(mask[None], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        pr = torch.exp(s - m_new)
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + pr.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _einsum_f32("hts,shv->htv", pr.to(dt), v)
        m_run = m_new

    out = acc / l_run.clamp_min(1e-20)  # [H, T, v]
    return out.transpose(0, 1).to(dt)  # [T, H, v]
