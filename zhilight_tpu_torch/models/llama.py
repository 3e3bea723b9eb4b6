"""LLaMA-family transformer (counterpart of ``zhilight_tpu/models/llama.py``).

Covers the architectures of the reference: llama / mistral / qwen2
(attention bias) / qwen3 (qk-norm) / cohere (parallel residual, LayerNorm,
logit_scale) / MiniCPM "cpm_dragonfly" (scale_emb, depth-scaled residual,
dim_model_base logit scaling, tied head), and the MLA attention
(``models/mla.py``) and MoE feed-forward (``models/moe.py``) of DeepSeek-V2/V3,
Qwen2-MoE and Mixtral. Parameters are the reference's
nested dict layout holding torch tensors; forward functions run eagerly and
write the paged KV pool in place.

Every layer writes its new K and V rows (``ops.cuda.kv_write``), then
attends over the paged pool, whose layout ``kvcache/paged.py`` picks as the
reference does. Over either layout the rotation of q and k and the row write
(with an int8 pool's quantization) are one kernel, the pool's attention
prologue (``kvcache.paged.rope_write_kv``); in the window mode and in the
fused mode's decode steps below, q and k are rotated apart and the rows kept
in side buffers or written by the fused kernel. The layouts:

* the head-major packed pool (``2*head_dim % 128 == 0``): prefill chunks
  (single or packed) run ``ops.cuda.prefill_attention``, decode steps
  ``ops.cuda.attn_headmajor``;
* slot-major K and V pools (any other head_dim, or ``ZT_NO_PACKED_KV=1``):
  decode steps run ``ops.cuda.paged_attention``. A prefill chunk gathers its
  context (``gather_kv``) and runs the plain ``ops.attention.prefill_attention``,
  one segment at a time in a packed chunk, on the CPU and the GPU alike: the
  reference has no Pallas kernel there either and leaves this work to XLA
  (``zhilight_tpu/models/llama.py:348-366, 416-420``).

Over an int8 cache the kernels take their ``_q`` forms with the layer's
scales. Those wrappers launch the CUDA kernels for CUDA tensors and run their
plain PyTorch versions for CPU tensors. An MLA model keeps a latent pool
instead and attends through ``models/mla.py``.

Decode windows with side-buffered KV writes (``ZT_WINDOW_KV=1``, chosen by
the executor): :func:`forward_decode_window` keeps each layer's new K|V rows
(MLA: latent rows) in a side buffer instead of writing the pool; the decode
kernel returns flash partials over the pool as it was when the window began,
and the side rows are attended and merged in plain torch, on the GPU too, as
the reference leaves them to XLA. :func:`flush_window_rows` writes the
window's rows once at its end.

Tensor parallelism: given a rank's configuration
(``parallel.sharding.rank_config``: its heads and ``dim_ff``), its shard of
the weights and ``tp``, its group (``parallel.comm.TPGroup``), every function
here runs on the rank's share; ``o_proj`` and ``down_proj`` are all-reduced
(:func:`_reduce_linear`, in every weight format: dense, int4, FP8 and W8A8;
MLA's ``o_proj`` and the shared expert's too), a
MoE layer's routed sum over the rank's experts is all-reduced in
``models/moe.py``, the vocab-sharded embedding is looked up and
all-reduced (:func:`embed`) and the logits are all-gathered
(:func:`get_logits`), so that every rank holds the same activations and
logits. ``tp=None`` is one process.

Fused write + attend (``ZT_FUSED_KV=1``, read by the executor, which sets
``DecodeMeta.fused``): a decode step over slot-major pools in the model dtype
(never int8, never the packed head-major pool: :func:`_use_fused_write`)
skips the prologue and calls ``ops.cuda.paged_attention``'s
``paged_decode_attention_fused``, which writes the rows and attends in one
kernel (its plain version for CPU tensors); an MLA model's decode step calls
``paged_mla_decode_fused`` over its latent pool (``models/mla.py``). Prefill
never fuses, and a decode window with side buffers takes precedence.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..config.model_config import ModelConfig
from ..kvcache.paged import KVCache, _quantize_rows, flush_side_layers, gather_kv, rope_write_kv
from ..ops.activations import gated_act
from ..ops.attention import merge_window
from ..ops.attention import prefill_attention as attend_chunk
from ..ops.cuda import attn_headmajor, paged_attention, prefill_attention
from ..ops.linear import in_rows, linear, linear_f32, matmul_f32
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import int8_linear
from ..ops.rope import RopeTable, apply_rope_rot, build_rope_table
from ..parallel.sharding import shard_params
from .base import DecodeMeta, PackedPrefillMeta, PrefillMeta

__all__ = [
    "build_rope",
    "init_params",
    "param_count",
    "backbone",
    "forward_prefill",
    "forward_prefill_packed",
    "forward_score",
    "forward_hidden",
    "forward_decode",
    "forward_decode_window",
    "new_side_rows",
    "flush_window_rows",
    "get_logits",
]

Params = Dict[str, Any]


def build_rope(cfg: ModelConfig, max_model_len: int = 0) -> RopeTable:
    return build_rope_table(
        cfg.mla.qk_rope_head_dim if cfg.mla.enabled else cfg.dim_head, cfg.rope_theta, cfg.rope, cfg.max_position_embeddings, max_model_len
    )


def _reduce_linear(p: Params, x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel projection (``o_proj``, ``down_proj``). Under tensor
    parallelism each rank's partial product stays in fp32 (dense, int4 and
    FP8: ``ops.linear.linear_f32``, the int4 and FP8 kernels in their
    fp32-output modes), is all-reduced in fp32 and rounded to the model's
    dtype once, as the reference's compiled program does (its dot's fp32
    result is all-reduced before the convert); a W8A8 shard quantizes with
    the whole row's absmax and all-reduces its int32 products
    (``ops.quant.int8_linear``). The (replicated) bias is added after the
    sum. A leaf kept whole on every rank (``parallel.sharding.shard_linear``:
    it holds ``tp`` times the rank's input rows or more) takes the ranks'
    inputs, all-gathered, and computes the whole product instead."""
    if tp is None:
        return linear(p, x)
    if in_rows(p) >= tp.world * x.shape[-1]:
        return linear(p, tp.all_gather(x, dim=-1))
    if "w_q" in p:
        y = int8_linear(p, x, tp)
    else:
        y = tp.all_reduce(linear_f32(p, x)).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _o_proj(p: Params, out: torch.Tensor, tp) -> torch.Tensor:
    """The attention output [T, Hq(, D)] through ``o_proj``."""
    return _reduce_linear(p["o_proj"], out.reshape(out.shape[0], -1), tp)


def _norm(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.rms_norm:
        return rms_norm(x, p["w"], cfg.eps)
    return layer_norm(x, p["w"], cfg.eps)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project to q/k/v, from split or fused qkv weights."""
    T = x.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.dim_head
    if "qkv_proj" in p:
        q, k, v = torch.split(linear(p["qkv_proj"], x), [hq * d, hkv * d, hkv * d], dim=-1)
    else:
        q, k, v = linear(p["q_proj"], x), linear(p["k_proj"], x), linear(p["v_proj"], x)
    return q.reshape(T, hq, d), k.reshape(T, hkv, d), v.reshape(T, hkv, d)


def _maybe_qk_norm(p: Params, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor):
    if not cfg.qk_norm:
        return q, k
    norm = rms_norm if cfg.rms_norm else layer_norm  # qwen3 RMS / cohere LayerNorm
    return norm(q, p["q_norm"]["w"], cfg.eps), norm(k, p["k_norm"]["w"], cfg.eps)


def _use_fused_write(cache: KVCache, fused: bool) -> bool:
    """The fused write + attend decode (``zhilight_tpu/models/llama.py:105-120``):
    asked for, over slot-major pools in the model dtype only."""
    return fused and not cache.quantized and not cache.packed


def attention_layer(
    p: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    layer_idx: int,
    meta,
    mode: str,
    rot=None,
    side=None,
    tp=None,
):
    """Standard / GQA attention over the paged pool: write this step's K|V
    rows, then attend (prefill chunk, packed chunks or decode step). With
    ``side`` (a decode window's side buffer, see :func:`forward_decode_window`)
    nothing is written and ``(out, cache, side_rows)`` is returned."""
    q, k, v = _qkv(p, cfg, x)
    q, k = _maybe_qk_norm(p, cfg, q, k)
    cos_f, sin_f = rot if rot is not None else rope.rot_values(positions)
    scale = 1.0 / math.sqrt(cfg.dim_head)
    S, sw = cache.page_size, cfg.sliding_window

    if side is not None or (mode == "decode" and _use_fused_write(cache, meta.fused)):
        # the rows go to a side buffer or to the fused kernel: q and k rotated apart
        q = apply_rope_rot(q, cos_f, sin_f, rope.neox_style)
        k = apply_rope_rot(k, cos_f, sin_f, rope.neox_style)
        if side is not None:
            out, rows = _side_window_attention(cache, layer_idx, q, k, v, meta, side, scale)
            return _o_proj(p, out, tp), cache, rows
        out = paged_attention.paged_decode_attention_fused(
            q, cache.k[layer_idx], cache.v[layer_idx], k, v, meta.slot_mapping,
            meta.page_tables, meta.context_lens, S, scale, sw)
        return _o_proj(p, out, tp), cache
    # the pool's attention prologue: q and k rotated, K and V rows written (an
    # int8 pool's quantized), one kernel launch
    q = rope_write_kv(cache, layer_idx, q, k, v, cos_f, sin_f, rope.neox_style, meta.slot_mapping)
    if not cache.packed:
        out = _slot_major_attention(cache, layer_idx, q, meta, mode, scale, sw)
        return _o_proj(p, out, tp), cache
    # an int8 cache goes to the _q kernels with this layer's scales
    kv = (cache.k[layer_idx],)
    if cache.quantized:
        kv += (cache.k_scale[layer_idx], cache.v_scale[layer_idx])
    if mode == "prefill" and isinstance(meta, PackedPrefillMeta):
        attend = (prefill_attention.paged_prefill_attention_hm_packed_q if cache.quantized
                  else prefill_attention.paged_prefill_attention_hm_packed)
        out = attend(q, *kv, meta.page_tables, meta.cache_lens, meta.q_lens, S, scale, sw)
    elif mode == "prefill":
        attend = (prefill_attention.paged_prefill_attention_hm_q if cache.quantized
                  else prefill_attention.paged_prefill_attention_hm)
        out = attend(q, *kv, meta.page_table, meta.cache_len, meta.q_len, S, scale, sw)
    else:
        attend = (attn_headmajor.paged_decode_attention_hm_q if cache.quantized
                  else attn_headmajor.paged_decode_attention_hm)
        out = attend(q, *kv, meta.page_tables, meta.context_lens, S, scale, sw)
    return _o_proj(p, out, tp), cache


def _side_window_attention(cache: KVCache, layer: int, q, k, v, meta, side, scale: float):
    """A decode step of a window with side-buffered writes
    (``zhilight_tpu/models/llama.py:131-227``): this step's K|V rows go into
    column ``side["step"]`` of the layer's side rows [B, Hkv, Kw, 2D] (in
    place), the decode kernel gives flash partials over the first
    ``side["pool_lens"][b]`` pool tokens, and the window's valid side rows are
    attended in fp32 and merged exactly. Over an int8 pool this step's rows
    are quantized and dequantized first, so the window attends over the
    values the pool will hold after the flush. Returns (out [B, Hq*D],
    side_rows)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    rows = side["rows"]
    if cache.quantized:
        codes, scales = _quantize_rows(torch.stack((k, v)))
        k, v = (codes.float() * scales[..., None]).to(k.dtype)
    rows[:, :, side["step"]] = torch.cat((k, v), dim=-1).to(rows.dtype)

    kv = (cache.k[layer],)
    if cache.quantized:
        kv += (cache.k_scale[layer], cache.v_scale[layer])
    attend = (attn_headmajor.paged_decode_attention_hm_q if cache.quantized
              else attn_headmajor.paged_decode_attention_hm)
    partial = attend(q, *kv, meta.page_tables, side["pool_lens"], cache.page_size, scale, 0,
                     emit_partial=True)  # fp32 (m, l, acc) [B, Hkv, G(, D)]

    side_f = rows.float()
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bhgd,bhkd->bhgk", qg, side_f[..., :D]) * scale
    out = merge_window(partial, scores, side["valid"][:, None, None, :],
                       lambda p: torch.einsum("bhgk,bhkd->bhgd", p, side_f[..., D:]))
    return out.to(q.dtype).reshape(B, Hq * D), rows


def _slot_major_attention(
    cache: KVCache, layer: int, q: torch.Tensor, meta, mode: str, scale: float, sw: int
) -> torch.Tensor:
    """Attention over slot-major K and V pools (reference
    ``models/llama.py:348-366, 416-420, 443-457, 482-494``): a prefill chunk
    attends over its gathered context (an int8 one dequantized and rounded to
    bf16 by ``gather_kv``), a packed chunk one segment at a time; a decode step
    runs the paged decode kernel."""
    if mode == "prefill" and isinstance(meta, PackedPrefillMeta):
        TC = q.shape[0] // meta.num_segments
        outs = []
        for s in range(meta.num_segments):
            ck, cv = gather_kv(cache, layer, meta.page_tables[s])
            outs.append(attend_chunk(q[s * TC:(s + 1) * TC], ck, cv, meta.cache_lens[s],
                                     meta.q_lens[s], scale, sw))
        return torch.cat(outs)
    if mode == "prefill":
        ck, cv = gather_kv(cache, layer, meta.page_table)
        return attend_chunk(q, ck, cv, meta.cache_len, meta.q_len, scale, sw)
    S = cache.page_size
    if cache.quantized:
        return paged_attention.paged_decode_attention_q(
            q, cache.k[layer], cache.v[layer], cache.k_scale[layer], cache.v_scale[layer],
            meta.page_tables, meta.context_lens, S, scale, sw)
    return paged_attention.paged_decode_attention(
        q, cache.k[layer], cache.v[layer], meta.page_tables, meta.context_lens, S, scale, sw)


# ---------------------------------------------------------------------------
# feed-forward and block
# ---------------------------------------------------------------------------

def dense_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Gated MLP, from split or fused gate+up weights."""
    if "gate_up_proj" in p:
        g, u = linear(p["gate_up_proj"], x).chunk(2, dim=-1)
    else:
        g, u = linear(p["gate_proj"], x), linear(p["up_proj"], x)
    return _reduce_linear(p["down_proj"], gated_act(g, u, cfg.activate_fn), tp)


def mlp_layer(p: Params, cfg: ModelConfig, x: torch.Tensor, layer_idx: int,
              tp=None) -> torch.Tensor:
    if cfg.is_moe_layer(layer_idx):
        from .moe import moe_layer

        return moe_layer(p, cfg, x, tp)
    return dense_mlp(p, cfg, x, tp)


def decoder_layer(
    p: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    layer_idx: int,
    meta,
    mode: str,
    rot=None,
    side=None,
    tp=None,
):
    """Pre-norm block: sequential residual by default, Cohere's parallel
    variant, MiniCPM's depth-scaled residual (scale_depth / sqrt(L)). With
    ``side`` (decode windows) returns (x, cache, side_rows)."""
    if cfg.mla.enabled:
        from .mla import mla_attention_layer as attn_fn
    else:
        attn_fn = attention_layer
    attn_fn = functools.partial(attn_fn, tp=tp)
    res_scale = cfg.scale_depth / math.sqrt(cfg.num_layers) if cfg.scale_depth != 1.0 else 1.0
    h = _norm(p["ln_attn"], cfg, x)
    attn_out, cache, *rows = attn_fn(
        p["attn"], cfg, rope, h, positions, cache, layer_idx, meta, mode, rot=rot, side=side
    )
    if cfg.parallel_residual:
        return (x + attn_out + mlp_layer(p["mlp"], cfg, h, layer_idx, tp), cache, *rows)
    x = x + attn_out * res_scale
    h = _norm(p["ln_ff"], cfg, x)
    return (x + mlp_layer(p["mlp"], cfg, h, layer_idx, tp) * res_scale, cache, *rows)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Token embeddings [T, d]. Under tensor parallelism a rank holds rows
    ``[rank * V / tp, (rank + 1) * V / tp)`` of the table: it looks up its
    rows, gives zeros for the other ids and all-reduces, a sum with one
    non-zero term, so exact."""
    w = params["embedding"]["w"]
    if tp is None:
        x = w.index_select(0, tokens)
    else:
        local = tokens.long() - tp.rank * w.shape[0]
        mine = (local >= 0) & (local < w.shape[0])
        x = w.index_select(0, torch.where(mine, local, 0))
        x = tp.all_reduce(torch.where(mine[:, None], x, torch.zeros_like(x)))
    if cfg.scale_emb != 1.0:
        x = x * cfg.scale_emb
    return x.to(cfg.torch_dtype)


def backbone(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    meta,
    mode: str,
    input_embeddings: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Embedding -> N blocks -> final norm; rope's cos/sin are computed once
    and shared by every layer. ``input_embeddings`` [T, d] in the model's
    dtype replaces the token embedding (the multimodal path)."""
    x = embed(params, cfg, tokens, tp) if input_embeddings is None else input_embeddings
    rot = rope.rot_values(positions)
    for i in range(cfg.num_layers):
        x, cache = decoder_layer(
            params["layers"][str(i)], cfg, rope, x, positions, cache, i, meta, mode, rot=rot,
            tp=tp,
        )
    return _norm(params["final_norm"], cfg, x), cache


def get_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor, tp=None) -> torch.Tensor:
    """Project hidden states [..., d] to fp32 vocab logits [..., V], with the
    MiniCPM (dim_model_base) and Cohere (logit_scale) scalings. Under tensor
    parallelism a rank's head (or tied table) holds a slice of the vocab:
    the slices' logits are all-gathered, the same [..., V] on every rank."""
    if cfg.dim_model_base:
        hidden = hidden / (cfg.dim_model / cfg.dim_model_base)
    w = params["embedding"]["w"].t() if cfg.tie_lm_head else params["lm_head"]["w"]
    lead = hidden.shape[:-1]
    logits = matmul_f32(hidden.reshape(-1, hidden.shape[-1]), w)
    if tp is not None:
        logits = tp.all_gather(logits, dim=-1)
    logits = logits.reshape(*lead, -1)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def forward_prefill(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [T]
    meta: PrefillMeta,
    cache: KVCache,
    input_embeddings: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One prefill chunk; returns the fp32 logits [V] of its last valid token."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill",
                             input_embeddings, tp)
    last = (meta.q_len - 1).clamp_min(0).reshape(1).long()
    return get_logits(params, cfg, hidden.index_select(0, last), tp)[0], cache


def forward_prefill_packed(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [NS * TC]
    meta: PackedPrefillMeta,
    cache: KVCache,
    input_embeddings: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Packed chunks of NS sequences; returns each segment's last-valid-token
    logits [NS, V] (rows of empty segments are garbage the host discards)."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill",
                             input_embeddings, tp)
    NS = meta.num_segments
    TC = tokens.shape[0] // NS
    rows = torch.arange(NS, device=tokens.device) * TC + (meta.q_lens - 1).clamp_min(0)
    return get_logits(params, cfg, hidden.index_select(0, rows.long()), tp), cache


def forward_score(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [T]
    meta: PrefillMeta,
    cache: KVCache,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence fp32 logits [T, V]: the scoring utilities keep every
    position's logits, not only the last."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill",
                             tp=tp)
    return get_logits(params, cfg, hidden, tp), cache


def forward_hidden(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [T]
    meta: PrefillMeta,
    cache: KVCache,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence last-layer hidden states [T, d] after the final norm."""
    return backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "prefill", tp=tp)


def forward_decode(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,  # [B]
    meta: DecodeMeta,
    cache: KVCache,
    tp=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for all slots; returns fp32 logits [B, V]."""
    hidden, cache = backbone(params, cfg, rope, tokens, meta.positions, cache, meta, "decode",
                             tp=tp)
    return get_logits(params, cfg, hidden, tp), cache


def new_side_rows(cfg: ModelConfig, batch: int, window: int, dtype: torch.dtype, device=None):
    """The zeroed side buffer of a decode window, every layer in one tensor
    (``[i]`` is layer i's view, so the flush reads all layers in one launch):
    [L, B, Hkv, Kw, 2D] (K|V rows), or for MLA [L, B, Kw, latent_dim] (the
    port's latent pool is not padded, so neither are its side rows)."""
    shape = ((batch, window, cfg.mla.latent_dim) if cfg.mla.enabled
             else (batch, cfg.num_kv_heads, window, 2 * cfg.dim_head))
    return torch.zeros((cfg.num_layers, *shape), dtype=dtype, device=device)


def forward_decode_window(
    params: Params,
    cfg: ModelConfig,
    rope: RopeTable,
    tokens: torch.Tensor,      # [B]
    meta: DecodeMeta,
    cache: KVCache,
    side_rows,                 # new_side_rows' buffer ([i]: layer i's rows)
    side_valid: torch.Tensor,  # [B, Kw] bool: column j set iff the slot was live at step j
    pool_lens: torch.Tensor,   # [B] int32: pool tokens at the window's entry
    step: int,                 # this step's column of the window
    tp=None,
):
    """One decode step of a window with side-buffered KV writes: every layer
    puts its new rows into its side buffer (in place) instead of the pool and
    attends over the pool's partials and the side rows. Returns (fp32 logits
    [B, V], cache, side_rows), the side buffer written in place;
    :func:`flush_window_rows` writes the pool at the end of the window."""
    x = embed(params, cfg, tokens, tp)
    rot = rope.rot_values(meta.positions)
    for i in range(cfg.num_layers):
        side = dict(rows=side_rows[i], valid=side_valid, pool_lens=pool_lens, step=step)
        x, cache, _ = decoder_layer(params["layers"][str(i)], cfg, rope, x, meta.positions,
                                    cache, i, meta, "decode", rot=rot, side=side, tp=tp)
    hidden = _norm(params["final_norm"], cfg, x)
    return get_logits(params, cfg, hidden, tp), cache, side_rows


def flush_window_rows(
    cfg: ModelConfig,
    cache: KVCache,
    side_rows,                  # new_side_rows' buffer, or a sequence of per-layer rows
    side_valid: torch.Tensor,   # [B, Kw] bool
    entry_pos: torch.Tensor,    # [B] int32 position of each slot's first window row
    page_tables: torch.Tensor,  # [B, maxp] int32
) -> KVCache:
    """End of a decode window: every layer's live side rows (the first
    ``side_valid[b].sum()`` of slot b: a frozen slot stays frozen) go into the
    pool, one flush kernel for all the layers (an int8 pool's requantization
    in it)."""
    n_rows = side_valid.sum(dim=1, dtype=torch.int32)
    if not torch.is_tensor(side_rows):
        side_rows = torch.stack(list(side_rows))
    return flush_side_layers(cache, side_rows, entry_pos, n_rows, page_tables)


# ---------------------------------------------------------------------------
# random init (tests and measurements without checkpoints)
# ---------------------------------------------------------------------------

def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    device=None,
    dtype: Optional[torch.dtype] = None,
    shard: Optional[Tuple[int, int]] = None,
) -> Params:
    """Random weights in the reference's layout and scales (normal /
    sqrt(fan_in), embeddings 0.02, norms 1), drawn on ``device`` from a
    generator seeded with ``seed``. With ``shard=(rank, tp)`` the same full
    tensors are drawn, one layer at a time, and only rank ``rank``'s shard of
    each is kept (``parallel.sharding.shard_params``): every rank of a
    tensor-parallel model draws the same weights without holding them all."""
    keep = (lambda tree, path: tree) if shard is None else (
        lambda tree, path: shard_params(tree, *shard, prefix=path, cfg=cfg))
    dtype = dtype or cfg.torch_dtype
    gen = torch.Generator(device=device).manual_seed(seed)
    d, hq, hkv, dh = cfg.dim_model, cfg.num_heads, cfg.num_kv_heads, cfg.dim_head

    def dense(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def lin(in_dim, out_dim, bias=False):
        p = {"w": dense((in_dim, out_dim))}
        if bias:
            p["b"] = torch.zeros(out_dim, dtype=dtype, device=device)
        return p

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def layer(i: int) -> Params:
        if cfg.mla.enabled:
            m = cfg.mla
            attn = {
                "kv_a_proj": lin(d, m.kv_lora_rank + m.qk_rope_head_dim),
                "kv_a_norm": {"w": ones(m.kv_lora_rank)},
                "kv_b_proj": lin(m.kv_lora_rank, hq * (m.qk_nope_head_dim + m.v_head_dim)),
                "o_proj": lin(hq * m.v_head_dim, d),
            }
            if m.q_lora_rank:
                attn["q_a_proj"] = lin(d, m.q_lora_rank)
                attn["q_a_norm"] = {"w": ones(m.q_lora_rank)}
                attn["q_b_proj"] = lin(m.q_lora_rank, hq * m.qk_head_dim)
            else:
                attn["q_proj"] = lin(d, hq * m.qk_head_dim)
        else:
            attn = {
                "q_proj": lin(d, hq * dh, cfg.attn_bias),
                "k_proj": lin(d, hkv * dh, cfg.attn_bias),
                "v_proj": lin(d, hkv * dh, cfg.attn_bias),
                "o_proj": lin(hq * dh, d),
            }
        if cfg.qk_norm and not cfg.mla.enabled:
            attn["q_norm"] = {"w": ones(dh)}
            attn["k_norm"] = {"w": ones(dh)}
        if cfg.is_moe_layer(i):
            from .moe import init_moe_params

            mlp = init_moe_params(cfg, gen, dtype, device)
        else:
            mlp = {"gate_proj": lin(d, cfg.dim_ff), "up_proj": lin(d, cfg.dim_ff),
                   "down_proj": lin(cfg.dim_ff, d)}
        p = {"ln_attn": {"w": ones(d)}, "attn": attn, "mlp": mlp}
        if not cfg.parallel_residual:
            p["ln_ff"] = {"w": ones(d)}
        return p

    params: Params = {
        "embedding": keep({"w": dense((cfg.vocab_size, d), scale=0.02)}, "embedding"),
        "layers": {str(i): keep(layer(i), f"layers.{i}") for i in range(cfg.num_layers)},
        "final_norm": {"w": ones(d)},
    }
    if not cfg.tie_lm_head:
        params["lm_head"] = keep({"w": dense((d, cfg.vocab_size), scale=0.02)}, "lm_head")
    return params


def param_count(params: Params) -> int:
    """Number of parameters in a nested parameter dict."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
