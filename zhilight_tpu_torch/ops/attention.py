"""Attention on gathered (contiguous) KV: the port's plain path.

Counterpart of ``zhilight_tpu/ops/attention.py``. These are the plain
PyTorch versions that the CPU path runs and that the CUDA attention kernels
in ``ops/cuda`` are held against. Scores, softmax and both products are in
fp32; probabilities are rounded to V's dtype before the second product, as
the reference does (bf16 products are exact in fp32, so casting the operands
to fp32 reproduces ``preferred_element_type=float32``).

Conventions: q heads ``[T, Hq, D]``; KV gathered to ``[KV, Hkv, D]`` (one
sequence, prefill) or ``[B, KV, Hkv, D]`` (decode); GQA through a head-group
reshape, without repeating KV.
"""

from __future__ import annotations

import torch

__all__ = ["prefill_attention", "decode_attention"]

NEG_INF = -2.0e38


def prefill_attention(
    q: torch.Tensor,  # [T, Hq, D]
    k: torch.Tensor,  # [KV, Hkv, D] (cached prefix + current chunk)
    v: torch.Tensor,  # [KV, Hkv, Dv]
    cache_len,        # int or 0-d int tensor: tokens before this chunk
    q_len,            # int or 0-d int tensor: valid tokens in the chunk
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """Causal chunk attention against a contiguous context.

    Query i sits at global position cache_len + i and sees context positions
    j <= cache_len + i (and j > cache_len + i - sliding_window when set);
    padding (j >= cache_len + q_len) is masked. Returns [T, Hq, Dv]."""
    T, Hq, D = q.shape
    KV, Hkv, Dv = v.shape
    qg = q.reshape(T, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale

    q_pos = cache_len + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(KV, device=q.device)[None, :]
    mask = (k_pos <= q_pos) & (k_pos < cache_len + q_len)
    if sliding_window > 0:
        mask &= k_pos > q_pos - sliding_window
    scores = torch.where(mask, scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgts,skd->tkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(T, Hq, Dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,             # [B, Hq, D]
    k: torch.Tensor,             # [B, KV, Hkv, D]
    v: torch.Tensor,             # [B, KV, Hkv, Dv]
    context_lens: torch.Tensor,  # [B] int, includes the current token
    scale: float,
    sliding_window: int = 0,
) -> torch.Tensor:
    """One-token batched decode attention over gathered paged context: slot b
    attends to its first context_lens[b] tokens. Returns [B, Hq, Dv]."""
    B, Hq, D = q.shape
    _, KV, Hkv, Dv = v.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * scale

    k_pos = torch.arange(KV, device=q.device)[None, :]
    ctx = context_lens[:, None]
    mask = k_pos < ctx
    if sliding_window > 0:
        mask &= k_pos > ctx - 1 - sliding_window
    scores = torch.where(mask[:, None, None], scores, NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, Hq, Dv).to(q.dtype)
