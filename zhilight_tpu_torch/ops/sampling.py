"""Device-side batched sampling (counterpart of ``zhilight_tpu/ops/sampling.py``).

One [B, V] pass per step: count-based repetition/presence/frequency
penalties (token counts live on the device), host-computed multiplicative
penalty maps and logit bias, temperature, sort-free top-k/top-p masks by
value bisection, min-p, Gumbel-max sampling and top-logprobs. Greedy
decoding is temperature 0.

Random numbers: JAX's threefry streams cannot be reproduced, so each slot
draws its uniforms from its own ``torch.Generator`` (the executor seeds one
per slot when a task is admitted). A test passes the uniforms in directly
(``uniforms=``), which makes the masks and the sampled tokens comparable
with the reference given identical uniforms.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import torch

__all__ = [
    "SamplingParams",
    "SamplerState",
    "new_sampler_state",
    "record_tokens",
    "sample_step",
    "apply_penalties",
]

NEG_INF = -1.0e30


@dataclass
class SamplingParams:
    """Per-slot sampling parameters, batched [B]."""

    temperature: torch.Tensor         # [B] f32; 0 => greedy
    top_p: torch.Tensor               # [B] f32 in (0, 1]
    top_k: torch.Tensor               # [B] int32; 0 => disabled
    min_p: torch.Tensor               # [B] f32; 0 => disabled
    repetition_penalty: torch.Tensor  # [B] f32; 1 => off
    presence_penalty: torch.Tensor    # [B] f32; 0 => off
    frequency_penalty: torch.Tensor   # [B] f32; 0 => off
    seed: torch.Tensor                # [B] int32

    @staticmethod
    def greedy(batch: int, device=None) -> "SamplingParams":
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return SamplingParams(
            temperature=torch.zeros(batch, **f32),
            top_p=torch.ones(batch, **f32),
            top_k=torch.zeros(batch, **i32),
            min_p=torch.zeros(batch, **f32),
            repetition_penalty=torch.ones(batch, **f32),
            presence_penalty=torch.zeros(batch, **f32),
            frequency_penalty=torch.zeros(batch, **f32),
            seed=torch.zeros(batch, **i32),
        )

    def take(self, rows: torch.Tensor) -> "SamplingParams":
        """The parameters of the given slots (rows: int tensor [n])."""
        return SamplingParams(**{f.name: getattr(self, f.name)[rows] for f in fields(self)})


@dataclass
class SamplerState:
    """Per-slot device state across steps."""

    token_counts: torch.Tensor  # [B, V] int32 occurrences (prompt + generated)
    step: torch.Tensor          # [B] int32 decode step counter


def new_sampler_state(batch: int, vocab: int, device=None) -> SamplerState:
    return SamplerState(
        token_counts=torch.zeros((batch, vocab), dtype=torch.int32, device=device),
        step=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def record_tokens(
    state: SamplerState, slot: int, tokens: torch.Tensor, reset: bool = True
) -> SamplerState:
    """Count a (re)assigned slot's prompt tokens, in place. ``tokens`` [T]
    may be padded with -1. ``reset`` clears the slot's counts and step first."""
    row = state.token_counts[slot]
    if reset:
        row.zero_()
        state.step[slot] = 0
    row.index_add_(0, tokens.clamp_min(0).long(), (tokens >= 0).to(row.dtype))
    return state


def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    counts: torch.Tensor,  # [B, V] int32
    p: SamplingParams,
) -> torch.Tensor:
    """Repetition (divide positive / multiply negative logits of seen
    tokens), presence and frequency penalties."""
    seen = counts > 0
    rep = p.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, penalized, logits)
    logits = logits - p.presence_penalty[:, None] * seen.float()
    logits = logits - p.frequency_penalty[:, None] * counts.float()
    return logits


def _bisect(ok, lo: torch.Tensor, hi: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Largest t in [lo, hi] with ok(t), to fp32 resolution (ok(lo) holds)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        lo, hi = torch.where(good, mid, lo), torch.where(good, hi, mid)
    return lo


def _top_k_top_p_mask(logits: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Keep-mask of per-slot top-k and nucleus top-p, found without a sort:
    the top-k threshold is the largest t with count(logits >= t) >= k, the
    top-p threshold the largest t with mass(probs >= t) >= p. Tokens tied
    at a threshold are all kept."""
    B, V = logits.shape
    k = torch.where((top_k <= 0) | (top_k > V), V, top_k).float()
    probs = torch.softmax(logits, dim=-1)

    def count_ok(t):
        return (logits >= t[:, None]).float().sum(-1) >= k

    thr_k = _bisect(count_ok, logits.min(-1).values, logits.max(-1).values)
    keep_k = logits >= thr_k[:, None]

    def mass_ok(t):
        return torch.where(probs >= t[:, None], probs, 0.0).sum(-1) >= top_p

    thr_p = _bisect(mass_ok, torch.zeros_like(top_p), probs.max(-1).values)
    keep_p = probs >= thr_p[:, None]
    return keep_k & keep_p


def _scatter_rows(fill: float, tokens: torch.Tensor, values: torch.Tensor, V: int, add: bool) -> torch.Tensor:
    """[B, V] map: ``fill`` everywhere, ``values`` at ``tokens`` (-1 pads dropped)."""
    B = tokens.shape[0]
    out = torch.full((B, V + 1), fill, dtype=torch.float32, device=tokens.device)
    idx = torch.where(tokens >= 0, tokens, V).long()
    if add:
        out.scatter_add_(1, idx, values.float())
    else:
        out.scatter_(1, idx, values.float())
    return out[:, :V]


def sample_step(
    logits: torch.Tensor,  # [B, V] f32
    state: SamplerState,
    p: SamplingParams,
    generators: Optional[Sequence[torch.Generator]] = None,  # one per row
    uniforms: Optional[torch.Tensor] = None,  # [B, V] in [1e-20, 1): replaces the generators
    logit_bias_tokens: Optional[torch.Tensor] = None,  # [B, NB] int32, -1 pad
    logit_bias_values: Optional[torch.Tensor] = None,  # [B, NB] f32
    penalty_tokens: Optional[torch.Tensor] = None,     # [B, NP] int32, -1 pad
    penalty_values: Optional[torch.Tensor] = None,     # [B, NP] f32 multiplicative
    num_logprobs: int = 0,
    greedy_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, SamplerState]:
    """One sampling step for every slot.

    Returns (tokens [B] int32, chosen_logprob [B], top_logprobs [B, L],
    top_tokens [B, L] int32, new_state); the input state is not modified."""
    B, V = logits.shape
    logits = apply_penalties(logits.float(), state.token_counts, p)

    if penalty_tokens is not None:
        vmap_ = _scatter_rows(1.0, penalty_tokens, penalty_values.clamp_min(1e-6), V, add=False)
        logits = torch.where(logits > 0, logits / vmap_, logits * vmap_)
    if logit_bias_tokens is not None:
        logits = logits + _scatter_rows(0.0, logit_bias_tokens, logit_bias_values, V, add=True)

    logprobs_full = torch.log_softmax(logits, dim=-1)

    if greedy_only:
        tokens = torch.argmax(logits, dim=-1)
    else:
        greedy = p.temperature <= 0.0
        temp = torch.where(greedy, 1.0, p.temperature.clamp_min(1e-6))
        scaled = logits / temp[:, None]
        mask = _top_k_top_p_mask(scaled, p.top_k, p.top_p)
        # min_p: drop tokens with prob < min_p * p_max, i.e. in logit space
        # l < l_max + ln(min_p)
        lmax = scaled.max(-1, keepdim=True).values
        minp = p.min_p.clamp(0.0, 1.0)[:, None]
        cut = lmax + torch.log(minp.clamp_min(1e-30))
        mask = mask & ((scaled >= cut) | (minp <= 0.0))
        masked = torch.where(mask, scaled, NEG_INF)
        if uniforms is None:
            if generators is None:
                raise ValueError("sampling needs per-slot generators or uniforms")
            uniforms = torch.stack(
                [torch.rand(V, generator=g, device=logits.device) for g in generators]
            ).clamp_min(1e-20)
        gumbel = -torch.log(-torch.log(uniforms))
        sampled = torch.argmax(masked + gumbel, dim=-1)
        tokens = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    tokens = tokens.to(torch.int32)

    chosen = logprobs_full.gather(1, tokens.long()[:, None])[:, 0]
    if num_logprobs > 0:
        top_lp, top_tok = torch.topk(logprobs_full, num_logprobs, dim=-1)
    else:
        top_lp = logprobs_full.new_zeros((B, 0))
        top_tok = torch.zeros((B, 0), dtype=torch.int64, device=logits.device)

    counts = state.token_counts.clone()
    counts[torch.arange(B, device=counts.device), tokens.long()] += 1
    new_state = SamplerState(token_counts=counts, step=state.step + 1)
    return tokens, chosen, top_lp, top_tok.to(torch.int32), new_state
