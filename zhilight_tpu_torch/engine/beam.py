"""Beam search machinery.

Parity targets: the reference's beam stack —
``BeamSearchResultManager`` (score-sorted results with accept threshold,
src/generator/beam_result_manager.hpp:34-130), the beam update inside
``pick_top_k`` (batch_generator.cpp:1762-1850: joint top-(2*beam) over
cum_logprob + log_softmax across hypotheses, candidate score normalized by
length ``cum/(t+1)``, EOS/max-length candidates become results, the rest the
next beam set) and the early stop at :1566-1571 (stop when the best live
candidate can no longer beat the worst kept result).

TPU adaptation: each hypothesis occupies one decode slot with its own page
list; the prompt's full pages are ref-shared across beams, partial pages are
copied on device (executor.copy_pages), mirroring the reference's
hypothesis->KV-slot placement sharing (BeamBufferManager increase_buf_ref).
Beam groups run K=1 decode windows because the reorder is host-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["BeamResultManager", "BeamGroup", "BeamHypo"]


class BeamResultManager:
    """Keep the best ``num_results`` finished hypotheses by normalized score
    (reference beam_result_manager.hpp:34-130)."""

    def __init__(self, num_results: int):
        self.num_results = num_results
        self.results: List[Tuple[float, float, List[int], list]] = []  # (score, cum, tokens, toplp)

    @property
    def full(self) -> bool:
        return len(self.results) >= self.num_results

    @property
    def min_score(self) -> float:
        return min(r[0] for r in self.results) if self.results else -1e10

    def accept_score(self, score: float) -> bool:
        return not self.full or score >= self.min_score

    def add(self, tokens: List[int], cum_logprob: float, score: float, top_logprobs=None):
        self.results.append((score, cum_logprob, tokens, top_logprobs))
        self.results.sort(key=lambda r: -r[0])
        del self.results[self.num_results:]

    def best(self) -> List[Tuple[float, float, List[int], list]]:
        return list(self.results)


@dataclass
class BeamHypo:
    """One live hypothesis bound to a decode slot."""

    slot: int
    pages: List[int] = field(default_factory=list)
    output_tokens: List[int] = field(default_factory=list)
    cum_logprob: float = 0.0
    logprobs: List[float] = field(default_factory=list)
    top_logprobs: List[dict] = field(default_factory=list)


class BeamGroup:
    """Live beam-search state for one task (reference hypotheses[b] +
    next_tokens[b] + result_mgr[b])."""

    def __init__(self, task, slots: List[int]):
        self.task = task
        self.slots = slots  # fixed slot set, beams rotate over them
        self.beams: List[BeamHypo] = []
        self.results = BeamResultManager(max(task.arg.num_results, 1))
        self.steps = 0  # decode steps taken (t in the reference)

    @property
    def beam_size(self) -> int:
        return self.task.arg.beam_size

    def plan_update(
        self,
        candidates: List[Tuple[int, int, float]],  # (beam_idx, token, lp) sorted desc by cum+lp
        eos_ids,  # int or set of ints: any member ends a hypothesis
        keep_eos: bool,
        max_length: int,
        ignore_eos: bool = False,
    ) -> List[Tuple[int, int, float]]:
        """Apply one step's joint top-k candidates; returns the next beam
        assignment as (parent_beam_idx, token, new_cum) and files finished
        hypotheses into the result manager."""
        t = self.steps
        eos_set = {eos_ids} if isinstance(eos_ids, int) else set(eos_ids)
        next_beams: List[Tuple[int, int, float]] = []
        for beam_idx, token, lp in candidates:
            parent = self.beams[beam_idx]
            cum = parent.cum_logprob + lp
            score = cum / float(t + 1)  # length-normalized (reference :1806)
            is_eos = token in eos_set
            at_limit = len(parent.output_tokens) + 1 >= max_length
            if is_eos or at_limit:
                if ignore_eos and is_eos and not at_limit:
                    continue
                if self.results.accept_score(score):
                    tokens = list(parent.output_tokens)
                    if not is_eos or keep_eos:
                        tokens.append(token)
                    self.results.add(tokens, cum, score, list(parent.top_logprobs))
            else:
                next_beams.append((beam_idx, token, cum))
            if len(next_beams) >= self.beam_size:
                break
        self.steps += 1
        return next_beams

    def should_stop(self, next_beams: List[Tuple[int, int, float]]) -> bool:
        """Early stop (reference :1566-1571): results are full and the best
        live candidate's normalized score can't beat the worst kept result."""
        if not next_beams:
            return True
        if not self.results.full:
            return False
        best_cum = max(c for _, _, c in next_beams)
        best_score = best_cum / float(self.steps + 1)
        return not self.results.accept_score(best_score)
