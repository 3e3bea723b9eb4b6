"""Host-side penalty map computation.

Port of the reference's ngram repetition penalty (beam_util.cu:318-349
``calc_repetition_ngram``): a KMP failure function over the reversed token
sequence finds, for each position, the longest repeated n-gram ending there;
each token is penalized by ``ngram_penalty ** (ngram_len + 1)``, keeping the
max across occurrences. The scheduler multiplies in ``repetition_penalty``
and ships the (token, value) pairs to the device sampler
(beam_util.cu apply_beam_repetition_penalty semantics).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = ["calc_repetition_ngram", "ngram_penalty_map"]


def calc_repetition_ngram(token_ids: Sequence[int], ngram_penalty: float) -> Dict[int, float]:
    n = len(token_ids)
    if n == 0:
        return {}
    nxt: List[int] = [0] * n
    nxt[0] = -1
    for i in range(n - 1):
        p = nxt[i]
        while p >= 0:
            if token_ids[p + 1] == token_ids[i + 1]:
                break
            p = nxt[p]
        if token_ids[p + 1] == token_ids[i + 1]:
            nxt[i + 1] = p + 1
        else:
            nxt[i + 1] = -1

    ngrams = [0] * n
    for i in range(n):
        ng = nxt[i] + 1
        ngrams[i - ng] = max(ngrams[i - ng], ng)

    ret: Dict[int, float] = {}
    for i in range(n):
        t = token_ids[i]
        v = ngram_penalty ** (ngrams[i] + 1)
        if v > ret.get(t, 0.0):
            ret[t] = v
    return ret


def ngram_penalty_map(
    all_tokens: Sequence[int], ngram_penalty: float, repetition_penalty: float
) -> Dict[int, float]:
    """Combined ngram x repetition multiplicative map for one sequence
    (reference apply_beam_repetition_penalty: value = ngram_map[t] * rep).
    The port has the Python implementation only."""
    rev = list(all_tokens)[::-1]
    m = calc_repetition_ngram(rev, ngram_penalty)
    return {t: v * repetition_penalty for t, v in m.items()}
