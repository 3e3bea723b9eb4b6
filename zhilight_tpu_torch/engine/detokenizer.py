"""Incremental UTF-8-safe streaming detokenization.

Parity: reference ``StreamHandler`` incremental decode
(zhilight/dynamic_batch.py:286-365) — hold back tokens whose decoded text ends
in an incomplete UTF-8 sequence / replacement char, and re-decode with a small
token context so sentencepiece word-boundary spaces are correct.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["IncrementalDetokenizer", "StopStringChecker", "truncate_at_stop"]


class IncrementalDetokenizer:
    def __init__(self, tokenizer, skip_special_tokens: bool = True):
        self.tokenizer = tokenizer
        self.skip_special = skip_special_tokens
        self.tokens: List[int] = []
        # index of the first token not yet emitted as text
        self.prefix_offset = 0
        # length of text already emitted for the context window
        self.read_offset = 0

    def put(self, new_tokens: List[int]) -> str:
        """Add tokens; return newly-finalized text (may be '')."""
        self.tokens.extend(new_tokens)
        prefix_text = self.tokenizer.decode(
            self.tokens[self.prefix_offset : self.read_offset],
            skip_special_tokens=self.skip_special,
        ) if self.read_offset > self.prefix_offset else ""
        full_text = self.tokenizer.decode(
            self.tokens[self.prefix_offset :], skip_special_tokens=self.skip_special
        )
        if full_text.endswith("�"):
            # incomplete multi-byte sequence: wait for more tokens
            return ""
        new_text = full_text[len(prefix_text) :]
        # slide the context window: keep the last few tokens as decode context
        self.prefix_offset = self.read_offset
        self.read_offset = len(self.tokens)
        return new_text

    def finish(self) -> str:
        """Flush any held-back text at end of stream."""
        full_text = self.tokenizer.decode(
            self.tokens[self.prefix_offset :], skip_special_tokens=self.skip_special
        )
        prefix_text = self.tokenizer.decode(
            self.tokens[self.prefix_offset : self.read_offset],
            skip_special_tokens=self.skip_special,
        ) if self.read_offset > self.prefix_offset else ""
        self.prefix_offset = self.read_offset = len(self.tokens)
        return full_text[len(prefix_text) :]


class StopStringChecker:
    """Streaming stop-string detection with partial-match holdback.

    Parity: reference SamplingParams.stop semantics (stop strings are not
    included in the output unless include_stop_str_in_output,
    server/openai/basic/sampling_params.py:72-78). Feed decoded text chunks;
    text that could still be a prefix of a stop string is held back until
    disambiguated.
    """

    def __init__(self, stops, include: bool = False):
        self.stops = [s for s in (stops or []) if s]
        self.include = include
        self.hold = max((len(s) for s in self.stops), default=0) - 1
        self.buf = ""
        self.stopped = False

    @property
    def active(self) -> bool:
        return bool(self.stops)

    def put(self, text: str) -> Tuple[str, bool]:
        """Returns (releasable_text, stopped)."""
        if not self.stops or self.stopped:
            return (text if not self.stopped else ""), self.stopped
        self.buf += text
        best = -1
        best_end = 0
        for s in self.stops:
            i = self.buf.find(s)
            if i >= 0 and (best < 0 or i < best):
                best = i
                best_end = i + len(s)
        if best >= 0:
            self.stopped = True
            out = self.buf[: best_end if self.include else best]
            self.buf = ""
            return out, True
        if self.hold > 0 and len(self.buf) > self.hold:
            out = self.buf[: -self.hold]
            self.buf = self.buf[-self.hold :]
            return out, False
        if self.hold == 0:
            out, self.buf = self.buf, ""
            return out, False
        return "", False

    def finish(self) -> str:
        out, self.buf = self.buf, ""
        return out


def truncate_at_stop(text: str, stops, include: bool = False) -> Tuple[str, bool]:
    """Non-streaming variant: truncate ``text`` at the earliest stop string."""
    best = -1
    best_end = 0
    for s in stops or ():
        if not s:
            continue
        i = text.find(s)
        if i >= 0 and (best < 0 or i < best):
            best = i
            best_end = i + len(s)
    if best < 0:
        return text, False
    return text[: best_end if include else best], True
