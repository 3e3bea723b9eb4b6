"""Reasoning-section parser for DeepSeek-R1-style ``<think>`` output.

Parity: reference zhilight/server/openai/entrypoints/reasoning_parser.py:10-138
— split streamed text into reasoning_content (inside <think>...</think>) and
content (after), robust to the tags spanning chunk boundaries.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["ReasoningParser"]

THINK_START = "<think>"
THINK_END = "</think>"


class ReasoningParser:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._in_reasoning: Optional[bool] = None  # unknown until first text
        self._buffer = ""

    def feed(self, text: str) -> Tuple[str, str]:
        """Returns (reasoning_delta, content_delta)."""
        if not self.enabled:
            return "", text
        self._buffer += text
        reasoning, content = "", ""
        while self._buffer:
            if self._in_reasoning is None:
                stripped = self._buffer.lstrip()
                if not stripped:
                    break
                if THINK_START.startswith(stripped[: len(THINK_START)]) and len(
                    stripped
                ) < len(THINK_START):
                    break  # possible partial "<think" — wait for more
                if stripped.startswith(THINK_START):
                    self._in_reasoning = True
                    self._buffer = stripped[len(THINK_START) :]
                    continue
                self._in_reasoning = False
                continue
            if self._in_reasoning:
                idx = self._buffer.find(THINK_END)
                if idx >= 0:
                    reasoning += self._buffer[:idx]
                    self._buffer = self._buffer[idx + len(THINK_END) :]
                    self._in_reasoning = False
                    continue
                # hold back a potential partial end tag
                safe = len(self._buffer)
                for k in range(1, len(THINK_END)):
                    if self._buffer.endswith(THINK_END[:k]):
                        safe = len(self._buffer) - k
                        break
                reasoning += self._buffer[:safe]
                self._buffer = self._buffer[safe:]
                break
            else:
                content += self._buffer
                self._buffer = ""
        return reasoning, content

    def flush(self) -> Tuple[str, str]:
        buf, self._buffer = self._buffer, ""
        if self._in_reasoning:
            return buf, ""
        return "", buf
