"""Incremental multi-turn sessions (counterpart of
``zhilight_tpu/engine/session.py``).

The client keeps the full token history; the scheduler pins the session's KV
pages between turns, keyed by ``session_id``, so each turn prefills only the
new chunk (its ``cache_len`` picks up where the last turn ended). Chunks can
be fed without generating, and speculative tokens rolled back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

from .task import GeneratorArg, RequestResult

__all__ = ["SessionGenerator"]


class SessionGenerator:
    def __init__(self, generator, session_id: Optional[str] = None):
        """``generator`` is a started DynamicBatchGenerator."""
        self._gen = generator
        self.session_id = session_id or f"sess_{time.time():.3f}"
        self._history: List[int] = []
        self._first = True

    @property
    def context_len(self) -> int:
        return len(self._history)

    def feed(self, input_ids: Sequence[int]) -> RequestResult:
        """Encode a chunk into the session's KV without keeping a generated
        token (``max_length=1`` stands for encode-only)."""
        return self.generate(input_ids, GeneratorArg(max_length=1), _keep_output=False)

    def generate(
        self,
        input_ids: Sequence[int],
        arg: Optional[GeneratorArg] = None,
        _keep_output: bool = True,
    ) -> RequestResult:
        new = [int(t) for t in input_ids]
        # valid KV for this turn = the history before the new chunk (rolled
        # back tokens are already gone from it)
        arg = dataclasses.replace(
            arg or GeneratorArg(),
            session_id=self.session_id,
            session_continue=not self._first,
            sess_chunk_pos=0 if self._first else len(self._history),
        )
        self._history.extend(new)
        res = self._gen.generate(list(self._history), arg)
        self._first = False
        if _keep_output and res.outputs:
            self._history.extend(res.outputs[0].token_ids)
        return res

    def rollback_speculative(self, num_tokens: int):
        """Drop the last ``num_tokens`` tokens from the session's context."""
        if num_tokens > len(self._history):
            raise ValueError(f"cannot roll back {num_tokens} of {len(self._history)} tokens")
        del self._history[len(self._history) - num_tokens :]

    def close(self):
        self._gen.scheduler.close_session(self.session_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
