"""User-facing generation API.

Parity: reference ``DynamicBatchGenerator`` (zhilight/dynamic_batch.py:382-639)
— generate / batch_generate / stream_generate over the continuous-batching
scheduler, chat-template encoding, streaming incremental detokenization — and
``SessionGenerator`` semantics (zhilight/session_generator.py) via the prefix
cache.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Generator, Iterable, List, Optional, Sequence, Union

import numpy as np

from .detokenizer import IncrementalDetokenizer, StopStringChecker, truncate_at_stop
from .scheduler import Scheduler
from .task import (
    GeneratorArg,
    GenerativeOutput,
    RequestResult,
    SearchTask,
    StreamResultType,
)

logger = logging.getLogger(__name__)

__all__ = ["DynamicBatchGenerator"]

Prompt = Union[str, List[int], List[dict]]


class DynamicBatchGenerator:
    def __init__(self, model, scheduler: Optional[Scheduler] = None):
        """``model`` is an :class:`zhilight_tpu_torch.llm.LLM` (or anything exposing
        ``.executor`` and ``.tokenizer``)."""
        self.model = model
        self.tokenizer = getattr(model, "tokenizer", None)
        self.scheduler = scheduler or Scheduler(model.executor)
        self._started = False

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if not self._started:
            self.scheduler.start()
            self._started = True
        return self

    def stop(self):
        if self._started:
            self.scheduler.stop()
            self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- encoding ---------------------------------------------------------
    def _encode(self, prompt: Prompt) -> List[int]:
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], (int, np.integer)):
            return [int(t) for t in prompt]
        if self.tokenizer is None:
            # an LLM whose tokenizer files could not load says why
            raise getattr(self.model, "tokenizer_error", None) or ValueError(
                "no tokenizer available; pass token ids")
        if isinstance(prompt, list):  # chat messages
            return list(
                self.tokenizer.apply_chat_template(
                    prompt, tokenize=True, add_generation_prompt=True
                )
            )
        return list(self.tokenizer.encode(prompt))

    # -- blocking single request ------------------------------------------
    def generate(
        self,
        prompt: Prompt,
        arg: Optional[GeneratorArg] = None,
        timeout: Optional[float] = None,
        input_embeddings: Optional[np.ndarray] = None,  # [T, dim] multimodal
        position_ids: Optional[np.ndarray] = None,
    ) -> RequestResult:
        arg = arg or GeneratorArg()
        tokens = self._encode(prompt)
        task = SearchTask(
            tokens, arg, input_embeddings=input_embeddings, position_ids=position_ids
        )
        self.scheduler.submit(task)
        flag, payload = self._wait_final(task, timeout)
        if isinstance(payload, BaseException):
            raise payload
        outs = payload if isinstance(payload, list) else [payload]
        if self.tokenizer is not None:
            for out in outs:
                out.decode(self.tokenizer)
                self._apply_stop_strings(out, arg)
        hs = None
        if arg.output_hidden_states:
            if input_embeddings is not None or arg.session_continue:
                raise ValueError(
                    "output_hidden_states is unsupported with input_embeddings "
                    "or session continuation (the recompute pass cannot see "
                    "injected embeddings / prior-turn KV)"
                )
            # exact recompute through the scoring path (one prefill-shaped
            # pass per output) — keeps hidden-state plumbing out of the
            # decode hot loop; reference fills them inside the decode step
            # (fill_last_hidden_states), same values
            hs = [
                self.model.executor.run_hidden(
                    np.asarray(tokens + list(out.token_ids), np.int32)
                )
                for out in outs
            ]
        return RequestResult(
            prompt=prompt, outputs=outs, input_tokens_num=len(tokens),
            hidden_states=hs,
        )

    @staticmethod
    def _apply_stop_strings(out: GenerativeOutput, arg: GeneratorArg):
        if arg.stop_strings and out.text:
            text, hit = truncate_at_stop(
                out.text, arg.stop_strings, arg.include_stop_str_in_output
            )
            if hit:
                out.text = text
                out.finish_reason = "stop"

    def _wait_final(self, task: SearchTask, timeout: Optional[float]):
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            remain = (deadline - time.monotonic()) if deadline else None
            if remain is not None and remain <= 0:
                task.cancel()
                raise TimeoutError("generation timed out")
            try:
                flag, payload = task.res_queue.get(timeout=remain if remain else 1.0)
            except queue.Empty:
                continue
            if flag == StreamResultType.Final:
                return flag, payload

    # -- batch -------------------------------------------------------------
    def batch_generate(
        self,
        prompts: Sequence[Prompt],
        arg: Union[GeneratorArg, Sequence[GeneratorArg], None] = None,
        timeout: Optional[float] = None,
    ) -> List[RequestResult]:
        args: List[GeneratorArg]
        if arg is None:
            args = [GeneratorArg() for _ in prompts]
        elif isinstance(arg, GeneratorArg):
            args = [arg for _ in prompts]
        else:
            args = list(arg)
        tasks = []
        for p, a in zip(prompts, args):
            t = SearchTask(self._encode(p), a)
            tasks.append((p, t))
        # submit sorted by length (reference sort_by_len) for better packing
        for _, t in sorted(tasks, key=lambda x: x[1].prompt_len):
            self.scheduler.submit(t)
        results = []
        for p, t in tasks:
            _, payload = self._wait_final(t, timeout)
            if isinstance(payload, BaseException):
                raise payload
            outs = payload if isinstance(payload, list) else [payload]
            if self.tokenizer is not None:
                for out in outs:
                    out.decode(self.tokenizer)
                    self._apply_stop_strings(out, t.arg)
            hs = None
            if t.arg.output_hidden_states:
                hs = [
                    self.model.executor.run_hidden(
                        np.asarray(t.input_tokens + list(out.token_ids), np.int32)
                    )
                    for out in outs
                ]
            results.append(
                RequestResult(
                    prompt=p, outputs=outs, input_tokens_num=t.prompt_len,
                    hidden_states=hs,
                )
            )
        return results

    # -- streaming ---------------------------------------------------------
    def stream_generate(
        self,
        prompt: Prompt,
        arg: Optional[GeneratorArg] = None,
        timeout: Optional[float] = None,
    ) -> Generator[dict, None, None]:
        """Yields dicts: {"text": incremental_text, "tokens": [...], "finished": bool,
        "output": GenerativeOutput (final only)}."""
        arg = arg or GeneratorArg()
        tokens = self._encode(prompt)
        task = SearchTask(tokens, arg, stream=True)
        detok = (
            IncrementalDetokenizer(self.tokenizer) if self.tokenizer is not None else None
        )
        self.scheduler.submit(task)
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            remain = (deadline - time.monotonic()) if deadline else None
            if remain is not None and remain <= 0:
                task.cancel()
                raise TimeoutError("generation timed out")
            try:
                flag, payload = task.res_queue.get(timeout=remain if remain else 1.0)
            except queue.Empty:
                continue
            if flag == StreamResultType.Incremental:
                text = detok.put(payload) if detok else ""
                yield {"text": text, "tokens": payload, "finished": False}
            elif flag == StreamResultType.Final:
                if isinstance(payload, BaseException):
                    raise payload
                text = detok.finish() if detok else ""
                if self.tokenizer is not None:
                    payload.decode(self.tokenizer)
                yield {"text": text, "tokens": [], "finished": True, "output": payload}
                return
