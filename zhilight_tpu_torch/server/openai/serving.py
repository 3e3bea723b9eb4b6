"""Async serving glue: OpenAI requests → scheduler tasks → (streamed) responses.

Parity: reference AsyncLLMEngine (engine/async_llm_engine.py:48-323) +
OpenAIServingChat/Completion (entrypoints/serving_chat.py / serving_completion.py):
request validation, chat-template tokenization, SamplingParams→GeneratorArg
mapping (engine/llm_engine.py:67-112), per-request async streams fed by an
executor thread polling the task's result queue, abort on disconnect.
"""

from __future__ import annotations

import asyncio
import logging
import queue as _queue
import time
from typing import AsyncGenerator, List, Optional, Tuple, Union

from ...engine.detokenizer import IncrementalDetokenizer, StopStringChecker
from ...engine.task import GeneratorArg, SearchTask, StreamResultType
from .protocol import (
    ChatCompletionRequest,
    CompletionRequest,
)
from .reasoning import ReasoningParser

logger = logging.getLogger(__name__)

__all__ = ["AsyncEngine", "arg_from_request"]


def arg_from_request(req: Union[ChatCompletionRequest, CompletionRequest], max_model_len: int) -> GeneratorArg:
    max_tokens = req.max_tokens or (max_model_len // 2)
    top_logprobs = 0
    if req.logprobs:
        top_logprobs = req.top_logprobs or (req.logprobs if isinstance(req.logprobs, int) else 1)
    logit_bias = None
    if req.logit_bias:
        logit_bias = {int(k): float(v) for k, v in req.logit_bias.items()}
    stop_strings = None
    if req.stop:
        stop_strings = [req.stop] if isinstance(req.stop, str) else list(req.stop)
    return GeneratorArg(
        max_length=max_tokens,
        temperature=req.temperature,
        top_p=req.top_p,
        top_k=req.top_k,
        min_p=req.min_p,
        presence_penalty=req.presence_penalty,
        frequency_penalty=req.frequency_penalty,
        repetition_penalty=req.repetition_penalty,
        seed=req.seed or 0,
        top_logprobs=top_logprobs,
        logit_bias=logit_bias,
        stop_token_ids=list(req.stop_token_ids) if req.stop_token_ids else None,
        stop_strings=stop_strings,
        ignore_eos=req.ignore_eos,
    )


class AsyncEngine:
    """Bridges the blocking scheduler to asyncio."""

    def __init__(self, llm, generator):
        if llm.tokenizer is None and getattr(llm, "tokenizer_error", None) is not None:
            raise llm.tokenizer_error  # its tokenizer files did not load
        self.llm = llm
        self.gen = generator  # DynamicBatchGenerator (started)
        self.tokenizer = llm.tokenizer
        self.max_model_len = llm.engine_config.max_model_len
        self.dead = False

    # -- encoding ------------------------------------------------------
    def encode_chat(self, req: ChatCompletionRequest) -> List[int]:
        messages = [m.model_dump(exclude_none=True) for m in req.messages]
        kwargs = {}
        if req.chat_template:
            kwargs["chat_template"] = req.chat_template
        return list(
            self.tokenizer.apply_chat_template(
                messages, tokenize=True, add_generation_prompt=True, **kwargs
            )
        )

    def encode_prompt(self, prompt) -> List[int]:
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return list(prompt)
        return list(self.tokenizer.encode(prompt))

    # -- generation ----------------------------------------------------
    async def generate_stream(
        self, tokens: List[int], arg: GeneratorArg
    ) -> AsyncGenerator[Tuple[str, Optional[object]], None]:
        """Yields ("delta text", None) chunks then ("", GenerativeOutput)."""
        loop = asyncio.get_running_loop()
        task = SearchTask(tokens, arg, stream=True)
        detok = IncrementalDetokenizer(self.tokenizer)
        stopper = StopStringChecker(arg.stop_strings, arg.include_stop_str_in_output)
        released = ""
        first_sent = False
        self.gen.scheduler.submit(task)
        try:
            while True:
                flag, payload = await loop.run_in_executor(None, self._poll, task)
                if flag is None:
                    continue
                if flag == StreamResultType.Incremental:
                    text = detok.put(payload)
                    if stopper.active:
                        text, hit = stopper.put(text)
                        if hit:
                            task.finish_reason = "stop"
                            task.cancel()
                    if text:
                        released += text
                        first_sent = True
                        yield text, None
                    elif not first_sent:
                        # the detokenizer may hold back an incomplete UTF-8
                        # sequence; still signal the first generated token so
                        # client-side TTFT (first SSE chunk) stays meaningful
                        first_sent = True
                        yield "", None
                elif flag == StreamResultType.Final:
                    if isinstance(payload, BaseException):
                        raise payload
                    tail = detok.finish()
                    if stopper.active:
                        if not stopper.stopped:
                            t2, hit = stopper.put(tail)
                            tail = t2 + ("" if hit else stopper.finish())
                            if hit:
                                payload.finish_reason = "stop"
                        else:
                            tail = ""
                    if tail:
                        released += tail
                        yield tail, None
                    payload.decode(self.tokenizer)
                    if stopper.active:
                        # decoded full text may run past the stop string
                        payload.text = released
                    yield "", payload
                    return
        finally:
            if task.status not in ("finished", "failed"):
                task.cancel()

    @staticmethod
    def _poll(task: SearchTask):
        try:
            return task.res_queue.get(timeout=0.5)
        except _queue.Empty:
            return None, None

    async def generate(self, tokens: List[int], arg: GeneratorArg):
        final = None
        async for _, out in self.generate_stream(tokens, arg):
            if out is not None:
                final = out
        return final

    def stats(self):
        sched = self.gen.scheduler
        return {
            "running": sched.active_size,
            "waiting": sched.queue_size(),
            "preemptions": sched.num_preemptions,
        }
