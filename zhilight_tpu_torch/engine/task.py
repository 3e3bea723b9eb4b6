"""Request/task types and results.

Parity targets: reference ``SearchTask`` (src/generator/batch_generator.h:32-118),
``GeneratorArg`` / ``GenerativeOutput`` / ``RequestResult`` / ``StreamResult``
(zhilight/dynamic_batch.py:88-290) and ``SearchResult`` structs
(src/generator/generator.h:23-80).
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np

__all__ = [
    "GeneratorArg",
    "SearchTask",
    "GenerativeOutput",
    "RequestResult",
    "StreamResult",
    "StreamResultType",
    "TaskStatus",
]


class StreamResultType:
    Incremental = 1
    AllCurrent = 2
    Final = 3


@dataclass
class GeneratorArg:
    """Per-request generation/sampling arguments (reference GeneratorArg,
    zhilight/dynamic_batch.py:88-161)."""

    beam_size: int = 1
    max_length: int = 100
    repetition_penalty: float = 1.0
    ngram_penalty: float = 1.0
    seed: int = 0
    temperature: float = 1.0
    num_results: int = 1
    min_p: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    top_logprobs: int = 0
    logit_bias: Optional[Dict[int, float]] = None
    # stop conditions (reference SamplingParams.stop / stop_token_ids,
    # server/openai/basic/sampling_params.py:72-78)
    stop_token_ids: Optional[List[int]] = None
    stop_strings: Optional[List[str]] = None
    include_stop_str_in_output: bool = False
    # per-request EOS suppression (reference SamplingParams.ignore_eos,
    # server/openai/basic/sampling_params.py)
    ignore_eos: bool = False
    max_input_length: int = sys.maxsize
    # session support (reference set_session_info)
    session_id: Optional[str] = None
    session_continue: bool = False
    sess_chunk_pos: int = 0
    # return last-layer hidden states for prompt+output positions (reference
    # output_hidden_states, dynamic_batch.py:105-121): filled on the final
    # RequestResult as one [T, dim] array per output
    output_hidden_states: bool = False

    def __post_init__(self):
        if self.presence_penalty:
            self.repetition_penalty = 1.0
            self.ngram_penalty = 1.0
        if self.is_random and not self.seed:
            self.seed = 42

    @property
    def is_random(self) -> bool:
        return self.top_p < 1.0 or self.top_k > 0 or self.min_p > 0.0

    @property
    def sampling_temperature(self) -> float:
        """Temperature handed to the device sampler; 0 forces greedy."""
        if not self.is_random and self.temperature == 1.0:
            return 0.0  # plain beam_size=1 greedy search (reference default)
        return self.temperature


class TaskStatus:
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    # KV pages reclaimed under pressure; waiting to swap back in / recompute
    # (reference SwapBuf suspended state, batch_generator.cpp:329-358)
    PREEMPTED = "preempted"
    FINISHED = "finished"
    CANCELLED = "cancelled"
    FAILED = "failed"


class SearchTask:
    """One in-flight request (reference SearchTask_)."""

    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(
        self,
        input_tokens: List[int],
        arg: GeneratorArg,
        stream: bool = False,
        input_embeddings: Optional[np.ndarray] = None,
        position_ids: Optional[np.ndarray] = None,
    ):
        with SearchTask._counter_lock:
            SearchTask._counter += 1
            self.task_id = SearchTask._counter
        self.input_tokens = list(input_tokens[: arg.max_input_length])
        self.arg = arg
        self.stream = stream
        # multimodal: precomputed embeddings + custom positions
        # (reference SearchTask.input_embeddings / position_ids path)
        self.input_embeddings = input_embeddings
        self.position_ids = position_ids

        self.status = TaskStatus.QUEUED
        self.output_tokens: List[int] = []
        self.logprobs: List[float] = []
        self.top_logprobs: List[Dict[int, float]] = []
        self.cumulative_logprob = 0.0

        self.begin_ts = time.monotonic()
        self.first_token_ts: Optional[float] = None
        self.end_ts: Optional[float] = None

        self.res_queue: "queue.Queue" = queue.Queue()
        self._cancelled = threading.Event()
        # scheduler-visible cancel flag: set once per loop iteration from
        # _cancelled (rank 0) or the control-plane broadcast (workers), so
        # cancellation is applied at the same step on every host
        self.sched_cancelled = False
        self.error: Optional[BaseException] = None

        # scheduler state (owned by the scheduler thread)
        self.slot: int = -1
        self.pages: List[int] = []
        self.cache_len: int = 0  # tokens already in KV cache
        self.prefix_hit_len: int = 0
        self.finish_reason: str = ""  # "stop" | "length" | "abort"
        # preemption state: admission order (victim selection is newest-first),
        # swapped-out host KV, and whether a PREFILL pass is a decode-resume
        # recompute over prompt+generated tokens
        self.admit_seq: int = -1
        self.swap_state = None
        self.resume_decode = False
        # KV tokens reserved at admission (prompt + admission_reserve-scaled
        # max_length); the scheduler counts reserved-minus-allocated as
        # outstanding demand so admission at reserve=1.0 is truly worst-case
        self.reserved_tokens: int = 0

    # -- multi-host wire format (reference SearchTask boost-serialization,
    # src/generator/batch_generator.h:71-95) ------------------------------
    def to_wire(self) -> dict:
        import dataclasses

        return {
            "task_id": self.task_id,
            "input_tokens": self.input_tokens,
            "arg": dataclasses.asdict(self.arg),
            "input_embeddings": self.input_embeddings,
            "position_ids": self.position_ids,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "SearchTask":
        """Rebuild a rank-0 task on a worker. task_id is forced to rank 0's
        (it seeds per-slot sampling streams, so it must match everywhere);
        stream is off — worker results are never read."""
        t = cls(
            d["input_tokens"],
            GeneratorArg(**d["arg"]),
            stream=False,
            input_embeddings=d["input_embeddings"],
            position_ids=d["position_ids"],
        )
        t.task_id = d["task_id"]
        return t

    # -- lifecycle --------------------------------------------------------
    @property
    def prompt_len(self) -> int:
        return len(self.input_tokens)

    @property
    def total_len(self) -> int:
        return self.prompt_len + len(self.output_tokens)

    def cancel(self):
        self._cancelled.set()

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    # -- result plumbing --------------------------------------------------
    def emit_stream(self, new_tokens: List[int]):
        if self.stream:
            self.res_queue.put((StreamResultType.Incremental, list(new_tokens)))

    def finish(self):
        self.status = TaskStatus.FINISHED
        self.end_ts = time.monotonic()
        self.res_queue.put((StreamResultType.Final, self.to_output()))

    def finish_multi(self, outputs: List["GenerativeOutput"]):
        """Finish with multiple hypotheses (beam search / num_results > 1)."""
        self.status = TaskStatus.FINISHED
        self.end_ts = time.monotonic()
        self.res_queue.put((StreamResultType.Final, outputs))

    def fail(self, err: BaseException):
        self.status = TaskStatus.FAILED
        self.error = err
        self.res_queue.put((StreamResultType.Final, err))

    def to_output(self) -> "GenerativeOutput":
        first_delay = (
            (self.first_token_ts - self.begin_ts) if self.first_token_ts else 0.0
        )
        elapsed = (self.end_ts or time.monotonic()) - self.begin_ts
        return GenerativeOutput(
            token_ids=list(self.output_tokens),
            score=self.cumulative_logprob,
            time_elapsed=elapsed,
            first_token_delay=first_delay,
            logprobs=list(self.logprobs) or None,
            top_logprobs=list(self.top_logprobs) or None,
            finish_reason=self.finish_reason or "length",
        )


@dataclass
class GenerativeOutput:
    """One finished hypothesis (reference GenerativeOutput)."""

    token_ids: List[int]
    score: float
    time_elapsed: float
    first_token_delay: float = 0.0
    # per-token chosen logprob + top-k alternatives (reference
    # GenerativeOutput.top_logprobs / print_top_logprobs)
    logprobs: Optional[List[float]] = None
    top_logprobs: Optional[List[Dict[int, float]]] = None
    text: str = ""
    finish_reason: str = "length"

    def decode(self, tokenizer, prefix_input: Optional[str] = None):
        self.text = tokenizer.decode(self.token_ids)
        if prefix_input:
            self.text = prefix_input + self.text
        return self

    @property
    def output_tokens_num(self) -> int:
        return len(self.token_ids)

    def __repr__(self) -> str:
        otps = len(self.token_ids) / max(1e-3, self.time_elapsed - self.first_token_delay)
        return (
            f"GenerativeOutput(text={self.text!r}, TTFT={self.first_token_delay:.3f}, "
            f"TPOT={1.0 / max(otps, 1e-3):.3f}, OTPS={otps:.2f}, "
            f"score={self.score:.4f}, output_tokens_num={len(self.token_ids)})"
        )


@dataclass
class RequestResult:
    prompt: Union[str, List[int]]
    outputs: List[GenerativeOutput]
    input_tokens_num: int
    # per output: last-layer hidden states [prompt+output, dim] when the
    # request set output_hidden_states (reference RequestResult.hidden_states)
    hidden_states: Optional[List[np.ndarray]] = None

    def __repr__(self) -> str:
        return f"RequestResult(outputs={self.outputs}, input_tokens_num={self.input_tokens_num})"


@dataclass
class StreamResult:
    update_flag: int
    tokens: List[int]
    final_results: List[GenerativeOutput] = field(default_factory=list)
