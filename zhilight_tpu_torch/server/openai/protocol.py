"""OpenAI-compatible request/response models.

Parity: reference zhilight/server/openai/entrypoints/protocol.py (vLLM-derived
pydantic models) — chat/completions requests, streaming chunks, usage
accounting, logprobs. Trimmed to the fields the engine actually honors.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import BaseModel, Field

__all__ = [
    "ChatMessage",
    "ChatCompletionRequest",
    "CompletionRequest",
    "ChatCompletionResponse",
    "CompletionResponse",
    "UsageInfo",
    "ModelCard",
    "ModelList",
    "ErrorResponse",
    "EmbeddingRequest",
    "EmbeddingData",
    "EmbeddingResponse",
]


def random_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


class ErrorResponse(BaseModel):
    object: str = "error"
    message: str
    type: str = "invalid_request_error"
    code: int = 400


class ModelCard(BaseModel):
    id: str
    object: str = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "zhilight-tpu"


class ModelList(BaseModel):
    object: str = "list"
    data: List[ModelCard] = []


class UsageInfo(BaseModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class EmbeddingRequest(BaseModel):
    model: Optional[str] = None
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: str = "float"


class EmbeddingData(BaseModel):
    object: str = "embedding"
    index: int
    embedding: List[float]


class EmbeddingResponse(BaseModel):
    object: str = "list"
    model: str = ""
    data: List[EmbeddingData] = []
    usage: UsageInfo = UsageInfo()


class ChatMessage(BaseModel):
    role: str
    content: Optional[str] = None
    reasoning_content: Optional[str] = None


class _SamplingFields(BaseModel):
    max_tokens: Optional[int] = None
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    n: int = 1
    best_of: Optional[int] = None
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    logit_bias: Optional[Dict[str, float]] = None
    logprobs: Optional[Union[bool, int]] = None
    top_logprobs: Optional[int] = None
    stream: bool = False
    ignore_eos: bool = False
    user: Optional[str] = None


class ChatCompletionRequest(_SamplingFields):
    model: str = ""
    messages: List[ChatMessage]
    chat_template: Optional[str] = None


class CompletionRequest(_SamplingFields):
    model: str = ""
    prompt: Union[str, List[str], List[int], List[List[int]]]
    echo: bool = False


class LogProbEntry(BaseModel):
    token: str
    logprob: float
    bytes: Optional[List[int]] = None
    top_logprobs: List[Dict[str, Any]] = []


class ChoiceLogProbs(BaseModel):
    content: Optional[List[LogProbEntry]] = None


class ChatCompletionChoice(BaseModel):
    index: int
    message: ChatMessage
    logprobs: Optional[ChoiceLogProbs] = None
    finish_reason: Optional[str] = None


class ChatCompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: random_id("chatcmpl"))
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionChoice] = []
    usage: UsageInfo = Field(default_factory=UsageInfo)


class DeltaMessage(BaseModel):
    role: Optional[str] = None
    content: Optional[str] = None
    reasoning_content: Optional[str] = None


class ChatCompletionStreamChoice(BaseModel):
    index: int
    delta: DeltaMessage
    logprobs: Optional[ChoiceLogProbs] = None
    finish_reason: Optional[str] = None


class ChatCompletionStreamResponse(BaseModel):
    id: str = Field(default_factory=lambda: random_id("chatcmpl"))
    object: str = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[ChatCompletionStreamChoice] = []
    usage: Optional[UsageInfo] = None


class CompletionChoice(BaseModel):
    index: int
    text: str
    logprobs: Optional[ChoiceLogProbs] = None
    finish_reason: Optional[str] = None


class CompletionResponse(BaseModel):
    id: str = Field(default_factory=lambda: random_id("cmpl"))
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = []
    usage: UsageInfo = Field(default_factory=UsageInfo)
