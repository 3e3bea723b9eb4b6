from .task import (
    GeneratorArg,
    GenerativeOutput,
    RequestResult,
    SearchTask,
    StreamResult,
    StreamResultType,
    TaskStatus,
)
from .engine import ModelExecutor
from .scheduler import Scheduler
from .generator import DynamicBatchGenerator
from .detokenizer import IncrementalDetokenizer

__all__ = [
    "GeneratorArg",
    "GenerativeOutput",
    "RequestResult",
    "SearchTask",
    "StreamResult",
    "StreamResultType",
    "TaskStatus",
    "ModelExecutor",
    "Scheduler",
    "DynamicBatchGenerator",
    "IncrementalDetokenizer",
]
