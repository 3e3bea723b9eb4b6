"""Top-level model entry point (counterpart of ``zhilight_tpu/llm.py``).

``LLM(model_config=..., params=..., engine_config=..., device=...)`` builds
the executor for in-memory weights; ``llm.generator()`` (or
``DynamicBatchGenerator(llm)``) serves requests on token ids. The device
defaults to the GPU and there is no silent move to the CPU: without a GPU,
``device`` must be given as ``"cpu"``. Loading an HF checkpoint directory
(``model_path``), the tokenizer, SmoothQuant calibration and the scoring
utilities (``calc_*``) are later slices of the port.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .config import EngineConfig, ModelConfig, QuantConfig, QuantType
from .engine.engine import ModelExecutor
from .engine.generator import DynamicBatchGenerator
from .utils.convert import params_to_torch

__all__ = ["LLM"]


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


class LLM:
    def __init__(
        self,
        model_path: str = "",
        engine_config: Optional[EngineConfig] = None,
        model_config: Optional[ModelConfig] = None,
        quant_config: Optional[QuantConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        tokenizer=None,
        device=None,
    ):
        if model_path:
            _not_ported("loading a checkpoint directory (model_path)")
        if model_config is None or params is None:
            raise ValueError("LLM needs model_config and params")
        if quant_config is not None and quant_config.quant_type != QuantType.NO_QUANT:
            _not_ported("quantized serving")
        if tokenizer is not None:
            _not_ported("tokenizer support")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LLM runs on the GPU by default and no CUDA device is available; "
                    "pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.engine_config = engine_config or EngineConfig()
        self.model_config = model_config
        self.quant_config = quant_config or QuantConfig()
        self.hf_config = {}
        self.tokenizer = None
        params = params_to_torch(params, self.device, model_config.torch_dtype)
        self.executor = ModelExecutor(model_config, params, self.engine_config, self.device)

    def generator(self) -> DynamicBatchGenerator:
        return DynamicBatchGenerator(self)

    def calc_logits(self, tokens):
        _not_ported("scoring (calc_logits)")

    def calc_hidden_states(self, tokens):
        _not_ported("hidden-state output (calc_hidden_states)")

    def calc_log_prob(self, tokens, labels=None):
        _not_ported("scoring (calc_log_prob)")

    def calc_loss(self, tokens, labels=None):
        _not_ported("scoring (calc_loss)")

    def calc_greedy_match(self, tokens, labels=None):
        _not_ported("scoring (calc_greedy_match)")

    @classmethod
    def load_with_smooth_quant(cls, *args, **kw):
        _not_ported("SmoothQuant calibration")
