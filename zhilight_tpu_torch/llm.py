"""Top-level model entry point (counterpart of ``zhilight_tpu/llm.py``).

``LLM(model_path=...)`` reads an HF checkpoint directory (``config.json``,
``generation_config.json``, safetensors or torch ``.bin`` weights, dense or
GPTQ/AWQ int4); ``LLM(model_config=..., params=..., quant_config=...)``
takes in-memory weights. ``llm.generator()`` (or ``DynamicBatchGenerator(llm)``)
serves requests on token ids. The device defaults to the GPU and there is no
silent move to the CPU: without a GPU, ``device`` must be given as ``"cpu"``.
The scoring utilities (``calc_logits``, ``calc_hidden_states``,
``calc_log_prob``, ``calc_loss``, ``calc_greedy_match``) take token ids. The
tokenizer (string input), W8A8/FP8 weights and SmoothQuant calibration are
later slices of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from .config import EngineConfig, ModelConfig, QuantConfig, QuantType, load_model_config
from .engine.engine import ModelExecutor
from .engine.generator import DynamicBatchGenerator
from .utils.convert import params_to_torch
from .utils.hf_loader import load_hf_state

__all__ = ["LLM"]

_PORTED_QUANT = (QuantType.NO_QUANT, QuantType.GPTQ, QuantType.AWQ)


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet")


def _load_generation_eos(model_path: str) -> list:
    """EOS id(s) from HF generation_config.json (int or list)."""
    path = os.path.join(model_path, "generation_config.json")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        raw = json.load(f).get("eos_token_id")
    if raw is None:
        return []
    return [int(x) for x in (raw if isinstance(raw, list) else [raw])]


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
        if tokenizer is not None:
            _not_ported("tokenizer support")
        self.engine_config = engine_config or EngineConfig(model_path=model_path)
        self.hf_config = {}
        if model_path:
            cfg, qcfg, self.hf_config = load_model_config(model_path)
            model_config = model_config or cfg
            quant_config = quant_config or qcfg
        if model_config is None or (params is None and not model_path):
            raise ValueError("LLM needs model_path, or model_config and params")
        self.model_config = model_config
        self.quant_config = quant_config or QuantConfig()
        if self.quant_config.quant_type not in _PORTED_QUANT:
            _not_ported(f"{self.quant_config.quant_type.name} weights")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "LLM runs on the GPU by default and no CUDA device is available; "
                    "pass device='cpu' to run on the CPU"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.tokenizer = None

        if params is None:
            params = load_hf_state(
                model_path, model_config, quant=self.quant_config, device=self.device
            )
        eos_ids = _load_generation_eos(model_path) if model_path else []
        if eos_ids:
            sched = self.engine_config.scheduler
            self.engine_config = dataclasses.replace(
                self.engine_config,
                scheduler=dataclasses.replace(sched, eos_id=eos_ids[0], eos_ids=tuple(eos_ids)),
            )
        params = params_to_torch(params, self.device, model_config.torch_dtype)
        self.executor = ModelExecutor(model_config, params, self.engine_config, self.device)

    def generator(self) -> DynamicBatchGenerator:
        return DynamicBatchGenerator(self)

    # ------------------------------------------------------------------
    # scoring utilities, on token ids
    # ------------------------------------------------------------------
    def _encode_ids(self, tokens) -> np.ndarray:
        if isinstance(tokens, str):
            _not_ported("string input (tokenizer support)")
        return np.asarray(list(tokens), dtype=np.int32)

    def calc_logits(self, tokens) -> np.ndarray:
        """Per-position vocab logits [T, V] (fp32 numpy)."""
        return self.executor.run_score(self._encode_ids(tokens))

    def calc_hidden_states(self, tokens) -> np.ndarray:
        """Per-position last-layer hidden states [T, d] after the final norm."""
        return self.executor.run_hidden(self._encode_ids(tokens))

    def _logits_and_labels(self, tokens, labels):
        """The logit rows that score ``labels``: by default position i scores
        the next token, tokens[i + 1]."""
        ids = self._encode_ids(tokens)
        logits = self.executor.run_score(ids)
        if labels is None:
            return logits[:-1], ids[1:]
        lab = np.asarray(list(labels), dtype=np.int32)
        return logits[: len(lab)], lab

    def calc_log_prob(self, tokens, labels=None):
        """(total, per-position list) of log p(labels[i] | tokens[: i + 1])."""
        rows, lab = self._logits_and_labels(tokens, labels)
        top = rows.max(-1, keepdims=True)
        logp = rows - top - np.log(np.sum(np.exp(rows - top), -1, keepdims=True))
        per = logp[np.arange(len(lab)), lab]
        return float(per.sum()), per.tolist()

    def calc_loss(self, tokens, labels=None) -> float:
        """Mean cross-entropy of the labels (next tokens by default)."""
        total, per = self.calc_log_prob(tokens, labels)
        return float(-total / max(len(per), 1))

    def calc_greedy_match(self, tokens, labels=None) -> int:
        """Number of positions whose argmax logit is the label."""
        rows, lab = self._logits_and_labels(tokens, labels)
        return int(np.sum(np.argmax(rows, axis=-1) == lab))

    @classmethod
    def load_with_smooth_quant(cls, *args, **kw):
        _not_ported("SmoothQuant calibration")
