"""Top-level model entry point (counterpart of ``zhilight_tpu/llm.py``).

``LLM(model_path=...)`` reads an HF checkpoint directory (``config.json``,
``generation_config.json``, safetensors or torch ``.bin`` weights: dense,
GPTQ/AWQ int4, or FP8, which is dequantized at load unless ``ZT_FP8_KEEP=1``
keeps it for the FP8 kernel); ``LLM(model_config=..., params=..., quant_config=...)``
takes in-memory weights. ``QuantType.AUTO_INT8`` quantizes a raw checkpoint to
W8A8 int8 at load, and ``LLM.load_with_smooth_quant`` calibrates it first.
``llm.generator()`` (or ``DynamicBatchGenerator(llm)``) serves requests on
token ids. The device defaults to the GPU and there is no
silent move to the CPU: without a GPU, ``device`` must be given as ``"cpu"``.
The scoring utilities (``calc_logits``, ``calc_hidden_states``,
``calc_log_prob``, ``calc_loss``, ``calc_greedy_match``) take token ids. The
tokenizer (string input) is a later slice of the port.
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
            if self.quant_config.quant_type == QuantType.AUTO_INT8:
                # quantize the raw fp16/bf16 weights to W8A8 at load; the
                # calibrated SmoothQuant variant is LLM.load_with_smooth_quant
                from .utils.quant_convert import quantize_int8_params

                params = quantize_int8_params(params, alpha=self.quant_config.smooth_alpha)
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
    # SmoothQuant calibration
    # ------------------------------------------------------------------
    def calc_act_scales(self, prompts, calib_len: int = 512) -> Dict[str, np.ndarray]:
        """Run calibration prompts (token ids) through the model and return
        the per-channel activation |max| of every quantized linear's input
        (parameter path -> [in] float32). Each prompt is tiled or truncated
        to ``calib_len`` tokens."""
        from .utils.calibrate import calc_act_scales as _calc

        batches = []
        for p in prompts:
            ids = self._encode_ids(p)
            if len(ids) == 0:
                continue
            reps = -(-calib_len // len(ids))
            batches.append(np.tile(ids, reps)[:calib_len])
        if not batches:
            raise ValueError("no non-empty calibration prompts")
        return _calc(self.executor.params, self.model_config, self.executor.rope, batches)

    @classmethod
    def load_with_smooth_quant(
        cls,
        model_path: str,
        calibration_prompts,
        engine_config: Optional[EngineConfig] = None,
        alpha: float = 0.5,
        calib_len: int = 512,
        **kw,
    ) -> "LLM":
        """The SmoothQuant flow from a raw fp16/bf16 checkpoint: load it,
        calibrate the activation scales on ``calibration_prompts`` (token
        ids), migrate the outliers into the weights (``alpha``) and serve
        W8A8 int8 on the same device."""
        from .utils.quant_convert import quantize_int8_params

        base = cls(model_path=model_path, engine_config=engine_config, **kw)
        scales = base.calc_act_scales(calibration_prompts, calib_len=calib_len)
        params, device = base.executor.params, base.device
        mc, ec = base.model_config, base.engine_config
        base.executor = None  # release the KV pool before the rebuild
        del base
        return cls(model_config=mc, engine_config=ec, device=device,
                   params=quantize_int8_params(params, scales, alpha))

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
