"""Top-level model entry point (counterpart of ``zhilight_tpu/llm.py``).

``LLM(model_path=...)`` reads an HF checkpoint directory (``config.json``,
``generation_config.json``, safetensors or torch ``.bin`` weights: dense,
GPTQ/AWQ int4, or FP8, which is dequantized at load unless ``ZT_FP8_KEEP=1``
keeps it for the FP8 kernel) and, where the directory holds tokenizer files,
its tokenizer (``transformers.AutoTokenizer``); ``LLM(model_config=...,
params=..., quant_config=..., tokenizer=...)`` takes in-memory weights and
any tokenizer with ``encode``, ``decode`` and ``apply_chat_template``.
``QuantType.AUTO_INT8`` quantizes a raw checkpoint to W8A8 int8 at load, and
``LLM.load_with_smooth_quant`` calibrates it first. ``llm.generator()`` (or
``DynamicBatchGenerator(llm)``) serves requests on token ids, strings or chat
messages. The device defaults to the GPU and there is no silent move to the
CPU: without a GPU, ``device`` must be given as ``"cpu"``. The scoring
utilities (``calc_logits``, ``calc_hidden_states``, ``calc_log_prob``,
``calc_loss``, ``calc_greedy_match``) take token ids or a string.

A directory without tokenizer files leaves ``tokenizer`` at None (string
input then raises ``ValueError``). With tokenizer files but no
``transformers`` installed, ``tokenizer`` stays None and ``tokenizer_error``
holds the ImportError that string input and the server's start raise, so
token ids still serve; any other failure to load the tokenizer propagates.

Tensor parallelism (``engine_config=EngineConfig(parallel=ParallelConfig(
tp=N))``, dense models in bf16, fp16 or fp32) follows torchrun's convention:
every rank runs the same program and builds the same ``LLM``, which joins
the default ``torch.distributed`` group (the caller's, or one initialised
from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL on
the GPU, gloo on the CPU), whose world must be N, and keeps its rank's shard
of ``params`` or of the checkpoint. The device defaults to
``cuda:LOCAL_RANK``; one device given to every rank is allowed (two ranks on
one GPU over a gloo group). Rank 0 takes the requests; the other ranks run
the scheduler loop in lockstep (``gen.scheduler._thread.join()``) until rank
0's generator stops. Scoring and calibration raise under N > 1.
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
from .parallel.comm import join, local_device
from .parallel.sharding import check_tp, is_shard, shard_params
from .utils.convert import params_to_torch
from .utils.hf_loader import load_hf_state

__all__ = ["LLM"]


# the files a tokenizer loads from: a directory holding none of them has no tokenizer
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "tokenizer.model", "vocab.json",
                   "vocab.txt", "spiece.model", "sentencepiece.bpe.model")


def _load_tokenizer(model_path: str):
    """(tokenizer, error): the directory's tokenizer, or None and the
    ImportError to raise on string input when ``transformers`` is missing."""
    if not any(os.path.exists(os.path.join(model_path, f)) for f in _TOKENIZER_FILES):
        return None, None
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        return None, ImportError(
            f"{model_path} holds a tokenizer, and loading it needs the 'transformers' "
            f"package, which does not import ({e}); pass token ids, or a tokenizer")
    return AutoTokenizer.from_pretrained(model_path, trust_remote_code=True), None


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
        tp = self.engine_config.parallel.tp
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "LLM runs on the GPU by default and no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        self.tp_group = None
        if tp > 1:
            # one process a rank (torchrun's convention): every rank builds
            # the same LLM and keeps its shard of the weights
            check_tp(model_config, tp)
            device = local_device(device)
            self.tp_group = join(tp, device)
            if device.type == "cuda":
                torch.cuda.set_device(device)
        self.device = torch.device(device if device is not None else "cuda")
        shard = (self.tp_group.rank, tp) if self.tp_group is not None else None
        self.tokenizer, self.tokenizer_error = tokenizer, None
        if model_path and tokenizer is None:
            self.tokenizer, self.tokenizer_error = _load_tokenizer(model_path)

        if params is None:
            params = load_hf_state(
                model_path, model_config, quant=self.quant_config, device=self.device,
                shard=shard,
            )
            if self.quant_config.quant_type == QuantType.AUTO_INT8:
                # quantize the raw fp16/bf16 weights to W8A8 at load (a rank's
                # shard with the whole weight's column scales); the calibrated
                # SmoothQuant variant is LLM.load_with_smooth_quant
                from .utils.quant_convert import quantize_int8_params

                params = quantize_int8_params(params, alpha=self.quant_config.smooth_alpha,
                                              tp=self.tp_group)
        # the EOS set: the tokenizer's eos first, then generation_config.json's
        # ids (e.g. Llama-3's [eos, eot_id]); any member stops generation
        eos_ids: list = []
        if getattr(self.tokenizer, "eos_token_id", None) is not None:
            eos_ids.append(int(self.tokenizer.eos_token_id))
        for gen_eos in (_load_generation_eos(model_path) if model_path else []):
            if gen_eos not in eos_ids:
                eos_ids.append(gen_eos)
        if eos_ids:
            sched = self.engine_config.scheduler
            self.engine_config = dataclasses.replace(
                self.engine_config,
                scheduler=dataclasses.replace(sched, eos_id=eos_ids[0], eos_ids=tuple(eos_ids)),
            )
        if shard is not None and not is_shard(params, model_config, tp):
            # the full tree (a rank's shard, from init_params(shard=...) or
            # the loader, is taken as it is)
            params = shard_params(params, *shard, cfg=model_config)
        params = params_to_torch(params, self.device, model_config.torch_dtype)
        self.executor = ModelExecutor(model_config, params, self.engine_config, self.device,
                                      tp=self.tp_group)

    def generator(self) -> DynamicBatchGenerator:
        return DynamicBatchGenerator(self)

    # ------------------------------------------------------------------
    # SmoothQuant calibration
    # ------------------------------------------------------------------
    def calc_act_scales(self, prompts, calib_len: int = 512) -> Dict[str, np.ndarray]:
        """Run calibration prompts (token ids or strings) through the model and return
        the per-channel activation |max| of every quantized linear's input
        (parameter path -> [in] float32). Each prompt is tiled or truncated
        to ``calib_len`` tokens."""
        self._single_rank("calc_act_scales")
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
        ids or strings), migrate the outliers into the weights (``alpha``) and serve
        W8A8 int8 on the same device."""
        from .utils.quant_convert import quantize_int8_params

        if engine_config is not None and engine_config.parallel.tp > 1:
            raise NotImplementedError("load_with_smooth_quant under tensor parallelism is not "
                                      "ported yet (ROADMAP, queue 1)")
        base = cls(model_path=model_path, engine_config=engine_config, **kw)
        scales = base.calc_act_scales(calibration_prompts, calib_len=calib_len)
        params, device = base.executor.params, base.device
        mc, ec, tok, tok_err = (base.model_config, base.engine_config, base.tokenizer,
                                base.tokenizer_error)
        base.executor = None  # release the KV pool before the rebuild
        del base
        llm = cls(model_config=mc, engine_config=ec, device=device, tokenizer=tok,
                  params=quantize_int8_params(params, scales, alpha))
        llm.tokenizer_error = tok_err
        return llm

    # ------------------------------------------------------------------
    # scoring utilities, on token ids or a string
    # ------------------------------------------------------------------
    def _single_rank(self, what: str):
        """Scoring and calibration run outside the scheduler loop, on the
        caller's rank alone: under tensor parallelism the other ranks would
        never join their collectives, so they raise instead of hanging."""
        if self.tp_group is not None:
            raise NotImplementedError(
                f"{what} under tensor parallelism is not ported yet (ROADMAP, queue 1)")

    def _encode_ids(self, tokens) -> np.ndarray:
        if isinstance(tokens, str):
            if self.tokenizer is None:
                raise self.tokenizer_error or ValueError("no tokenizer for string input")
            tokens = self.tokenizer.encode(tokens)
        return np.asarray(list(tokens), dtype=np.int32)

    def calc_logits(self, tokens) -> np.ndarray:
        """Per-position vocab logits [T, V] (fp32 numpy)."""
        self._single_rank("calc_logits")
        return self.executor.run_score(self._encode_ids(tokens))

    def calc_hidden_states(self, tokens) -> np.ndarray:
        """Per-position last-layer hidden states [T, d] after the final norm."""
        self._single_rank("calc_hidden_states")
        return self.executor.run_hidden(self._encode_ids(tokens))

    def _logits_and_labels(self, tokens, labels):
        """The logit rows that score ``labels``: by default position i scores
        the next token, tokens[i + 1]."""
        self._single_rank("scoring (calc_log_prob, calc_loss, calc_greedy_match)")
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
