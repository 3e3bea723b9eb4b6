"""Multimodal front-ends: vision embeddings computed by the model's own torch
vision tower, injected into the engine as ``input_embeddings``.

Counterpart of ``zhilight_tpu/models/multimodal.py`` (ZhiLight's
``DeepseekVL2(LLaMA)``, zhilight/models/deepseek_vl_v2.py:63-136): the HF
processor and the vision tower run in torch on the host, as the reference
runs them; only the language model runs on the engine's device, fed
precomputed embeddings and custom position ids through
``SearchTask.input_embeddings`` / ``position_ids``. The vision tower's text
rows come from the engine's own embedding table, a tensor on its device.
"""

from __future__ import annotations

import gc
from typing import Any, List, Optional

import numpy as np
import torch

from ..engine.task import GeneratorArg

__all__ = ["DeepseekVL2", "is_customized_model"]


def is_customized_model(hf_config: dict) -> bool:
    """Reference AutoModel dispatch (zhilight/models/auto_model.py:28)."""
    return hf_config.get("model_type", "") in ("deepseek_vl_v2",)


class DeepseekVL2:
    """DeepSeek-VL2: torch vision encoder on the host + the port's language model.

    Usage:
        llm = LLM(model_path)                      # language weights on the GPU
        vl = DeepseekVL2(llm, model_path)
        out = vl.generate(conversation, images, arg)
    """

    def __init__(self, llm, model_path: str):
        self.llm = llm
        self.model_path = model_path
        self._processor = None
        self._vision = None

    def _ensure_vision(self):
        if self._processor is not None:
            return
        try:
            from transformers import AutoModelForCausalLM, AutoProcessor

            self._processor = AutoProcessor.from_pretrained(
                self.model_path, trust_remote_code=True
            )
            self._vision = AutoModelForCausalLM.from_pretrained(
                self.model_path, trust_remote_code=True
            )
            # only the vision tower + projector run on the host; text-token
            # embeddings come from the engine's table through a shim (the
            # reference nulls `vl_gpt.language` and rebinds it to its own
            # engine, zhilight/models/deepseek_vl_v2.py:90,117-118)
            self._strip_language(self._vision)
        except Exception as e:
            raise RuntimeError(
                f"DeepseekVL2 vision tower unavailable: {e}. The vision encoder "
                "runs in torch on the host (as in the reference); install "
                "transformers and the model's remote code and weights."
            ) from e

    def _strip_language(self, model):
        """Replace the loaded torch language model with an embedding shim over
        the engine's table and free its weights (the engine holds them)."""
        llm = self.llm

        class _EngineEmbedding(torch.nn.Module):
            """Token id -> raw embedding row (no ``scale_emb``) in float32,
            served from the engine's device-resident table and returned on
            the ids' device."""

            def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
                w = llm.executor.params["embedding"]["w"]
                # checked on the host: an id past the table would fault the device
                V = w.shape[0]
                if input_ids.numel() and not 0 <= int(input_ids.min()) <= int(input_ids.max()) < V:
                    raise IndexError(f"token ids must lie in [0, {V})")
                ids = input_ids.detach().to(device=w.device, dtype=torch.long)
                rows = w.index_select(0, ids.reshape(-1)).float()
                return rows.reshape(*ids.shape, w.shape[-1]).to(input_ids.device)

        class _LanguageShim(torch.nn.Module):
            def __init__(self):
                super().__init__()
                self.embed = _EngineEmbedding()

            def get_input_embeddings(self):
                return self.embed

        for name in ("language", "language_model"):
            if getattr(model, name, None) is not None:
                setattr(model, name, _LanguageShim())
                break
        gc.collect()

    def compute_embeddings(self, conversation: List[dict], images: List[Any]):
        """Returns (input_ids, input_embeddings [T, dim] float32, position_ids)."""
        self._ensure_vision()
        prepared = self._processor(
            conversations=conversation, images=images, force_batchify=True
        )
        with torch.no_grad():
            emb = self._vision.prepare_inputs_embeds(**prepared)
        input_ids = prepared["input_ids"][0].tolist()
        emb_np = emb[0].float().cpu().numpy()
        position_ids = np.arange(len(input_ids), dtype=np.int32)
        return input_ids, emb_np, position_ids

    def generate(
        self,
        conversation: List[dict],
        images: List[Any],
        arg: Optional[GeneratorArg] = None,
        generator=None,
    ):
        input_ids, emb, pos = self.compute_embeddings(conversation, images)
        gen = generator or self.llm.generator().start()
        return gen.generate(
            input_ids, arg or GeneratorArg(), input_embeddings=emb, position_ids=pos
        )
