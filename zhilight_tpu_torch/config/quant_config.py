"""Quantization configuration.

Parity with reference ``model::QuantConfig`` / ``QuantType``
(src/model/model_config.hpp:134-177) and the HF quantization_config adapter
(zhilight/quant.py:27-91). TPU-native implementations live in
``zhilight_tpu/ops/pallas/`` (fused dequant-matmul) rather than CUDA kernels.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

__all__ = ["QuantType", "QuantConfig"]


class QuantType(enum.Enum):
    NO_QUANT = 0
    ABS_MAX = 1        # pre-quantized int8 weights + fp16 scales
    AUTO_INT8 = 2      # quantize fp16/bf16 weights to int8 at load (SmoothQuant optional)
    INT4 = 3
    AUTO_INT4 = 4
    GPTQ = 5           # W4A16 groupwise
    AWQ = 6            # W4A16 groupwise (zero-point)
    FP8 = 7            # per-tensor / per-channel fp8
    FP8_BLOCK = 10     # 128x128 block-scaled fp8 (DeepSeek-V3)

    # NOTE: the reference additionally distinguishes GPTQ_Marlin / AWQ_Marlin —
    # those are CUDA kernel-layout variants of the same GPTQ/AWQ formats; on TPU
    # there is a single Pallas weight layout per format, so they collapse into
    # GPTQ / AWQ here (handled by the adapter).


@dataclass(frozen=True)
class QuantConfig:
    quant_type: QuantType = QuantType.NO_QUANT
    group_size: int = 128
    sym: bool = False
    act_order: bool = False
    # quantize KV cache to int8 alongside weights (reference quant_weight_kv)
    quant_kv: bool = False
    # SmoothQuant activation-scale migration strength for AUTO_INT8
    smooth_alpha: float = 0.5
    # bits for GPTQ/AWQ
    bits: int = 4

    @property
    def enabled(self) -> bool:
        return self.quant_type != QuantType.NO_QUANT

    @property
    def is_int8(self) -> bool:
        return self.quant_type in (QuantType.ABS_MAX, QuantType.AUTO_INT8)

    @property
    def is_int4(self) -> bool:
        return self.quant_type in (
            QuantType.INT4,
            QuantType.AUTO_INT4,
            QuantType.GPTQ,
            QuantType.AWQ,
        )

    @property
    def is_fp8(self) -> bool:
        return self.quant_type in (QuantType.FP8, QuantType.FP8_BLOCK)

    @classmethod
    def from_hf_config(cls, hf_config: dict) -> "QuantConfig":
        """Map HF ``quantization_config`` to a QuantConfig.

        Parity: zhilight/quant.py:36-91 ``QuantConfig.adapt_hf_config``.
        """
        qcfg: Optional[dict] = hf_config.get("quantization_config")
        if not qcfg:
            return cls()
        method = qcfg.get("quant_method", "").lower()
        if method == "gptq":
            return cls(
                quant_type=QuantType.GPTQ,
                group_size=qcfg.get("group_size", 128),
                sym=qcfg.get("sym", False),
                act_order=qcfg.get("desc_act", False),
                bits=qcfg.get("bits", 4),
            )
        if method == "awq":
            return cls(
                quant_type=QuantType.AWQ,
                group_size=qcfg.get("group_size", 128),
                sym=False,
                bits=qcfg.get("bits", 4),
            )
        if method == "fp8":
            block = qcfg.get("weight_block_size")
            return cls(
                quant_type=QuantType.FP8_BLOCK if block else QuantType.FP8,
                group_size=(block[0] if block else 128),
            )
        if method in ("int8", "smoothquant", "compressed-tensors"):
            return cls(quant_type=QuantType.AUTO_INT8)
        raise ValueError(f"unsupported quant_method: {method!r}")
