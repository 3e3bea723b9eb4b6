"""zhilight_tpu_torch — the PyTorch/CUDA port of zhilight_tpu for NVIDIA Hopper.

A second package beside ``zhilight_tpu`` (the JAX/Pallas reference, which it
never imports). Plain tensor work is PyTorch; each Pallas kernel of the ported
path is a hand-written CUDA kernel for ``sm_90a`` under ``ops/cuda`` with
sources in ``csrc/``, built by ``nvcc`` on first use. Entry points run on the
GPU unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

from .config import (
    EngineConfig,
    ModelConfig,
    QuantConfig,
    QuantType,
    adapt_hf_config,
    load_model_config,
)

__all__ = [
    "__version__",
    "EngineConfig",
    "ModelConfig",
    "QuantConfig",
    "QuantType",
    "adapt_hf_config",
    "load_model_config",
]
