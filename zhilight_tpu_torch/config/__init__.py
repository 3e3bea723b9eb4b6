from .model_config import MLAConfig, ModelConfig, MoEConfig, RopeConfig
from .quant_config import QuantConfig, QuantType
from .engine_config import CacheConfig, EngineConfig, ParallelConfig, SchedulerConfig
from .adapters import adapt_hf_config, load_model_config

__all__ = [
    "ModelConfig",
    "RopeConfig",
    "MoEConfig",
    "MLAConfig",
    "QuantConfig",
    "QuantType",
    "EngineConfig",
    "CacheConfig",
    "SchedulerConfig",
    "ParallelConfig",
    "adapt_hf_config",
    "load_model_config",
]
