from . import llama, multimodal
from .multimodal import DeepseekVL2, is_customized_model

__all__ = ["llama", "multimodal", "DeepseekVL2", "is_customized_model"]
