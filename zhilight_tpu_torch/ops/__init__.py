from .activations import gated_act, get_activation
from .attention import decode_attention, prefill_attention
from .linear import linear
from .norms import layer_norm, qk_norm, rms_norm
from .rope import RopeTable, apply_rope_rot, build_rope_table

__all__ = [
    "gated_act",
    "get_activation",
    "decode_attention",
    "prefill_attention",
    "linear",
    "layer_norm",
    "qk_norm",
    "rms_norm",
    "RopeTable",
    "apply_rope_rot",
    "build_rope_table",
]
