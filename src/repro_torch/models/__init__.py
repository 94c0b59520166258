"""Models of the port: the DiT denoiser backbone (transformer in denoiser
mode) with its attention, shared layers and contractive test weights.

    param_defs() -> ParamDef tree (stacked [L, ...] block params)
    denoise(params, z, t) -> x0-hat
"""

from .attention import AttentionConfig
from .common import ParamDef, init_params
from .transformer import LMConfig, TransformerLM

__all__ = ["AttentionConfig", "LMConfig", "TransformerLM", "ParamDef",
           "init_params"]
