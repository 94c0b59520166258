"""Models of the port: the denoiser backbones SA-Solver samples through
(the DiT transformer with its attention, and RWKV6), their shared layers
and their contractive test weights.

    param_defs() -> ParamDef tree (stacked [L, ...] block params)
    denoise(params, z, t) -> x0-hat

``build_model(cfg)`` dispatches on the config type.
"""

from .attention import AttentionConfig
from .common import ParamDef, init_params
from .rwkv6 import RWKV6, RWKV6Config
from .transformer import LMConfig, TransformerLM

__all__ = ["AttentionConfig", "LMConfig", "TransformerLM", "RWKV6",
           "RWKV6Config", "ParamDef", "init_params", "build_model"]


def build_model(cfg):
    if isinstance(cfg, LMConfig):
        return TransformerLM(cfg)
    if isinstance(cfg, RWKV6Config):
        return RWKV6(cfg)
    raise TypeError(f"unknown config type {type(cfg).__name__}")
