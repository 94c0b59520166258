"""Models of the port: the transformer (a dense or MoE LM, with GQA or
MLA attention and RoPE or M-RoPE, or the DiT denoiser SA-Solver samples
through), RWKV6 and the Zamba2 hybrid of Mamba2 blocks and one shared
attention block (each an LM, or a denoiser backbone), their shared layers
and their contractive test weights. The shared, duck-typed API:

    param_defs() -> ParamDef tree (stacked [L, ...] block params)
    forward(params, batch) -> (logits, aux)                 (LM mode)
    loss_fn(params, batch) -> scalar
    cache_shapes(batch, s_max) / init_cache(batch, s_max, device=None)
    prefill(params, batch, cache) -> (last_logits, cache)
    decode_step(params, tokens, cache, index) -> (logits, cache)
    denoise(params, z, t) -> x0-hat                          (denoiser mode)

``build_model(cfg)`` dispatches on the config type.
"""

from .attention import AttentionConfig, MLAConfig
from .common import ParamDef, init_params
from .mamba2 import Mamba2Config, Zamba2, Zamba2Config
from .moe import MoEConfig
from .rwkv6 import RWKV6, RWKV6Config
from .transformer import LMConfig, TransformerLM

__all__ = ["AttentionConfig", "MLAConfig", "MoEConfig", "LMConfig",
           "TransformerLM", "RWKV6", "RWKV6Config", "Mamba2Config",
           "Zamba2", "Zamba2Config", "ParamDef", "init_params",
           "build_model"]


def build_model(cfg):
    if isinstance(cfg, LMConfig):
        return TransformerLM(cfg)
    if isinstance(cfg, RWKV6Config):
        return RWKV6(cfg)
    if isinstance(cfg, Zamba2Config):
        return Zamba2(cfg)
    raise TypeError(f"unknown config type {type(cfg).__name__}")
