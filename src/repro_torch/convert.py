"""Carry parameters and serving caches from the JAX reference into the port.

The port keeps the reference's parameter tree and layouts, so conversion
is leaf by leaf: every leaf the port's model declares is taken from the
reference tree (numpy arrays, e.g. from ``jax.device_get(params)``) with
its shape checked, and any leaf the model does not declare is an error.
Without a model, an RWKV6 tree (``blocks/tm``; an LM, or a denoiser when
it has ``denoiser/``) is built from its shapes. A transformer tree
(``blocks/attn`` and/or ``moe_blocks/attn``, MLA's leaves, ``mtp/``) or a
Zamba2 tree (``blocks/mamba``, ``shared/``) needs ``model=`` or the
reference's config: the block's activation, gating, RoPE or M-RoPE, logit
soft-capping, the MoE's routing, and Zamba2's shared period and SSD chunk
leave no trace in the shapes. ``cache_from_jax`` carries a KV cache
(GQA's ``k``/``v`` or MLA's ``c_kv``/``k_rope``, under ``blocks`` and
``moe_blocks``), an RWKV6 state or a Zamba2 cache (``mamba/conv``,
``mamba/h`` and ``shared_kv``) across, so that one package can prefill and
the other decode.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.attention import MLAConfig
from .models.common import ParamDef
from .models.mamba2 import Mamba2Config, Zamba2, Zamba2Config
from .models.moe import MoEConfig
from .models.rwkv6 import RWKV6, RWKV6Config
from .models.transformer import LMConfig, TransformerLM

__all__ = ["params_from_jax", "cache_from_jax", "model_from_config"]


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


#: the reference LMConfig's fields the port's takes as they are (its
#: dtypes are JAX's and stay the port's defaults)
_LM_FIELDS = ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab_size", "act",
              "gated_mlp", "rope_theta", "rope_type", "mrope_sections",
              "tie_embeddings", "embed_scale", "attn_logit_softcap", "moe",
              "mla", "n_dense_layers", "mtp", "mtp_weight", "input_mode",
              "remat", "denoiser_latent", "denoiser_cond")


#: the reference's nested configs, by field, and the port's classes
_NESTED = {"moe": MoEConfig, "mla": MLAConfig}

#: the reference Zamba2Config's fields the port's takes as they are
_ZAMBA2_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "d_ff", "vocab_size", "shared_period", "rope_theta",
                  "remat", "denoiser_latent")


def _dit_from_config(config) -> TransformerLM:
    """The port's transformer (the DiT, or an LM) for the reference's
    ``LMConfig`` (its ``MoEConfig``/``MLAConfig`` taken field for
    field)."""
    fields = {k: getattr(config, k) for k in _LM_FIELDS}
    for k, cls in _NESTED.items():
        if fields[k] is not None:
            fields[k] = cls(**dataclasses.asdict(fields[k]))
    return TransformerLM(LMConfig(**fields))


def model_from_config(config):
    """The port's model for a reference config: a Zamba2 for its
    ``Zamba2Config`` (the nested ``Mamba2Config`` taken field for field),
    else the transformer of its ``LMConfig``."""
    if not hasattr(config, "mamba"):
        return _dit_from_config(config)
    fields = {k: getattr(config, k) for k in _ZAMBA2_FIELDS}
    return Zamba2(Zamba2Config(
        mamba=Mamba2Config(**dataclasses.asdict(config.mamba)), **fields))


def _rwkv6_from_tree(tree) -> RWKV6:
    """The RWKV6 (a denoiser when the tree has ``denoiser/``, else an LM)
    whose parameter schema has the tree's shapes."""
    tm = tree["blocks"]["tm"]
    L, d = np.shape(tree["blocks"]["ln1"])
    return RWKV6(RWKV6Config(
        n_layers=L, d_model=d, head_dim=np.shape(tm["u"])[2],
        d_ff=np.shape(tree["blocks"]["cm"]["wk"])[2],
        vocab_size=np.shape(tree["embed"])[0],
        decay_lora=np.shape(tm["wa"])[2],
        tshift_lora=np.shape(tm["ts_w2"])[2],
        denoiser_latent=(np.shape(tree["denoiser"]["in_proj"])[0]
                         if "denoiser" in tree else None)))


def _tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, exact in f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)  # a writable copy


def params_from_jax(tree, model=None, *, config=None,
                    device="cpu") -> dict:
    """The port's parameter dict from the reference tree, for ``model``;
    without one, for the model of the reference's ``config`` (its
    ``LMConfig`` or ``Zamba2Config``) or, for an RWKV6 tree, the model
    whose shapes the tree has.

    Raises ``ValueError`` for a transformer or Zamba2 tree given neither
    ``model`` nor ``config``, ``KeyError`` for a declared leaf missing from
    ``tree``, ``ValueError`` for a shape mismatch or for leaves of
    ``tree`` the model did not consume.
    """
    leaves = _flatten(tree)
    consumed = set()

    def take(path, pd: ParamDef):
        if path not in leaves:
            raise KeyError(f"reference tree has no leaf {'/'.join(path)}")
        arr = np.asarray(leaves[path])
        if tuple(arr.shape) != tuple(pd.shape):
            raise ValueError(f"leaf {'/'.join(path)}: reference shape "
                             f"{arr.shape}, port expects {pd.shape}")
        consumed.add(path)
        return _tensor(arr, device)

    def walk(defs, path=()):
        if isinstance(defs, ParamDef):
            return take(path, defs)
        return {k: walk(v, path + (k,)) for k, v in defs.items()}

    if model is None:
        if "tm" in tree.get("blocks", {}):
            model = _rwkv6_from_tree(tree)
        elif config is None:
            raise ValueError(
                "a transformer or Zamba2 tree needs model= or the "
                "reference's config=: its activation, gating, RoPE, "
                "soft-capping, shared period and SSD chunk are not in its "
                "shapes")
        else:
            model = model_from_config(config)
    params = walk(model.param_defs())
    extra = sorted("/".join(p) for p in leaves if p not in consumed)
    if extra:
        raise ValueError(f"reference leaves not consumed by the port: {extra}")
    return params


def cache_from_jax(tree, device="cpu") -> dict:
    """The port's serving cache from the reference's, leaf by leaf (numpy
    arrays, e.g. from ``jax.device_get(cache)``): a transformer's cache
    ``{"blocks", "moe_blocks": {"k", "v"} or {"c_kv", "k_rope"}}``, an
    RWKV6 state ``{"S", "tm_shift", "cm_shift"}`` or a Zamba2 cache
    ``{"mamba": {"conv", "h"}, "shared_kv": {"k", "v"}}``, same tree,
    shapes and dtypes (bfloat16 included)."""
    if isinstance(tree, dict):
        return {k: cache_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)
