"""Carry parameters from the JAX reference into the port.

The port keeps the reference's parameter tree and layouts, so conversion
is leaf by leaf: every leaf the port's model declares is taken from the
reference tree (numpy arrays, e.g. from ``jax.device_get(params)``) with
its shape checked, and any leaf the model does not declare is an error.
Without a model, an RWKV6 tree (``blocks/tm``) is built from its shapes.
A transformer tree (``blocks/attn``) needs ``model=`` or the reference's
config: the block's activation, gating, RoPE and logit soft-capping leave
no trace in the shapes, and the port computes only the DiT's.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.common import ParamDef
from .models.rwkv6 import RWKV6, RWKV6Config
from .models.transformer import LMConfig, TransformerLM

__all__ = ["params_from_jax"]


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


_LM_FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab_size", "act", "gated_mlp",
              "rope_type", "attn_logit_softcap", "remat", "denoiser_latent",
              "denoiser_cond")


def _dit_from_config(config) -> TransformerLM:
    """The port's transformer for the reference's ``LMConfig``; raises
    ``NotImplementedError`` for what the port does not compute."""
    absent = {k: getattr(config, k) for k in ("moe", "mla")
              if getattr(config, k, None) is not None}
    if absent:
        raise NotImplementedError(
            f"the PyTorch port's transformer has no {sorted(absent)} "
            f"({config.name})")
    return TransformerLM(LMConfig(**{k: getattr(config, k)
                                     for k in _LM_FIELDS}))


def _rwkv6_from_tree(tree) -> RWKV6:
    """The RWKV6 denoiser whose parameter schema has the tree's shapes."""
    tm = tree["blocks"]["tm"]
    L, d = np.shape(tree["blocks"]["ln1"])
    return RWKV6(RWKV6Config(
        n_layers=L, d_model=d, head_dim=np.shape(tm["u"])[2],
        d_ff=np.shape(tree["blocks"]["cm"]["wk"])[2],
        vocab_size=np.shape(tree["embed"])[0],
        decay_lora=np.shape(tm["wa"])[2],
        tshift_lora=np.shape(tm["ts_w2"])[2],
        denoiser_latent=np.shape(tree["denoiser"]["in_proj"])[0]))


def params_from_jax(tree, model=None, *, config=None,
                    device="cpu") -> dict:
    """The port's parameter dict from the reference tree, for ``model``;
    without one, for the transformer of the reference's ``config`` (its
    ``LMConfig``) or, for an RWKV6 tree, the denoiser whose shapes the
    tree has.

    Raises ``ValueError`` for a transformer tree given neither ``model``
    nor ``config``, ``NotImplementedError`` for a config the port does not
    compute, ``KeyError`` for a declared leaf missing from ``tree``,
    ``ValueError`` for a shape mismatch or for leaves of ``tree`` the
    model did not consume.
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
        return torch.from_numpy(np.array(arr)).to(device)  # a writable copy

    def walk(defs, path=()):
        if isinstance(defs, ParamDef):
            return take(path, defs)
        return {k: walk(v, path + (k,)) for k, v in defs.items()}

    if model is None:
        if "tm" in tree["blocks"]:
            model = _rwkv6_from_tree(tree)
        elif config is None:
            raise ValueError(
                "a transformer tree needs model= or the reference's config=: "
                "its activation, gating, RoPE and soft-capping are not in "
                "its shapes")
        else:
            model = _dit_from_config(config)
    params = walk(model.param_defs())
    extra = sorted("/".join(p) for p in leaves if p not in consumed)
    if extra:
        raise ValueError(f"reference leaves not consumed by the port: {extra}")
    return params
