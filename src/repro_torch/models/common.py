"""Shared model machinery of the denoiser backbones: parameter schemas and
initialisation, and the functional layers (RMSNorm, LayerNorm, MLP).

Parameters are declared once as ``ParamDef(shape, axes, init, scale)``
and materialised by :func:`init_params` into a nested dict of tensors with
the same tree and layout as the reference's parameter pytree, so
``repro_torch.convert.params_from_jax`` maps one onto the other leaf by
leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.nn.functional as F

__all__ = ["ParamDef", "init_params", "tree_defs_map", "layer_of", "unstack",
           "rms_norm", "layer_norm", "mlp_defs", "mlp_apply", "promote_matmul",
           "promote_einsum"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis per dim, as in the reference
    init: str = "normal"  # "normal" | "zeros" | "ones" | "scaled"
    scale: float = 1.0

    def materialize(self, generator: torch.Generator, dtype,
                    device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        z = torch.randn(self.shape, generator=generator, device=device)
        if self.init == "normal":
            return (self.scale * z).to(dtype)
        if self.init == "scaled":
            # fan-in scaled, with the reference's convention: the fan-in is
            # shape[-2] for any rank >= 2, so a 3-D [d, H, hd] projection
            # scales by 1/sqrt(H), not 1/sqrt(d)
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            return (self.scale / math.sqrt(fan_in) * z).to(dtype)
        raise ValueError(self.init)


def tree_defs_map(fn: Callable[[ParamDef], Any], defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_defs_map(fn, v) for k, v in defs.items()}


def init_params(generator: torch.Generator, defs, dtype=torch.float32,
                device=None):
    """Materialise a ParamDef tree on ``generator``'s device (or
    ``device``) with draws from ``generator``."""
    device = generator.device if device is None else device
    return tree_defs_map(lambda d: d.materialize(generator, dtype, device),
                         defs)


def layer_of(tree, l: int):
    """Layer ``l`` of a stacked [L, ...] parameter (or cache) tree."""
    if isinstance(tree, torch.Tensor):
        return tree[l]
    return {k: layer_of(v, l) for k, v in tree.items()}


def unstack(tree) -> list:
    """The layers of a stacked [L, ...] parameter tree, each leaf
    unbound once. Under autograd the backward then stacks the layers'
    gradients into one [L, ...] gradient per leaf, where indexing each
    layer (:func:`layer_of`) builds a full-size gradient per layer."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    per = {k: unstack(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[l] for k, v in per.items()} for l in range(n)]


def promote_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the wider of the two dtypes, as the reference's mixed
    bfloat16 x float32 products promote (PyTorch refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def promote_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rms_norm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm in float32, returned in ``x``'s dtype. The variance is the
    population one (``correction=0``), as ``jnp.var`` computes it."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight.float() + bias.float()).to(dt)


def mlp_defs(d_model: int, d_ff: int) -> dict:
    """The DiT MLP: ungated, GELU (the gated variants belong to the LM zoo)."""
    return {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), "scaled"),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), "scaled"),
    }


def mlp_apply(p: dict, x):
    # jax.nn.gelu, the reference's activation, defaults to the tanh form
    h = F.gelu(promote_matmul(x, p["wi"]), approximate="tanh")
    return promote_matmul(h, p["wo"])
