"""Shared model machinery of the backbones: parameter schemas and
initialisation, and the functional layers (RMSNorm, LayerNorm, the MLP
with its activations, RoPE and Qwen2-VL's multimodal M-RoPE, the LM
losses).

Parameters are declared once as ``ParamDef(shape, axes, init, scale)``
and materialised by :func:`init_params` into a nested dict of tensors with
the same tree and layout as the reference's parameter pytree, so
``repro_torch.convert.params_from_jax`` maps one onto the other leaf by
leaf.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamDef", "init_params", "tree_defs_map", "block_stacks",
           "layer_of", "unstack",
           "rms_norm", "layer_norm", "ACTIVATIONS", "mlp_defs", "mlp_apply",
           "promote_matmul", "promote_einsum", "rope_frequencies",
           "apply_rope", "apply_mrope", "softmax_cross_entropy",
           "chunked_lm_loss"]


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
        # drawn and scaled in place (the values of ``scale * randn``): a
        # stacked leaf of a large config is tens of GB, and a scaled copy
        # beside it would not fit on the card
        z = torch.empty(self.shape, device=device).normal_(
            generator=generator)
        if self.init == "normal":
            return z.mul_(self.scale).to(dtype)
        if self.init == "scaled":
            # fan-in scaled, with the reference's convention: the fan-in is
            # shape[-2] for any rank >= 2, so a 3-D [d, H, hd] projection
            # scales by 1/sqrt(H), not 1/sqrt(d)
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
            return z.mul_(self.scale / math.sqrt(fan_in)).to(dtype)
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


def block_stacks(params: dict) -> list:
    """The stacked [L, ...] block trees of a model's parameters: the
    dense ``blocks`` and a MoE model's ``moe_blocks``, those present."""
    return [params[k] for k in ("blocks", "moe_blocks") if k in params]


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


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """The [hd/2] rotary frequencies, computed in float64 as the
    reference does (rounded to float32 where they are used)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """:func:`rope_frequencies` as a float32 tensor on ``device``, made
    once: a copy from the host inside a CUDA-graph capture fails."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: integer, broadcastable to [..., S].
    The angles in float32, the rotation of the two halves of the head dim
    in float32, the result in ``x``'s dtype."""
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs  # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(sections: tuple[int, int, int], device) -> torch.Tensor:
    """The [hd/2] position stream (0 = t, 1 = h, 2 = w) of each rotary
    frequency, ``np.repeat(np.arange(3), sections)`` as an int64 tensor on
    ``device``, made once (as :func:`_rope_freqs`)."""
    return torch.as_tensor(np.repeat(np.arange(3), np.asarray(sections)),
                           dtype=torch.int64, device=device)


def apply_mrope(x, positions3, sections: tuple[int, int, int],
                theta: float = 10000.0):
    """Multimodal RoPE (Qwen2-VL): x [..., S, H, hd]; positions3 integer
    [3, ..., S], the (t, h, w) streams, which rotate the disjoint
    frequency sections ``sections`` (summing to hd/2) in that order. The
    rotation is :func:`apply_rope`'s, each frequency at its own stream's
    position."""
    n = x.shape[-1] // 2
    if sum(sections) != n:
        raise ValueError(f"mrope_sections {tuple(sections)} must sum to "
                         f"head_dim / 2 = {n}")
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    streams = _mrope_streams(tuple(int(s) for s in sections), x.device)
    pos = torch.movedim(positions3[streams], 0, -1)       # [..., S, hd/2]
    ang = pos.to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _relu2(x):
    return torch.square(F.relu(x))


#: the reference's activations by name (``jax.nn.gelu`` defaults to the
#: tanh form)
ACTIVATIONS = {
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "relu2": _relu2,
}


def mlp_defs(d_model: int, d_ff: int, gated: bool = False) -> dict:
    """The MLP's weights: ``wi`` and ``wo``, and the gate ``wg`` when
    ``gated`` (the default, ungated, is the DiT's)."""
    defs = {"wi": ParamDef((d_model, d_ff), ("embed", "mlp"), "scaled")}
    if gated:
        defs["wg"] = ParamDef((d_model, d_ff), ("embed", "mlp"), "scaled")
    defs["wo"] = ParamDef((d_ff, d_model), ("mlp", "embed"), "scaled")
    return defs


def mlp_apply(p: dict, x, act: str = "gelu", gated: bool = False):
    """``act(x wg) * (x wi)`` when gated, else ``act(x wi)``, then ``wo``
    (the defaults are the DiT's MLP); a bfloat16 stream times float32
    weights computes in float32."""
    f = ACTIVATIONS[act]
    h = promote_matmul(x, p["wi"])
    h = f(promote_matmul(x, p["wg"])) * h if gated else f(h)
    return promote_matmul(h, p["wo"])


def softmax_cross_entropy(logits, labels, mask=None):
    """logits [..., V] (any dtype; upcast), labels int [...]: the mean
    negative log-likelihood over ``mask`` (all positions without one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunked_lm_loss(hidden, head_w, labels, mask=None, *, chunk: int = 512):
    """Sequence-chunked LM loss: the logits of one S-chunk at a time, so
    the live logits are [B, chunk, V], not [B, S, V]. hidden [B, S, d]
    (post-norm), head_w [d, V]. Returns the mean nll over ``mask``. S that
    ``chunk`` does not divide, or not above one chunk, takes the whole
    head at once, as in the reference."""
    B, S, d = hidden.shape
    if S % chunk or S <= chunk:
        logits = promote_matmul(hidden, head_w).float()
        return softmax_cross_entropy(logits, labels, mask)
    sums = cnts = 0.0
    for c0 in range(0, S, chunk):
        logits = promote_matmul(hidden[:, c0:c0 + chunk], head_w).float()
        nll = torch.logsumexp(logits, dim=-1) - torch.gather(
            logits, -1, labels[:, c0:c0 + chunk, None].long())[..., 0]
        mc = torch.ones_like(nll) if mask is None \
            else mask[:, c0:c0 + chunk].float()
        sums = sums + torch.sum(nll * mc)
        cnts = cnts + torch.sum(mc)
    return sums / torch.clamp(cnts, min=1.0)
