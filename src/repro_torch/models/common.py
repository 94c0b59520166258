"""Shared model machinery of the backbones: parameter schemas and
initialisation, sharding rules and placements, and the functional layers
(RMSNorm, LayerNorm, the MLP with its activations, RoPE and Qwen2-VL's
multimodal M-RoPE, the LM losses).

Parameters are declared once as ``ParamDef(shape, axes, init, scale)``
and materialised by :func:`init_params` into a nested dict of tensors with
the same tree and layout as the reference's parameter pytree, so
``repro_torch.convert.params_from_jax`` maps one onto the other leaf by
leaf. The logical axes (``"vocab"``, ``"embed"``, ``"heads"``, ...) map to
mesh axes through a strategy's rule table (:func:`specs_for`), and a spec
on a ``DeviceMesh`` becomes DTensor placements (:func:`placements_for`),
the counterpart of the reference's ``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ParamDef", "init_params", "abstract_params", "tree_defs_map",
           "block_stacks",
           "layer_of", "unstack", "PartitionSpec", "STRATEGIES",
           "resolve_spec", "mesh_shape_dict", "specs_for", "batch_spec",
           "NamedSharding", "placements_for", "is_dtensor", "distribute",
           "distribute_tree", "constrain", "replicated", "whole_along",
           "activation_sharding", "shard_batch_dim",
           "shard_logits_path", "shard_moe_dispatch", "shard_heads_dim",
           "LAYER_STACKS", "param_gathering", "gathered",
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


def abstract_params(defs, dtype=torch.float32, device="meta"):
    """The ParamDef tree as fake tensors of each leaf's shape and
    ``dtype`` on ``device``, which hold no data and never allocate (the
    dry run's parameters; the reference's ``ShapeDtypeStruct`` s), made
    under the active ``FakeTensorMode`` or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = detect_fake_mode() or FakeTensorMode()
    with mode:
        return tree_defs_map(
            lambda d: torch.empty(d.shape, dtype=dtype, device=device), defs)


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


# ---------------------------------------------------------------------------
# Sharding strategies and placements
# ---------------------------------------------------------------------------


class PartitionSpec:
    """Mesh axes per tensor dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over all of them, the first
    outermost), as the reference's ``jax.sharding.PartitionSpec``; a
    one-axis tuple is that axis, as JAX normalises it."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                          else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self.dims == other.dims

    def __hash__(self) -> int:
        return hash(self.dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.dims!r}"

# logical axis -> mesh axis, tried in order; a mesh axis is consumed at most
# once per param (first match wins). The reference's table, verbatim.
STRATEGIES: dict[str, dict[str, str]] = {
    # pure tensor parallel (weights replicated across data)
    "tp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "mlp": "model", "experts": "model", "heads_flat": "model",
        "ssm_heads": "model", "moe_ff": None,
    },
    # tensor parallel + fully-sharded remaining dim over EVERY data-parallel
    # rank — ("pod","data") in the multi-pod mesh — (ZeRO-3-ish storage);
    # experts stay on 'model', their f dim stored over ("pod","data")
    "fsdp_tp": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "mlp": "model", "experts": "model", "heads_flat": "model",
        "ssm_heads": "model", "embed": ("pod", "data"),
        "moe_ff": ("pod", "data"),
    },
    # data parallel only (small models / tests)
    "dp": {},
    # serving: weights fully resident (no per-step FSDP gathers), 2D TP —
    # attention/experts over 'model', the MLP hidden dim over 'data'
    "serve_2d": {
        "vocab": "model", "heads": "model", "kv_heads": "model",
        "experts": "model", "mlp": "data", "heads_flat": "model",
        "ssm_heads": "model", "moe_ff": "data",
    },
}


def resolve_spec(axes: tuple[str | None, ...], rules: dict,
                 mesh_shape: dict[str, int],
                 shape: tuple[int, ...] | None = None) -> PartitionSpec:
    """Map logical axes -> mesh axes; a mesh axis is consumed once per param
    and a mapping is dropped unless the dim divides the mesh-axis size. A
    rule value may be a TUPLE of mesh axes: the axes absent from the mesh
    are filtered, then the full combination is tried, then shorter
    prefixes, then each single axis."""
    used: set[str] = set()
    out = []
    for i, a in enumerate(axes):
        m = rules.get(a) if a else None
        if isinstance(m, tuple):
            cand = tuple(x for x in m if x in mesh_shape and x not in used)
            options = [cand[:k] for k in range(len(cand), 1, -1)] + \
                      [(x,) for x in cand]
            for opt in options:
                size = math.prod(mesh_shape[x] for x in opt)
                if shape is None or (size > 0 and shape[i] % size == 0):
                    used.update(opt)
                    out.append(opt if len(opt) > 1 else opt[0])
                    break
            else:
                out.append(None)
            continue
        ok = m is not None and m in mesh_shape and m not in used
        if ok and shape is not None and shape[i] % mesh_shape[m] != 0:
            ok = False
        if ok:
            used.add(m)
        out.append(m if ok else None)
    return PartitionSpec(*out)


def mesh_shape_dict(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (or of such a dict itself)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def specs_for(defs, strategy: str, mesh):
    """The spec of every parameter of ``defs`` under ``strategy`` on
    ``mesh`` (a ``DeviceMesh`` or an ``{axis: size}`` dict)."""
    rules = STRATEGIES[strategy]
    ms = mesh_shape_dict(mesh)
    return tree_defs_map(lambda d: resolve_spec(d.axes, rules, ms, d.shape),
                         defs)


def batch_spec(mesh_axes, *trailing) -> PartitionSpec:
    """Batch dim over ('pod','data') when present, else ('data',)."""
    b = tuple(a for a in ("pod", "data") if a in mesh_axes)
    return PartitionSpec(b if b else None, *trailing)


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dim named by tensor dim ``d``, ``Replicate()`` elsewhere. A dim
    over several axes is split over them in mesh order (pod-major for
    ``("pod", "data")``, as JAX lays out ``P(("pod", "data"))``); an axis
    the mesh lacks is dropped."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes_of(entry) if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of dim {d} out of the "
                             f"mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the placement of one tensor, as the reference's
    ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def distribute(t: torch.Tensor, mesh, placements):
    """``t`` (the whole array, the same on every rank) as a DTensor with
    ``placements`` on ``mesh``: each rank keeps its own shard, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def distribute_tree(tree, specs, mesh):
    """Every tensor of ``tree`` (whole, the same on every rank) as a
    DTensor placed by its spec in ``specs`` (the same tree) on ``mesh``."""
    from ..tree import tree_map
    return tree_map(lambda t, s: distribute(t, mesh, placements_for(s, mesh)),
                    tree, specs)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, spec):
    """``x`` redistributed to ``spec`` on its own mesh when it is a
    DTensor; anything else as it is."""
    if not is_dtensor(x):
        return x
    want = placements_for(spec, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicated(x, dim: int | None = None):
    """``x`` gathered where DTensor cannot shard an op: with ``dim``, the
    mesh dims that shard tensor dim ``dim`` or hold pending sums
    (``Partial``) turned to ``Replicate`` (the rest kept); without, every
    mesh dim. A plain tensor is returned as it is. The sites that call it
    are the gathers GSPMD makes there too (a gather along a sharded
    vocabulary dim)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate, Shard
    d = None if dim is None else dim % x.ndim
    want = tuple(Replicate() if d is None or isinstance(p, Partial) or (
        isinstance(p, Shard) and p.dim == d) else p for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _Whole(torch.autograd.Function):
    """``replicated`` forward and backward: the gradient that comes back
    is gathered along ``dim`` too."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return replicated(x, dim)

    @staticmethod
    def backward(ctx, g):
        return replicated(g, ctx.dim), None


def whole_along(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered (:func:`replicated`), and its
    gradient gathered along ``dim`` before it flows back: where a later
    view splits or merges ``dim`` in a way DTensor cannot keep sharded,
    in the forward or in the backward. A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return _Whole.apply(x, dim)


# --- activation sharding ----------------------------------------------------
# The reference pins the residual stream's batch dim (and, with sequence
# parallelism, its seq dim) at every layer boundary, so GSPMD does not
# resolve the FSDP-weight vs batch-sharded-activation conflict by gathering
# the batch. Here the same pins are redistributions of DTensor activations
# on their own mesh, inside ``activation_sharding``; on a plain tensor, or
# outside the context, each helper returns its input untouched.

_BATCH_AXES: tuple[str, ...] | None = None
_SEQ_AXES: tuple[str, ...] | None = None
_SEQ_DIVISOR: int = 1


class activation_sharding:
    """Context manager: pin [B, S, ...] activations to these mesh axes.

    ``seq_axes`` adds Megatron-style sequence parallelism: the residual
    stream between blocks is sharded on its seq dim over these axes
    (applied only when S divides ``seq_divisor`` and S > 1)."""

    def __init__(self, axes, seq_axes=None, seq_divisor: int = 1):
        self.axes = tuple(axes) if axes else None
        self.seq_axes = tuple(seq_axes) if seq_axes else None
        self.seq_divisor = seq_divisor

    def __enter__(self):
        global _BATCH_AXES, _SEQ_AXES, _SEQ_DIVISOR
        self._old = (_BATCH_AXES, _SEQ_AXES, _SEQ_DIVISOR)
        _BATCH_AXES = self.axes
        _SEQ_AXES = self.seq_axes
        _SEQ_DIVISOR = self.seq_divisor
        return self

    def __exit__(self, *exc):
        global _BATCH_AXES, _SEQ_AXES, _SEQ_DIVISOR
        _BATCH_AXES, _SEQ_AXES, _SEQ_DIVISOR = self._old
        return False


def shard_batch_dim(x):
    """Pin dim 0 (batch) — and dim 1 (sequence, when SP is on and
    divisible) — of an activation to the installed mesh axes."""
    if _BATCH_AXES is None or x.ndim < 2 or not is_dtensor(x):
        return x
    dims: list = [_BATCH_AXES] + [None] * (x.ndim - 1)
    if (_SEQ_AXES is not None and x.ndim >= 3
            and x.shape[1] % max(_SEQ_DIVISOR, 1) == 0 and x.shape[1] > 1):
        dims[1] = _SEQ_AXES
    return constrain(x, PartitionSpec(*dims))


def shard_logits_path(h, logits):
    """At the LM head: gather h's sequence (keep its batch pinned), and
    keep the logits' vocab dim on the SP axes when it divides."""
    if _BATCH_AXES is None:
        return h, logits
    if h is not None and h.ndim >= 3 and is_dtensor(h):
        h = constrain(h, PartitionSpec(_BATCH_AXES, *([None] * (h.ndim - 1))))
    if logits is not None and _SEQ_AXES is not None \
            and logits.shape[-1] % max(_SEQ_DIVISOR, 1) == 0 \
            and is_dtensor(logits):
        dims = [_BATCH_AXES] + [None] * (logits.ndim - 2) + [_SEQ_AXES]
        logits = constrain(logits, PartitionSpec(*dims))
    return h, logits


def shard_moe_dispatch(x, group_dim: int = 0, expert_dim: int = 1):
    """Pin MoE dispatch tensors (the reference's [B(groups), E, C, d];
    ``group_dim`` and ``expert_dim`` name the dims of another layout):
    groups over the batch axes, experts over the SP axes when E
    divides."""
    if _BATCH_AXES is None or x.ndim < 3 or not is_dtensor(x):
        return x
    dims: list = [None] * x.ndim
    dims[group_dim] = _BATCH_AXES
    if _SEQ_AXES is not None \
            and x.shape[expert_dim] % max(_SEQ_DIVISOR, 1) == 0:
        dims[expert_dim] = _SEQ_AXES
    return constrain(x, PartitionSpec(*dims))


def shard_heads_dim(x, dim: int = 2):
    """Pin the heads dim of [B, S, H, hd] attention internals to the SP
    axes (head-parallel attention); a no-op when heads do not divide,
    without SP, or outside the context."""
    if _SEQ_AXES is None or x.ndim <= dim or not is_dtensor(x):
        return x
    if x.shape[dim] % max(_SEQ_DIVISOR, 1) != 0:
        return x
    dims: list = [_BATCH_AXES] + [None] * (x.ndim - 1)
    dims[dim] = _SEQ_AXES
    return constrain(x, PartitionSpec(*dims))


# --- parameter gathering ----------------------------------------------------
# FSDP's unshard a layer at a time. Inside ``param_gathering(fn)`` each
# model applies ``fn`` to one layer's parameters where that layer runs,
# inside the function its ``remat`` checkpoints: under ``remat`` the
# gathered weights are made again in the backward, not kept, so a rank
# holds one gathered layer beside its shards, as GSPMD gathers each
# layer's slice inside the reference's scan. Outside the context
# :func:`gathered` returns its input.

#: the top-level parameter keys whose leaves stack the layers ([L, ...]),
#: gathered by the models a layer at a time
LAYER_STACKS = ("blocks", "moe_blocks")
_GATHER: Callable | None = None


class param_gathering:
    """Context manager: ``fn`` maps each leaf of a layer's parameters to
    the form the layer reads (:func:`gathered`)."""

    def __init__(self, fn: Callable):
        self.fn = fn

    def __enter__(self):
        global _GATHER
        self._old = _GATHER
        _GATHER = self.fn
        return self

    def __exit__(self, *exc):
        global _GATHER
        _GATHER = self._old
        return False


def gathered(tree):
    """One layer's parameters with the installed gather applied to each
    leaf; ``tree`` itself outside :class:`param_gathering`."""
    if _GATHER is None:
        return tree
    from ..tree import tree_map
    return tree_map(_GATHER, tree)


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
    gold = torch.gather(replicated(logits, -1), -1,
                        labels[..., None].long())[..., 0]
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
            replicated(logits, -1), -1,
            labels[:, c0:c0 + chunk, None].long())[..., 0]
        mc = torch.ones_like(nll) if mask is None \
            else mask[:, c0:c0 + chunk].float()
        sums = sums + torch.sum(nll * mc)
        cnts = cnts + torch.sum(mc)
    return sums / torch.clamp(cnts, min=1.0)
