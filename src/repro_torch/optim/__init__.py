"""Optimizers + LR schedules, functional, over the port's parameter trees.

- ``adamw``: standard AdamW with selectable state dtype (f32 default,
  bf16 for memory-tight configs).
- ``adafactor``: factored second moment (Shazeer & Stern): 2 x O(sqrt)
  factors instead of 2 x full moments.
- ``chain`` of gradient transforms: clip_by_global_norm -> optimizer.

API and state trees are the reference's (optax-like): init(params) ->
state; update(grads, state, params, step) -> (updates, state);
apply_updates(params, updates). ``chain``'s state is a tuple, adamw's
``{"m", "v"}``. Trees are nested dicts/tuples/lists of tensors; the step
is an integer (a 0-d tensor on the parameters' device keeps the update
free of host reads) and the step arithmetic is float32, as in the
reference. Updates are computed without autograd. ``zero1_specs`` gives
the reference's ZeRO-1 specs of the moments. Over DTensor parameters the
state is made like them (``zeros_like``: the same mesh and placements)
and the updates run leaf by leaf on the DTensors.

``update(..., donate=True)`` and ``apply_updates(..., donate=True)`` are
the counterpart of a jitted step's donated buffers: the caller hands over
the gradients and the optimiser state (``update``) or the parameters
(``apply_updates``), and the results are written into their tensors one
leaf at a time, with the same arithmetic, so bit for bit the functional
results. A step then holds one copy of parameters, gradients and moments
(four f32 trees) instead of the functional step's old and new copies.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..tree import leaves_like, tree_leaves, tree_map, unflatten_like

__all__ = [
    "adamw", "adafactor", "clip_by_global_norm", "chain", "apply_updates",
    "cosine_schedule", "linear_warmup_cosine", "global_norm", "Optimizer",
    "zero1_specs",
]


class Optimizer(NamedTuple):
    init: Callable
    #: (grads, state, params, step, *, donate=False) -> (updates, state)
    update: Callable


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float32)


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: _f32(lr, torch.as_tensor(step).device)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params=None, step=None, *, donate=False):
        g = global_norm(grads)
        scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
        if donate:
            for x in tree_leaves(grads):
                x.mul_(scale)
            return grads, state
        return tree_map(lambda x: x * scale, grads), state

    return Optimizer(init, update)


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(
            p, dtype=state_dtype, memory_format=torch.contiguous_format)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, *, donate=False):
        ps = tree_leaves(params)
        step = torch.as_tensor(step, device=ps[0].device)
        step_f = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - torch.pow(b1, step_f)
        bc2 = 1.0 - torch.pow(b2, step_f)

        def upd(g, m, v, p):
            g = g.float()
            m32, v32 = m.float(), v.float()
            m32 = b1 * m32 + (1 - b1) * g
            v32 = b2 * v32 + (1 - b2) * g * g
            u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
            u = u + weight_decay * p.float()
            return ((-lr_t * u).to(p.dtype), m32.to(state_dtype),
                    v32.to(state_dtype))

        def upd_(g, m, v, p):
            """``upd`` written into ``m``, ``v`` and ``g`` (returned as the
            update), op for op the same arithmetic, with two temporaries
            of the leaf's size at a time."""
            g32 = g.float()
            m.mul_(b1).add_((1 - b1) * g32)
            t = (1 - b2) * g32
            v.mul_(b2).add_(t.mul_(g32))
            t = torch.div(v, bc2).sqrt_().add_(eps)
            u = torch.div(m, bc1).div_(t)
            del t
            u.add_(weight_decay * p.float()).mul_(-lr_t)
            return g.copy_(u) if g.dtype == p.dtype else u.to(p.dtype)

        leaves = zip(leaves_like(params, grads),
                     leaves_like(params, state["m"]),
                     leaves_like(params, state["v"]), ps)
        if donate and state_dtype == torch.float32:
            # each leaf's results into its own gradient and moments (a
            # narrower state is updated in float32 and rounded, as above)
            out = [upd_(*leaf) for leaf in leaves]
            return unflatten_like(params, out), state
        out = [upd(*leaf) for leaf in leaves]
        col = lambda i: unflatten_like(params, [o[i] for o in out])
        return col(0), {"m": col(1), "v": col(2)}

    return Optimizer(init, update)


def adafactor(
    lr: float | Callable = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    """Factored 2nd moment for >=2D params; full for 1D. No 1st moment."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return tree_map(st, params)

    @torch.no_grad()
    def update(grads, state, params, step, *, donate=False):
        del donate  # functional: the donated trees are left as they are
        ps = tree_leaves(params)
        step = torch.as_tensor(step, device=ps[0].device)
        step_f = step.to(torch.float32) + 1.0
        beta = 1.0 - step_f ** (-decay)
        lr_t = lr_fn(step)

        def upd(g, s, p):
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                r = vr / torch.mean(vr, dim=-1, keepdim=True)
                u = g / (torch.sqrt(r)[..., None]
                         * torch.sqrt(vc)[..., None, :] + 1e-30)
                news = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / (torch.sqrt(v) + 1e-30)
                news = {"v": v}
            # update clipping (RMS(u) <= clip_threshold)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.float()
            return (-lr_t * u).to(p.dtype), news

        out = [upd(g, s, p) for g, s, p in zip(
            leaves_like(params, grads), leaves_like(params, state), ps)]
        return (unflatten_like(params, [o[0] for o in out]),
                unflatten_like(params, [o[1] for o in out]))

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params, step, *, donate=False):
        new_states = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params, step, donate=donate)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates, *, donate=False):
    """``params + updates`` leaf by leaf; ``donate``: added into the
    parameters' own tensors, which are returned."""
    if donate:
        for p, u in zip(tree_leaves(params), leaves_like(params, updates)):
            p.add_(u.to(p.dtype))
        return params
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# ---------------------------------------------------------------------------
# LR schedules (step: an integer, or an integer tensor; float32 out)
# ---------------------------------------------------------------------------


def cosine_schedule(base_lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        frac = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return base_lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(base_lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        step_f = step.to(torch.float32)
        warm = base_lr * step_f / max(warmup, 1)
        return torch.where(step_f < warmup, warm, cos(step - warmup))
    return fn


# ---------------------------------------------------------------------------
# ZeRO-1 optimizer-state sharding
# ---------------------------------------------------------------------------


def zero1_specs(param_specs, mesh, axis: str = "data"):
    """Specs for AdamW state: shard the largest *unsharded* dim of each
    moment over ``axis`` (params keep their own specs). Falls back to the
    param's spec when no dim divides, when the spec already uses ``axis``
    or when the axis has one rank. ``mesh``: a ``DeviceMesh`` or an
    ``{axis: size}`` dict. Returns ``tree_specs(shapes)``, over a tree of
    shapes (tuples of ints) laid out as ``param_specs``."""
    from ..models.common import PartitionSpec, mesh_shape_dict
    size = mesh_shape_dict(mesh)[axis]

    def spec_for(ps, shape):
        shape = tuple(shape)
        used = {a for e in ps if e
                for a in ((e,) if isinstance(e, str) else e)}
        if axis in used or size <= 1:
            return ps
        dims = list(ps) + [None] * (len(shape) - len(ps))
        # largest unassigned dim divisible by the axis size
        cands = [(shape[i], i) for i in range(len(shape))
                 if dims[i] is None and shape[i] % size == 0]
        if not cands:
            return ps
        _, i = max(cands)
        dims[i] = axis
        return PartitionSpec(*dims)

    def tree_specs(shapes):
        return tree_map(spec_for, param_specs, shapes)

    return tree_specs
