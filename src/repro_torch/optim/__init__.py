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
reference. Updates are computed without autograd. ZeRO-1 state sharding
(the reference's ``zero1_specs``) comes with ``parallel/`` (ROADMAP A12).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..tree import leaves_like, tree_leaves, tree_map, unflatten_like

__all__ = [
    "adamw", "adafactor", "clip_by_global_norm", "chain", "apply_updates",
    "cosine_schedule", "linear_warmup_cosine", "global_norm", "Optimizer",
]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


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
    def update(grads, state, params=None, step=None):
        g = global_norm(grads)
        scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
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
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
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

        out = [upd(g, m, v, p) for g, m, v, p in zip(
            leaves_like(params, grads), leaves_like(params, state["m"]),
            leaves_like(params, state["v"]), ps)]
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
    def update(grads, state, params, step):
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

    def update(grads, state, params, step):
        new_states = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params, step)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
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
