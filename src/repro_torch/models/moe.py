"""Mixture-of-Experts block: top-k router and capacity-based dispatch,
after the reference's ``models/moe.py``.

Each batch row is a routing group (GShard-style grouped dispatch): every
token picks its top-k experts, each expert takes its first C tokens in
(token, choice) order, C = max(1, int(S * k / E * capacity_factor)), and
the choices past C are dropped (the token keeps its residual). Expert
weights are stacked [E, d, f]; the experts run as one batched product
over the [B, E, C, d] dispatch tensor.

The reference's dispatch gathers ``x[dispatch]`` and its combine
scatter-adds the gated expert outputs back, in slot order. Both are
written here without duplicate indices so that, on the card, neither
the forward nor the backward adds with atomics (a bitwise reproducible
step): a token's kept slots are distinct, so the dispatch is an indexed
copy of each (token, choice) into its slot and the combine gathers each
token's k slots and adds them in slot order. An unfilled slot holds token
0 with gate 0, as in the reference: it carries ``x[0]`` through the
experts, and its ``0 * y`` is added into token 0 (before the kept slots:
a sum of zeros, so the order does not change the value).

The auxiliary load-balance loss is the Switch Transformer's
``aux_weight * E * sum_e f_e p_e`` (f_e: the share of chosen slots,
dropped ones included; p_e: the mean router probability).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import (ACTIVATIONS, ParamDef, mlp_apply, mlp_defs,
                     shard_moe_dispatch)

__all__ = ["MoEConfig", "moe_defs", "moe_apply", "top_k_lower_first"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0          # shared (always-on) experts, DeepSeek style
    d_expert_ff: int = 2048
    d_shared_ff: int = 2048    # total ff of the shared expert block
    capacity_factor: float = 1.25
    act: str = "silu"
    gated: bool = True
    aux_weight: float = 0.01


def moe_defs(d_model: int, cfg: MoEConfig) -> dict:
    """The router [d, E], the stacked experts ``wi``/``wg`` [E, d, f] and
    ``wo`` [E, f, d], and the shared expert's MLP when ``n_shared``."""
    E, f = cfg.n_experts, cfg.d_expert_ff
    d = {
        "router": ParamDef((d_model, E), ("embed", None), "scaled"),
        "wi": ParamDef((E, d_model, f), ("experts", None, "moe_ff"), "scaled"),
        "wo": ParamDef((E, f, d_model), ("experts", "moe_ff", None), "scaled"),
    }
    if cfg.gated:
        d["wg"] = ParamDef((E, d_model, f), ("experts", None, "moe_ff"),
                           "scaled")
    if cfg.n_shared > 0:
        d["shared"] = mlp_defs(d_model, cfg.d_shared_ff, cfg.gated)
    return d


def top_k_lower_first(x: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries along the last dim,
    equal values taken lower index first (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor):
    """x [B, S, d] -> ``(out [B, S, d] in x's dtype, aux float32 scalar)``.

    Each batch row is a routing group with its own capacity C. The slots
    are laid out expert-major, [E, B, C, d] (row ``e*B*C + b*C + c``), so
    the experts are one batched product over [E, B*C, d] with no
    transposed copy; within a group that is the reference's slot order
    ``e*C + c``. Row ``E*B*C`` is a sentinel that takes the dropped
    choices and is cut away."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(S * k / E * cfg.capacity_factor))
    N = E * B * C  # slots
    dev, dt = x.device, x.dtype

    # ---- routing (float32 probabilities of the stream-dtype logits) ----
    logits = (x @ p["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                    # [B, S, E]
    gate_k, idx_k = top_k_lower_first(probs, k)              # [B, S, k]
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    e_flat = idx_k.reshape(B, S * k)
    # position of each (token, choice) in its expert's queue
    pos = torch.gather(torch.cumsum(F.one_hot(e_flat, E), dim=1), 2,
                       e_flat[..., None])[..., 0] - 1
    b_of = torch.arange(B, device=dev)[:, None]
    rows = torch.where(pos < C, e_flat * (B * C) + b_of * C + pos,
                       N).reshape(-1)                        # [B*S*k]
    filled = torch.zeros(N + 1, dtype=torch.bool, device=dev).index_fill(
        0, rows, True)[:N].reshape(E, B, C, 1)
    gates = torch.zeros(N + 1, dtype=torch.float32, device=dev).scatter(
        0, rows, gate_k.reshape(-1))[:N]

    # ---- dispatch: each kept (token, choice) copied into its slot; an
    # unfilled slot holds its group's token 0 -----------------------------
    xs = x[:, :, None, :].expand(B, S, k, d).reshape(B * S * k, d)
    x_e = torch.where(
        filled, x.new_zeros(N + 1, d).index_copy(0, rows, xs)[:N].reshape(
            E, B, C, d), x[None, :, :1, :]).reshape(E, B * C, d)
    # groups -> experts (the MoE all-to-all): the groups keep the batch
    # axes, the experts take the SP axes
    x_e = shard_moe_dispatch(x_e, group_dim=1, expert_dim=0)

    # ---- experts, in the stream's dtype (each slot tensor let go as soon
    # as the next exists: at a large capacity they are GBs each) ---------
    h = x_e @ p["wi"].to(dt)
    act = ACTIVATIONS[cfg.act]
    h = act(x_e @ p["wg"].to(dt)) * h if cfg.gated else act(h)
    del x_e
    h = shard_moe_dispatch(h, group_dim=1, expert_dim=0)
    y = shard_moe_dispatch(h @ p["wo"].to(dt), group_dim=1,
                           expert_dim=0).reshape(N, d)
    del h
    contrib = (y * gates[:, None].to(dt)).to(dt)
    del y

    # ---- combine: each token's slots added in slot order, after the
    # unfilled slots' zeros into token 0 ----------------------------------
    unfilled = (contrib.reshape(E, B, C, d) * ~filled).sum((0, 2))  # [B, d]
    out = torch.cat([unfilled[:, None], x.new_zeros(B, S - 1, d)], dim=1)
    order, _ = torch.sort(rows.reshape(B, S, k), dim=-1)
    contrib = torch.cat([contrib, contrib.new_zeros(1, d)])
    picked = contrib.index_select(0, order.reshape(-1)).reshape(B, S, k, d)
    del contrib
    for j in range(k):
        out = out + picked[:, :, j]

    if cfg.n_shared > 0:
        out = out + mlp_apply(p["shared"], x, cfg.act, cfg.gated).to(dt)

    # ---- Switch aux loss: share of routed slots x mean probability ------
    f_e = torch.mean(F.one_hot(idx_k, E).float(), dim=(0, 1, 2)) * k
    p_e = torch.mean(probs, dim=(0, 1))
    aux = cfg.aux_weight * E * torch.sum(f_e * p_e)
    return out, aux
