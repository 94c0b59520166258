"""Collectives of the port's sharded path, over ``torch.distributed``.

The sharded path (``core.samplers.sample_sharded``, sharded classifier-free
guidance in ``core.denoiser``) exchanges whole tensors between the ranks of
one mesh axis: :func:`all_gather` gives every rank of ``group`` every
rank's tensor, in the group's rank order, where the tensor lies (NCCL on
the card, one card a rank; gloo on the CPU, and for two ranks that share
one card, which NCCL refuses: the card's gloo takes CUDA tensors).
:func:`ppermute` (the rotation of ``parallel.pipeline``) is built on it,
so the two gloo ranks that share the card exchange their CUDA tensors
through a collective gloo takes on them (gloo has no point-to-point
``send``/``recv`` of CUDA tensors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "ppermute", "world_size"]


def world_size() -> int:
    """Ranks of the initialised default group; 1 without one."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), indexed by rank in
    ``group``."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def ppermute(t: torch.Tensor, group, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` over the ranks of ``group``: ``perm`` is a list
    of ``(source, destination)`` group ranks, and each rank gets the ``t``
    of the source that sends to it (zeros where none does). Every rank
    gathers every ``t`` (:func:`all_gather`) and keeps its source's."""
    parts = all_gather(t, group)
    me = dist.get_rank(group)
    src = [s for s, d in perm if d == me]
    return parts[src[0]] if src else torch.zeros_like(t)
