"""GPipe-style pipeline parallelism over the ranks of one mesh axis.

The layer stack [L, ...] is split into ``n_stages`` contiguous groups, one
a rank of the ``stage`` axis; microbatches rotate through the stages with
``distributed.ppermute``. The schedule is the reference's GPipe loop
(fill -> steady state -> drain) over ``n_micro + n_stages - 1`` ticks: at
every tick each stage applies its block to the activation it holds, then
passes it to the next stage. Bubble fraction = (S-1)/(M+S-1). Every rank
runs every tick (SPMD, as the reference's shard_map does), so a stage
computes on zeros while the pipe fills and drains.

The activation a microbatch carries may be a tree of tensors (nested
dicts, tuples, lists): what travels with it (a block's conditioning)
rotates with it, and ``block_fn`` keeps the ``(params, x) -> x`` form.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..distributed import ppermute
from ..models.common import is_dtensor
from ..tree import tree_map

__all__ = ["pipeline_apply"]


def _stage_slice(v, stage: int):
    """This stage's [...] slice of a [n_stages, ...] leaf: the local shard
    of a DTensor sharded on dim 0 over the stage axis, or row ``stage`` of
    a whole tensor."""
    if is_dtensor(v):
        return v.to_local()[0]
    return v[stage]


def pipeline_apply(block_fn, stage_params, x_micro, mesh,
                   axis: str = "stage"):
    """Run a pipelined layer stack.

    block_fn: (params_slice, x) -> x          (one stage's layers)
    stage_params: tree of [n_stages, ...] leaves (whole on every rank, or
      DTensors sharded on dim 0 over ``axis``)
    x_micro: [n_micro, micro_batch, ...] microbatched input, the same on
      every rank (or a tree of such leaves)
    mesh: a ``DeviceMesh`` with the axis ``axis``
    Returns [n_micro, micro_batch, ...] outputs (the same tree), on every
    rank.
    """
    names = list(mesh.mesh_dim_names)
    n_stages = int(mesh.mesh.shape[names.index(axis)])
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    leaves = []
    tree_map(leaves.append, x_micro)
    n_micro = int(leaves[0].shape[0])
    params = tree_map(lambda v: _stage_slice(v, stage), stage_params)
    fwd = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    held = tree_map(lambda v: torch.zeros_like(v[0]), x_micro)
    outputs = tree_map(torch.zeros_like, x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (the last one again past the end)
        if stage == 0:
            held = tree_map(lambda v: v[min(t, n_micro - 1)], x_micro)
        y = block_fn(params, held)
        # the last stage emits microbatch t - (S-1)
        if stage == n_stages - 1 and t >= n_stages - 1:
            tree_map(lambda o, v: o[t - (n_stages - 1)].copy_(v), outputs, y)
        # rotate the activations to the next stage
        held = tree_map(lambda v: ppermute(v, group, fwd), y)
    # only the last stage holds real outputs: replicate by a masked sum
    mask = float(stage == n_stages - 1)
    outputs = tree_map(lambda o: o * mask, outputs)
    tree_map(lambda o: dist.all_reduce(o, group=group), outputs)
    return outputs
