"""Mesh placement helpers for the serve engine.

The engine shards exactly one thing: the leading *request* axis of each
microbatch, over the ``data`` axis of a mesh from
``repro_torch.launch.mesh.make_test_mesh`` / ``make_production_mesh`` (a
named :class:`torch.distributed.device_mesh.DeviceMesh`). Plan tables are
replicated; ranks that share a data coordinate along the ``model`` axis
solve the same lanes (the backbone's tensor parallelism over ``model`` is
not ported). The placement itself (each rank's lanes, the gather of the
result) lives in ``repro_torch.core.samplers.base.sample_sharded``; this
module owns the bucket-size arithmetic that makes batches divisible.
"""

from __future__ import annotations

from typing import Sequence

from ..distributed import world_size
from ..launch.mesh import make_test_mesh

__all__ = ["data_axis_size", "align_bucket_sizes", "auto_mesh",
           "auto_cfg_mesh"]


def data_axis_size(mesh, data_axis: str = "data") -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if data_axis not in names:
        raise ValueError(f"mesh has no axis {data_axis!r}; axes: {names}")
    return int(mesh.mesh.shape[names.index(data_axis)])


def align_bucket_sizes(bucket_sizes: Sequence[int], n_data: int) -> tuple:
    """Round every bucket size up to a multiple of the data-axis size.

    Every rank solves an equal share of a bucket's lanes, so the lane count
    must divide by the data axis; rounding *up* keeps every configured
    bucket usable (a too-small tail bucket just carries a few more masked
    pad lanes).
    """
    if n_data < 1:
        raise ValueError(f"data axis size must be >= 1, got {n_data}")
    aligned = sorted({-(-b // n_data) * n_data for b in bucket_sizes})
    return tuple(aligned)


def auto_mesh(data_axis: str = "data", *, device="cuda"):
    """A serving mesh over every rank of the process group: ``(data=n,
    model=1)``.

    Returns None without an initialised group or at one rank (the engine
    then runs the unsharded ``sample_batched`` path). Real deployments pass
    an explicit mesh (``make_production_mesh``) so the model axis is sized
    for the backbone's tensor parallelism instead.
    """
    n = world_size()
    if n <= 1:
        return None
    return make_test_mesh((n, 1), (data_axis, "model"), device=device)


def auto_cfg_mesh(data_axis: str = "data", cfg_axis: str = "cfg", *,
                  device="cuda"):
    """A CFG-factored serving mesh: ``(cfg=2, data=n//2)``.

    Sharded classifier-free guidance places the cond/uncond pair on the
    size-2 ``cfg`` axis (each rank evaluates ONE branch at the local batch
    instead of both at a doubled local batch) and the request axis on the
    remaining ``data`` factor. Returns None below two ranks or at an odd
    count; the engine then runs the one-call doubled-batch evaluation,
    which combines the same two branches.
    """
    n = world_size()
    if n < 2 or n % 2:
        return None
    return make_test_mesh((2, n // 2), (cfg_axis, data_axis), device=device)
