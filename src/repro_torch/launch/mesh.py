"""Device meshes of the port's sharded path: named
:class:`torch.distributed.device_mesh.DeviceMesh` es over the ranks of the
current process group, one card (or one CPU process) a rank.

Production layout, as the reference's: one pod of 256 ranks as (data=16,
model=16); two pods (512 ranks) as (pod=2, data=16, model=16), where the
``pod`` axis crosses the pods' boundary (batch collectives only).

Functions, not module-level constants: importing this module touches no
process group (only building a mesh does, and every rank of the group
must build it: the mesh creates one sub-group per axis).
"""

from __future__ import annotations

import math

import torch

from ..distributed import world_size

__all__ = ["make_production_mesh", "make_test_mesh"]


def _mesh(shape, axes, device: str):
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape), dtype=torch.int).reshape(shape)
    return DeviceMesh(torch.device(device).type, ranks,
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} devices, have {have} — run under "
            f"torchrun with {need} ranks in all (--nnodes x "
            "--nproc-per-node), one card a rank")
    return _mesh(shape, axes, device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cuda"):
    """A small named mesh over the first ``prod(shape)`` ranks of the
    current process group (ranks in row-major order), on ``device``'s type:
    ``"cuda"`` on the card, ``"cpu"`` where the caller asks for the CPU
    (the CPU tests' gloo ranks)."""
    return _mesh(tuple(shape), axes, device)
