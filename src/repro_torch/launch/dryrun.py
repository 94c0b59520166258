"""Multi-pod dry run: run every (arch x shape) cell once on a fake H100
mesh and count what one device would do: the port's counterpart of the
reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The reference compiles each cell on 512 forced host devices and reads the
compiled artifact. Here a fake process group (``"fake"``, no
communication) of 256 or 512 ranks carries the port's production mesh
(``launch.mesh.make_production_mesh``: (data=16, model=16), or (pod=2,
data=16, model=16)), and this process is rank 0. The cell's arguments are
DTensors of fake local shards (``launch.cells``); its step runs once
under :class:`repro_torch.launch.op_cost.CountingFakeMode`, which counts
the local ops and tracks live local storages. No byte is allocated, so
this runs on a CPU without a card. The fake group is process-wide:
everything in the process then sees 256 or 512 ranks, so run the dry run
in a process of its own.

The fake tensors model the card: CUDA fake tensors on a ``"cuda"`` mesh,
and the kernels the card runs by default (flash, the WKV kernel, the
fused combine: their abstract branch, ``kernels.ops``). Where PyTorch is
built without CUDA, the shards are fake CPU tensors on a ``"cpu"`` mesh (a
fake CUDA tensor cannot be indexed there, nor DTensor's planning run on
one) with the card's kernel routing all the same: the counts do not
depend on the device's name. ``--device cpu`` models the
CPU instead: the plain attention and WKV the CPU runs.

The reference runs its cells under sequence parallelism (the residual
stream's sequence over ``model`` between layers, GSPMD choosing the
layouts inside). The port pins only the batch (``activation_sharding``
over the batch axes), as its own ``launch.train`` does over ranks:
DTensor cannot keep a stream sharded over both batch and sequence through
the models' reshapes without strided shards, and planning their
redistributions on a 3-D mesh ran for minutes inside one einsum. So the
layouts inside a layer are DTensor's propagation of the weights' and the
batch's placements, and the collectives counted are the ones it makes.

Per cell this prints/records (per device):
    memory        arguments live from the start (parameters, optimiser
                  state, caches, inputs) and the high-water mark of live
                  local storages during the step (``peak_bytes``), against
                  the H100's 80 GB (``fits_80GB``)
    cost          FLOPs, transcendentals, bytes of the ops (unfused: an
                  upper bound), split backbone / solver, and the kernels'
                  own charges (``launch.op_cost``)
    collectives   bytes per kind at result size, and per mesh axis with
                  the link that carries them
    roofline      compute / memory / collective seconds at the H100 SXM's
                  constants below, the dominant term, and the share of the
                  counted FLOPs that the model's 6ND / 2ND needs
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

#: H100 SXM, per card
HBM_BYTES = 80e9                 # 80 GB HBM3
PEAK_FLOPS = 989e12              # bf16 dense, tensor cores
HBM_BW = 3.35e12                 # bytes/s
NVLINK_BW = 450e9                # bytes/s each way, within a host of 8
#: ASSUMED inter-host rate per card (one 400 Gb/s NIC a card), not a
#: measurement: the cluster's layout sets it
INTER_HOST_BW = 50e9
CARDS_PER_HOST = 8

__all__ = ["model_flops", "run_cell", "all_cells", "main", "init_fake_world",
           "HBM_BYTES", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
           "INTER_HOST_BW"]


def init_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in which this process is
    rank 0 (once per process; a larger world serves the smaller mesh)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        have = dist.get_world_size()
        if have < world:
            raise RuntimeError(f"a fake world of {have} ranks is initialised;"
                               f" this needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def model_flops(arch: str, shape: str) -> float:
    """6*N*D (train) / 2*N*D (inference), N = active params, D = tokens."""
    from ..configs import SHAPES, get_config
    cfg = get_config(arch)
    cell = SHAPES[shape]
    total, active = cfg.param_count()
    if cell.kind == "train":
        return 6.0 * active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * active * cell.global_batch * cell.seq_len
    if cell.kind == "sample":
        # NFE=20 denoiser evaluations over B x S latent tokens
        return 2.0 * active * cell.global_batch * cell.seq_len * 20
    return 2.0 * active * cell.global_batch     # decode: 1 new token/row


def _devices(device: str) -> tuple[str, str]:
    """(mesh device type, fake tensors' device) modelling ``device``."""
    if device == "cpu" or not torch.backends.cuda.is_built():
        return "cpu", "cpu"
    return "cuda", "cuda"


def collective_links(by_group: dict, mesh) -> dict:
    """Per mesh axis: bytes, the link that carries them and its rate.
    Ranks lie row-major on the mesh, hosts hold ``CARDS_PER_HOST``
    consecutive ranks: a group inside one host rides NVLink, any other
    the inter-host rate (an assumption, ``INTER_HOST_BW``)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = {}
    for i, axis in enumerate(mesh.mesh_dim_names):
        names[mesh.get_group(i).group_name] = axis
    out: dict = {}
    for (kind, group), b in by_group.items():
        ranks = dist.get_process_group_ranks(_resolve_process_group(group)) \
            if group else []
        hosts = {r // CARDS_PER_HOST for r in ranks}
        link = "nvlink" if len(hosts) <= 1 else "inter_host (assumed)"
        axis = names.get(group, group or "?")
        rec = out.setdefault(axis, {"bytes": 0.0, "kinds": {},
                                    "ranks": len(ranks), "hosts": len(hosts),
                                    "link": link,
                                    "bytes_per_s": NVLINK_BW
                                    if link == "nvlink" else INTER_HOST_BW})
        rec["bytes"] += b
        rec["kinds"][kind] = rec["kinds"].get(kind, 0.0) + b
    return out


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             strategy: str | None, device: str = "cuda",
             verbose: bool = True, dump_shapes: bool = False,
             mesh_shape=None, smoke: bool = False) -> dict:
    """One cell on the production mesh (``mesh_shape``: a test mesh of
    that shape over the same axes, ``launch.mesh.make_test_mesh``;
    ``smoke``: the smoke config at ``cells.SMOKE_SHAPES``), counted."""
    from ..models.common import activation_sharding
    from .cells import batch_axes, build_cell
    from .mesh import make_production_mesh, make_test_mesh
    from .op_cost import CountingFakeMode

    mesh_dev, tensor_dev = _devices(device)
    if mesh_shape is None:
        init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=mesh_dev)
    else:
        import math
        init_fake_world(math.prod(mesh_shape))
        axes = ("pod", "data", "model")[-len(mesh_shape):]
        mesh = make_test_mesh(tuple(mesh_shape), axes, device=mesh_dev)
    chips = mesh.size()
    t0 = time.time()
    mode = CountingFakeMode()
    if dump_shapes:
        mode.cost.big_shapes = {}
    with mode:
        cell = build_cell(arch, shape, mesh, strategy=strategy,
                          device=tensor_dev, card=device != "cpu",
                          smoke=smoke)
        mode.cost.track(cell.args)
        arg_b = mode.cost.live_bytes
        # the batch pinned to the batch axes at every layer boundary, as
        # launch.train runs over ranks; no sequence parallelism (see the
        # module docstring)
        act = activation_sharding(None if cell.pure_dp else batch_axes(mesh))
        with act, mode.counting() as cost:
            out = cell.fn(*cell.args)
            del out
    t1 = time.time()

    links = collective_links(cost.coll_by_group, mesh)
    coll = {k: float(v) for k, v in cost.coll_bytes.items()}
    coll_total = cost.collective_total
    peak = cost.peak_bytes
    flops = float(cost.flops)
    bytes_acc = float(cost.bytes)
    mf = 0.0 if smoke or mesh_shape is not None else model_flops(arch, shape)

    t_comp = flops / PEAK_FLOPS
    t_mem = bytes_acc / HBM_BW
    t_coll = sum(r["bytes"] / r["bytes_per_s"] for r in links.values())
    dominant = max(
        (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]

    rec = {
        "arch": arch, "shape": shape, "multi_pod": multi_pod,
        "chips": int(chips), "strategy": strategy, "label": cell.label,
        "device": device, "fake_tensors": tensor_dev,
        "run_s": round(t1 - t0, 1),
        "memory": {
            "argument_bytes": int(arg_b), "peak_bytes": int(peak),
            "fits_80GB": bool(peak <= HBM_BYTES),
        },
        "cost": {"flops_per_device": flops, "bytes_per_device": bytes_acc,
                 "transcendentals_per_device": float(cost.transcendentals),
                 "region_bytes": dict(cost.region_bytes),
                 "kernels": {k: dict(v) for k, v in cost.kernels.items()},
                 "ops": cost.ops},
        "collectives": coll,
        "collective_bytes_per_device": coll_total,
        "collective_links": links,
        "roofline": {
            "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
            "dominant": dominant,
            "model_flops_total": mf,
            "useful_flops_ratio": (mf / (flops * chips)) if flops else 0.0,
        },
        "constants": {"hbm_bytes": HBM_BYTES, "peak_flops_bf16": PEAK_FLOPS,
                      "hbm_bytes_per_s": HBM_BW,
                      "nvlink_bytes_per_s": NVLINK_BW,
                      "inter_host_bytes_per_s (assumed)": INTER_HOST_BW},
    }
    if verbose:
        print(f"== {arch} x {shape}  mesh="
              f"{tuple(mesh.mesh.shape)} "
              f"strategy={strategy}  run={rec['run_s']}s")
        print(f"   memory/device: args={arg_b / 1e9:.2f}GB "
              f"peak={peak / 1e9:.2f}GB fits80GB={rec['memory']['fits_80GB']}")
        print(f"   cost/device: {flops / 1e9:.1f} GFLOPs, "
              f"{bytes_acc / 1e9:.2f} GB accessed (unfused), kernels "
              + (", ".join(f"{k} x{v['calls']}"
                           for k, v in sorted(cost.kernels.items()))
                 or "none"))
        print("   collectives: " + (", ".join(
            f"{k}={v / 2**20:.1f}MiB" for k, v in sorted(coll.items()))
            or "none") + ("  [" + ", ".join(
                f"{a}: {r['bytes'] / 2**20:.1f}MiB over {r['link']}"
                for a, r in links.items()) + "]" if links else ""))
        print(f"   roofline: compute={t_comp * 1e3:.2f}ms "
              f"memory={t_mem * 1e3:.2f}ms collective={t_coll * 1e3:.2f}ms "
              f"dominant={dominant} "
              "useful_flops="
              f"{rec['roofline']['useful_flops_ratio'] * 100:.1f}%")
        sys.stdout.flush()
    if dump_shapes:
        for (dt, shp), (b, c) in sorted(cost.big_shapes.items(),
                                        key=lambda kv: -kv[1][0])[:15]:
            print(f"   {b / 2**30:8.2f} GiB x{c:4d}  {dt}{list(shp)}")
        sys.stdout.flush()
    return rec


def all_cells():
    from ..configs import ARCHS, get_meta
    for arch in ARCHS:
        meta = get_meta(arch)
        for shape in meta.shapes:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--strategy", default=None,
                    help="default: fsdp_tp for train cells, serve_2d for "
                         "serving, dp for sampling")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    ap.add_argument("--dump-shapes", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="model the card (default) or the CPU")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    init_fake_world(512 if any(meshes) else 256)
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                rec = run_cell(arch, shape, multi_pod=mp,
                               strategy=args.strategy, device=args.device,
                               dump_shapes=args.dump_shapes)
            except Exception as e:  # a failure here is a bug in the system
                print(f"!! FAIL {arch} x {shape} multi_pod={mp}: "
                      f"{type(e).__name__}: {e}")
                traceback.print_exc(file=sys.stderr)
                failures.append((arch, shape, mp, str(e)))
                continue
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f4 in failures:
            print("  ", f4[:3])
        sys.exit(1)
    print("\nall cells ran")


if __name__ == "__main__":
    main()
