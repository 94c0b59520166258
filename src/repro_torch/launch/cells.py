"""Dry-run cell assembly: (architecture x shape x mesh) -> one step of the
cell and its arguments as fake tensors placed on the mesh, the port's
counterpart of the reference's ``launch/cells.py``.

One "cell" is what the dry run (``launch.dryrun``) runs once under a
fake mode:
    train_4k     -> train_step  (loss + grad + optimizer update, ZeRO'd)
    prefill_32k  -> prefill_step
    decode_32k / long_500k -> serve_step (one token against a full cache)
    sample_256 / sample_64 -> sample_step (an SA-Solver solve, NFE 20)

The placements are the reference's (``NamedSharding`` s of the same
``PartitionSpec`` s, ``models.common.specs_for`` and
:func:`cache_specs`), and each argument is a DTensor of fake local shards
of the per-device shape (``DTensor.from_local``: no global tensor is made
even as a fake). Where the reference hands GSPMD a jitted step, the port
runs its own step over the DTensors:
  - train: ``launch.train``'s step (``loss_and_grads`` with the FSDP
    unshard a layer at a time, ``_unshard``; each gradient brought to its
    parameter's placements); ``ACCUM_STEPS`` is a Python loop over
    microbatches accumulating into a zero gradient tree in place; the
    optimiser updates its buffers and the parameters in place
    (``donate=True``, the analog of ``donate_argnums``). The model trains
    through its plain attention and WKV (``train_config``): no kernel has
    a backward.
  - prefill / decode: the model's ``prefill`` / ``decode_step`` writing
    the cache in place, through the kernels the card runs by default
    (the WKV kernel in RWKV6's prefill; flash is in no cached path).
  - sample: the legacy ``core.solver.SASolver`` (NFE 20, P3C3 PEC,
    tau 1, the fused combine the card runs) over ``model.denoise`` with
    flash, eager (``samplers.eager()``: never the compile cache's
    capture). Pure DP over every mesh axis with replicated weights runs
    no collective, so a device's work is the solve of its own lanes with
    whole weights: the cell runs that solve on plain fake tensors of the
    local batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs import SHAPES, ShapeCell, get_config, get_smoke
from ..models import RWKV6Config, build_model
from ..models.common import (NamedSharding, PartitionSpec, abstract_params,
                             mesh_shape_dict, placements_for, replicated,
                             specs_for, tree_defs_map)
from ..optim import adafactor, adamw, apply_updates, chain, clip_by_global_norm
from ..tree import paths_and_leaves, tree_leaves, tree_map, unflatten_like

__all__ = ["build_cell", "Cell", "batch_axes", "cache_specs",
           "param_shardings", "input_specs", "ACCUM_STEPS", "SMOKE_SHAPES"]

P = PartitionSpec

#: the shape cells cut for the smoke configs (the CPU tests): the same
#: kinds, short sequences, a batch of 8 (which (2, 2, 2)'s batch axes
#: divide; 32 to train, which they divide into ``ACCUM_STEPS``' splits)
SMOKE_SHAPES = {
    "train_4k": ShapeCell("train_4k", 128, 32, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 128, 8, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 128, 8, "decode"),
    "long_500k": ShapeCell("long_500k", 256, 1, "decode"),
    "sample_256": ShapeCell("sample_256", 16, 8, "sample"),
    "sample_64": ShapeCell("sample_64", 16, 8, "sample"),
}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: tuple              # trees of fake tensors (DTensors on a mesh)
    in_shardings: tuple      # trees of NamedSharding, as ``args``
    label: str = ""
    #: buffers updated in place at every step (params/opt state for train,
    #: the KV/state cache for serving), the reference's ``donate_argnums``
    donate_argnums: tuple = ()
    #: the activation pins the step runs under (``dryrun.run_cell``)
    pure_dp: bool = False


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape_dict(mesh))


def _batch_dim_spec(mesh, n: int):
    sizes = mesh_shape_dict(mesh)
    ax = batch_axes(mesh)
    total = math.prod(sizes[a] for a in ax) if ax else 1
    if ax and n % total == 0:
        return ax
    # fall back to 'data' only, then replicated
    if "data" in sizes and n % sizes["data"] == 0:
        return ("data",)
    return None


def _name(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def cache_specs(cache_shapes, mesh):
    """Path-keyed sharding rules for serving caches, the reference's:
    dim 1 (batch) over the batch axes; KV heads over ``model`` where they
    divide, else the sequence (and, at a batch the batch axes cannot
    take, the sequence over ``data`` too); MLA's latent cache along the
    sequence; SSM heads, RWKV's state and shifts, the conv state over
    ``model`` where they divide. ``cache_shapes``: a tree of
    ``(shape, dtype)`` leaves (the models' ``cache_shapes``)."""
    sizes = mesh_shape_dict(mesh)
    msize = sizes.get("model", 1)

    def spec(name, shape):
        dims: list = [None] * len(shape)
        if len(shape) >= 2:
            dims[1] = _batch_dim_spec(mesh, shape[1])
        if name in ("k", "v") and len(shape) == 5:
            if shape[3] % msize == 0:
                dims[3] = "model"                # kv heads
            elif shape[2] % msize == 0:
                dims[2] = "model"                # sequence-sharded KV
            if dims[1] is None and dims[2] is None:
                dsize = sizes.get("data", 1)
                if shape[2] % dsize == 0 and shape[2] > 1:
                    dims[2] = "data"
        elif name in ("c_kv", "k_rope") and len(shape) == 4:
            if shape[2] % msize == 0:
                dims[2] = "model"                # sequence-sharded MLA cache
        elif name == "h" and len(shape) == 5:
            if shape[2] % msize == 0:
                dims[2] = "model"                # SSM heads
        elif name == "S" and len(shape) == 5:
            if shape[2] % msize == 0:
                dims[2] = "model"
            elif shape[3] % msize == 0:
                dims[3] = "model"                # rwkv state key-dim
        elif name == "conv" and len(shape) == 4:
            if shape[3] % msize == 0:
                dims[3] = "model"
        elif name in ("tm_shift", "cm_shift") and len(shape) == 3:
            if shape[2] % msize == 0:
                dims[2] = "model"
        return NamedSharding(mesh, P(*dims))

    return _map_shapes(lambda path, sd: spec(_name(path), sd[0]),
                       cache_shapes)


def _map_shapes(fn, tree, prefix: str = ""):
    """``fn(path, (shape, dtype))`` over a tree of ``(shape, dtype)``
    leaves (``paths_and_leaves``' key convention)."""
    if isinstance(tree, dict):
        return {k: _map_shapes(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_shardings(model, mesh, strategy: str = "fsdp_tp"):
    defs = model.param_defs()
    specs = specs_for(defs, strategy, mesh)
    return tree_defs_map(lambda d: None, defs), tree_map(
        lambda s: NamedSharding(mesh, s), specs)


def _opt_shardings(opt_state, params_shardings, mesh):
    """Optimizer-state shardings. AdamW m/v mirror the param tree (path
    suffix match); adafactor vr/vc drop one param dim: the spec is the
    param spec sliced the same way."""
    by_path = {tuple(k.split("/")): s
               for k, s in paths_and_leaves(params_shardings)}

    def find(keys, leaf):
        nd = leaf.dim()
        for i in range(len(keys)):
            if keys[i:] in by_path:
                spec = tuple(by_path[keys[i:]].spec)
                spec = spec + (None,) * (nd - len(spec))
                return NamedSharding(mesh, P(*spec[:nd]))
        if keys and keys[-1] in ("vr", "vc", "v"):
            for i in range(len(keys) - 1):
                if keys[i:-1] in by_path:
                    pspec = list(by_path[keys[i:-1]].spec)
                    pspec += [None] * ((nd + 1) - len(pspec))
                    if keys[-1] == "vr":        # param shape minus last dim
                        spec = pspec[:nd]
                    elif keys[-1] == "vc":      # minus second-to-last dim
                        spec = pspec[:nd - 1] + [pspec[nd]]
                    else:                       # 1-D params: full mirror
                        spec = pspec[:nd]
                    return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P())

    pairs = paths_and_leaves(opt_state)
    return unflatten_like(opt_state, [find(tuple(k.split("/")), leaf)
                                      for k, leaf in pairs])


# ---------------------------------------------------------------------------
# fake arguments on the mesh
# ---------------------------------------------------------------------------


def _local_shape(shape, spec, sizes: dict) -> tuple[int, ...]:
    out = list(shape)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a in sizes:
                out[d] //= sizes[a]
    return tuple(out)


def placed_empty(shape, dtype, sharding: NamedSharding, device):
    """A DTensor of ``shape`` placed by ``sharding`` whose shard is a
    fake tensor of the local shape on ``device`` (made under the active
    fake mode); a plain fake tensor of ``shape`` without a mesh."""
    if sharding is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    local = torch.empty(
        _local_shape(shape, sharding.spec, mesh_shape_dict(mesh)),
        dtype=dtype, device=device)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local, mesh, placements_for(sharding.spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _placed_like(tree, shardings, device):
    """Each leaf of ``tree`` (a tensor, or a ``(shape, dtype)`` pair)
    as :func:`placed_empty` with its sharding in ``shardings``."""
    def one(leaf, sh):
        shape, dtype = (tuple(leaf.shape), leaf.dtype) \
            if isinstance(leaf, torch.Tensor) else leaf
        return placed_empty(shape, dtype, sh, device)
    if isinstance(tree, tuple) and len(tree) == 2 and \
            isinstance(tree[1], torch.dtype):
        return one(tree, shardings)
    if isinstance(tree, dict):
        return {k: _placed_like(v, shardings[k], device)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_placed_like(v, s, device)
                          for v, s in zip(tree, shardings))
    return one(tree, shardings)


# ---------------------------------------------------------------------------
# data inputs per (arch, shape)
# ---------------------------------------------------------------------------


def input_specs(cfg, cell, mesh, *, kind: str):
    """``({name: (shape, dtype)}, {name: NamedSharding})`` of the data
    inputs of one cell, the reference's."""
    B = cell.global_batch
    S = cell.seq_len
    bspec = _batch_dim_spec(mesh, B)
    ns = lambda *dims: NamedSharding(mesh, P(*dims))
    embeds_mode = getattr(cfg, "input_mode", "tokens") == "embeds"
    mrope = getattr(cfg, "rope_type", "") == "mrope"
    i32, bf16 = torch.int32, torch.bfloat16

    if kind == "train":
        if embeds_mode:
            batch = {"embeds": ((B, S, cfg.d_model), bf16),
                     "labels": ((B, S), i32)}
            shard = {"embeds": ns(bspec, None, None),
                     "labels": ns(bspec, None)}
        else:
            batch = {"tokens": ((B, S), i32), "labels": ((B, S), i32)}
            shard = {"tokens": ns(bspec, None), "labels": ns(bspec, None)}
        if getattr(cfg, "mtp", False):
            batch["labels2"] = ((B, S), i32)
            shard["labels2"] = ns(bspec, None)
        if mrope:
            batch["positions"] = ((3, B, S), i32)
            shard["positions"] = ns(None, bspec, None)
        return batch, shard

    if kind == "prefill":
        if embeds_mode:
            batch = {"embeds": ((B, S, cfg.d_model), bf16)}
            shard = {"embeds": ns(bspec, None, None)}
        else:
            batch = {"tokens": ((B, S), i32)}
            shard = {"tokens": ns(bspec, None)}
        if mrope:
            batch["positions"] = ((3, B, S), i32)
            shard["positions"] = ns(None, bspec, None)
        return batch, shard

    if kind == "decode":
        if embeds_mode:
            tok = ((B, 1, cfg.d_model), bf16)
            tshard = ns(bspec, None, None)
        else:
            tok = ((B, 1), i32)
            tshard = ns(bspec, None)
        return {"tokens": tok}, {"tokens": tshard}

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------


def _make_optimizer(arch: str):
    if arch.startswith("deepseek"):
        return chain(clip_by_global_norm(1.0), adafactor(1e-3))
    return chain(clip_by_global_norm(1.0), adamw(3e-4))


#: gradient-accumulation microbatch splits for train cells (the
#: reference's): activation memory divided by the split at identical
#: math, the gradients averaged over the microbatches inside one
#: optimizer step
ACCUM_STEPS = {
    "deepseek-v3-671b": 8,
    "dbrx-132b": 4,
}


def _microbatch(batch, accum: int) -> list[dict]:
    """The ``accum`` microbatches of ``batch``: each input's batch dim
    split in ``accum`` (M-RoPE positions carry the batch on dim 1,
    everything else on dim 0). A DTensor is split shard by shard (each
    rank's i-th slice of its own rows is its part of microbatch i), so
    no rank gathers the batch: the reference's reshape to [accum, B /
    accum] takes other rows into a microbatch, and the step's sum over
    the microbatches is the same."""
    from torch.distributed.tensor import DTensor

    def split(key, v):
        ax = 1 if key == "positions" else 0
        if isinstance(v, DTensor):
            local = v.to_local()
            assert local.shape[ax] % accum == 0, (key, tuple(v.shape), accum)
            return [DTensor.from_local(c, v.device_mesh, v.placements,
                                       run_check=False)
                    for c in local.chunk(accum, dim=ax)]
        assert v.shape[ax] % accum == 0, (key, tuple(v.shape), accum)
        return v.chunk(accum, dim=ax)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(accum)]


def _training_config(cfg):
    """``cfg`` as it trains: the plain attention and WKV (no kernel has a
    backward), as ``launch.train.train_config``; an embeddings-input
    config trains here too (the cell's batch carries its embeddings)."""
    if isinstance(cfg, RWKV6Config):
        return dataclasses.replace(cfg, use_kernel=False)
    return dataclasses.replace(cfg, use_flash=False)


def _serving_config(cfg):
    """``cfg`` as the card serves it: the kernels the card takes by
    default (flash where a model attends without a cache, the WKV kernel
    in RWKV6's chunked path), whatever the fake tensors' device."""
    if isinstance(cfg, RWKV6Config):
        return dataclasses.replace(cfg, use_kernel=True)
    return dataclasses.replace(cfg, use_flash=True)


def build_cell(arch: str, shape: str, mesh, *, strategy: str | None = None,
               param_dtype=torch.bfloat16, accum: int | None = None,
               device="meta", card: bool = True,
               smoke: bool = False) -> Cell:
    """The cell's step and its arguments: DTensors on ``mesh`` (a
    ``DeviceMesh``) of fake shards on ``device``, made under the active
    fake mode (``dryrun.run_cell`` enters its counting mode first).
    ``card``: the models serve through the kernels the card runs by
    default (else the device's own routing: the CPU's plain paths).
    ``smoke``: the arch's smoke config over :data:`SMOKE_SHAPES` (the
    CPU tests' size)."""
    from .train import _like_param, _unshard, loss_and_grads
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cell = (SMOKE_SHAPES if smoke else SHAPES)[shape]
    if strategy is None:
        # train: FSDP+TP (ZeRO-3 storage, per-layer regathers);
        # serve: weights fully resident, 2D TP (no per-step gathers);
        # sample: replicate the small denoiser, pure DP
        strategy = {"train": "fsdp_tp", "sample": "dp"}.get(
            cell.kind, "serve_2d")

    if cell.kind == "train":
        model = build_model(_training_config(cfg))
    else:
        model = build_model(_serving_config(cfg) if card else cfg)
    _, pshard = param_shardings(model, mesh, strategy)

    if cell.kind == "sample":
        return _sample_cell(arch, shape, cell, cfg, model, mesh, pshard,
                            param_dtype, device)

    defs = model.param_defs()
    params = _placed_like(tree_defs_map(lambda d: (d.shape, param_dtype),
                                        defs), pshard, device)

    if cell.kind == "train":
        if accum is None:
            accum = ACCUM_STEPS.get(arch, 1)
        opt = _make_optimizer(arch)
        opt_local = opt.init(abstract_params(defs, param_dtype, device))
        oshard = _opt_shardings(opt_local, pshard, mesh)
        opt_state = _placed_like(opt_local, oshard, device)
        del opt_local
        batch_sd, bshard = input_specs(cfg, cell, mesh, kind="train")
        batch = _placed_like(batch_sd, bshard, device)
        step = torch.zeros((), dtype=torch.int32, device=device)
        sshard = NamedSharding(mesh, P())
        unshard = _unshard(mesh)

        def train_step(params, opt_state, step, batch):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with implicit_replication():
                if accum > 1:
                    inv = 1.0 / accum
                    gacc = tree_map(torch.zeros_like, params)
                    loss = 0.0
                    for mb in _microbatch(batch, accum):
                        l_mb, g = loss_and_grads(model, params, mb, unshard)
                        for a, gi, p in zip(tree_leaves(gacc),
                                            tree_leaves(g),
                                            tree_leaves(params)):
                            a.add_((inv * _like_param(gi, p).float())
                                   .to(a.dtype))
                        del g
                        loss = loss + inv * l_mb
                    grads = gacc
                else:
                    loss, grads = loss_and_grads(model, params, batch,
                                                 unshard)
                    grads = tree_map(_like_param, grads, params)
                updates, opt_state = opt.update(grads, opt_state, params,
                                                step, donate=True)
                del grads
                params = apply_updates(params, updates, donate=True)
            return params, opt_state, step + 1, loss

        return Cell(
            arch=arch, shape=shape, kind="train", fn=train_step,
            args=(params, opt_state, step, batch),
            in_shardings=(pshard, oshard, sshard, bshard),
            label=f"{arch}/{shape}/train_step",
            donate_argnums=(0, 1),
        )

    # serving cells share the cache machinery
    B, S = cell.global_batch, cell.seq_len
    cache_sd = model.cache_shapes(B, S)
    cshard = cache_specs(cache_sd, mesh)
    cache = _placed_like(cache_sd, cshard, device)

    if cell.kind == "prefill":
        batch_sd, bshard = input_specs(cfg, cell, mesh, kind="prefill")
        batch = _placed_like(batch_sd, bshard, device)

        def prefill_step(params, batch, cache):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with torch.no_grad(), implicit_replication():
                logits, cache = model.prefill(params, batch, cache)
                return torch.argmax(replicated(logits, -1), dim=-1), cache

        return Cell(
            arch=arch, shape=shape, kind="prefill", fn=prefill_step,
            args=(params, batch, cache),
            in_shardings=(pshard, bshard, cshard),
            label=f"{arch}/{shape}/prefill_step",
            donate_argnums=(2,),
        )

    if cell.kind == "decode":
        tok_sd, tshard = input_specs(cfg, cell, mesh, kind="decode")
        tokens = _placed_like(tok_sd["tokens"], tshard["tokens"], device)
        index = S - 1                 # the last position of a full cache
        ishard = NamedSharding(mesh, P())

        def serve_step(params, tokens, cache, index):
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            with torch.no_grad(), implicit_replication():
                logits, cache = model.decode_step(params, tokens, cache,
                                                  index)
                return torch.argmax(replicated(logits, -1), dim=-1), cache

        return Cell(
            arch=arch, shape=shape, kind="decode", fn=serve_step,
            args=(params, tokens, cache, index),
            in_shardings=(pshard, tshard["tokens"], cshard, ishard),
            label=f"{arch}/{shape}/serve_step",
            donate_argnums=(2,),
        )

    raise ValueError(cell.kind)


def _sample_cell(arch, shape, cell, cfg, model, mesh, pshard, param_dtype,
                 device) -> Cell:
    """The paper's own workload: the SA-Solver solve (Algorithm 1) driving
    the denoiser-mode backbone, batch over every mesh axis (pure DP)."""
    from ..core import SASolver, SASolverConfig, get_schedule, samplers
    from ..scope import named_scope
    B, S = cell.global_batch, cell.seq_len
    dz = cfg.denoiser_latent
    sizes = mesh_shape_dict(mesh)
    all_axes = tuple(sizes)
    total = math.prod(sizes.values())
    bspec = all_axes if B % total == 0 else _batch_dim_spec(mesh, B)
    xshard = NamedSharding(mesh, P(bspec, None, None))
    kshard = NamedSharding(mesh, P())
    b_local = _local_shape((B, S, dz), xshard.spec, sizes)[0]
    solver = SASolver(get_schedule("vp_linear"), SASolverConfig(
        n_steps=19, predictor_order=3, corrector_order=3, tau=1.0,
        combine="fused"))
    params = abstract_params(model.param_defs(), param_dtype, device)
    xT = torch.empty((b_local, S, dz), dtype=torch.float32, device=device)
    noise = torch.empty((solver.config.n_steps, b_local, S, dz),
                        dtype=torch.float32, device=device)

    def sample_step(params, xT, noise):
        def model_fn(x, t):
            with named_scope("backbone"):
                return model.denoise(params, x, t)
        with samplers.eager():
            return solver.sample(model_fn, xT, noise=noise)

    return Cell(
        arch=arch, shape=shape, kind="sample", fn=sample_step,
        args=(params, xT, noise),
        in_shardings=(pshard, xshard, kshard),
        label=f"{arch}/{shape}/sample_step(NFE20,P3C3,tau1)",
        pure_dp=True,
    )
