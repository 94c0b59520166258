"""Training driver of the port: an LM trained end to end, on one device
or over the ranks of a ``torch.distributed`` world.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt /tmp/run1 \
        --resume auto --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --device cpu --strategy fsdp_tp

The reference's driver (``repro.launch.train``) in PyTorch, with its
flags and defaults and ``--device`` (the card unless ``cpu`` is asked
for; with no card it stops): ``model.loss_fn`` of the arch (the dense
or MoE transformer, RWKV6 or Zamba2) differentiated by autograd, ``chain(
clip_by_global_norm(1.0), adamw(linear_warmup_cosine(lr, 10, steps)))``,
``ShardedBatchIterator`` over ``synthetic_lm_batch`` (the reference's
batches bit for bit), and the checkpointed ``TrainLoop`` with its
``StragglerMonitor``. Fault-tolerance knobs: ``--resume auto`` picks up
the newest committed checkpoint under ``--ckpt``; ``--fail-at N`` raises
at step N (the recovery path end to end); the straggler monitor counts
slow steps.

The model trains through its plain paths (``use_flash=False`` for the
transformer's and Zamba2's attention, ``use_kernel=False`` for RWKV6's
WKV): the kernels have no backward, as the reference's
Pallas kernels have none, so a training step launches no kernel. The
step hands its gradients, optimiser state and parameters to the
optimiser as donated buffers (``optim``'s ``donate=True``), so it holds
one copy of each. The parameters are drawn from the port's own generator
seeded with 0 (the reference's ``PRNGKey(0)`` draw has no torch
counterpart; ``convert.params_from_jax`` carries its parameters across).

Over ranks (torchrun's environment; NCCL on the card, one card a rank,
gloo on the CPU), as the reference's driver: :func:`make_mesh` is a
``("data",)`` mesh of the world's ranks, or ``launch.mesh``'s production
mesh from 256 ranks up; the parameters are DTensors placed by
``specs_for(defs, --strategy, mesh)`` (``models.common.STRATEGIES``: an
unknown name raises, as the reference's lookup does), the optimiser state
follows them, the batches are DTensors sharded over the batch axes (the
global batch is the R host batches in rank order), and the loop runs
inside ``activation_sharding(("data",))``. For the loss each parameter's
shards over the batch axes are gathered (FSDP's unshard, inside
autograd; shards over ``model`` stay): a layer stack's a layer at a time
where the layer runs (``models.common.param_gathering``; under the
configs' ``remat`` made again in the backward), the other leaves once
for the step. Each gradient is brought to
its parameter's placements before the optimiser (a replicated parameter's
``Partial`` gradient all-reduced, a sharded one's reduce-scattered). The
step runs under DTensor's implicit replication: a plain tensor that a
model makes inside (positions, masks, a zero state) meets the DTensors as
a replicated one. Logs and checkpoint writes come from rank 0. One
process places nothing and is bitwise the one-device driver. An arch in
``input_mode="embeds"`` (musicgen-large, qwen2-vl-2b) is refused: the
synthetic batches are tokens only, and the reference's driver fails on it
with a ``KeyError``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke
from ..data import ShardedBatchIterator, TokenTaskConfig, synthetic_lm_batch
from ..device import resolve_device
from ..distributed import world_size
from ..models import RWKV6Config, build_model, init_params
from ..models.common import (LAYER_STACKS, STRATEGIES, activation_sharding,
                             distribute_tree, is_dtensor, param_gathering,
                             specs_for)
from ..optim import (adamw, apply_updates, chain, clip_by_global_norm,
                     global_norm, linear_warmup_cosine)
from ..runtime import StragglerMonitor, TrainLoop
from ..tree import tree_leaves, tree_map, unflatten_like
from .mesh import make_production_mesh, make_test_mesh

__all__ = ["parse_args", "train_config", "make_mesh", "make_optimizer",
           "loss_and_grads", "make_train_step", "make_init_state",
           "make_batches", "train", "main"]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "fresh"])
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--strategy", default="dp")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    return ap.parse_args(argv)


def train_config(cfg):
    """``cfg`` as it trains: the plain attention (the transformer, Zamba2's
    shared block) or the plain WKV paths (RWKV6). Raises for an
    embeddings-input config (musicgen-large, qwen2-vl-2b)."""
    if getattr(cfg, "input_mode", "tokens") == "embeds":
        raise ValueError(
            f"{cfg.name}: input_mode='embeds' takes precomputed embeddings "
            "(batch['embeds']), and the training data (synthetic_lm_batch) "
            "gives tokens only; the reference's driver fails on it with "
            "KeyError: 'embeds'")
    if isinstance(cfg, RWKV6Config):
        return dataclasses.replace(cfg, use_kernel=False)
    return dataclasses.replace(cfg, use_flash=False)


def _check_strategy(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown --strategy {strategy!r}; have "
                       f"{list(STRATEGIES)}")


def make_mesh(device):
    """The reference's mesh over the initialised world: None for one
    process (nothing placed), the production mesh from 256 ranks up, else
    a ``("data",)`` mesh of every rank, on ``device``'s type."""
    n = world_size()
    if n <= 1:
        return None
    if n >= 256:
        return make_production_mesh(device=device.type)
    return make_test_mesh((n,), ("data",), device=device.type)


def _distributed_ops(mesh):
    """DTensor's implicit replication of plain tensors over a mesh;
    nothing without one."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _unshard(mesh):
    """FSDP's unshard: a parameter's shards over the mesh's batch axes
    (``pod``, ``data``) gathered into replicas, inside autograd (so the
    gradient comes back reduce-scattered onto the shards); its shards over
    other axes (``model``: tensor parallelism) kept. The contractions then
    run over whole weights on batch-sharded activations, as the
    reference's layer-boundary pins make GSPMD schedule them."""
    from torch.distributed.tensor import Replicate
    names = list(mesh.mesh_dim_names)
    fsdp = {names.index(a) for a in ("pod", "data") if a in names}

    def unshard(p):
        want = tuple(Replicate() if i in fsdp else pl
                     for i, pl in enumerate(p.placements))
        if want == tuple(p.placements):
            return p
        return p.redistribute(p.device_mesh, want)
    return unshard


def _like_param(g, p):
    """``g`` in ``p``'s placements (a plain gradient as it is)."""
    if not is_dtensor(p) or tuple(g.placements) == \
            tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _global(x):
    """The whole value of a DTensor on every rank (a collective)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_optimizer(lr: float, steps: int):
    """The reference driver's optimiser."""
    return chain(clip_by_global_norm(1.0),
                 adamw(linear_warmup_cosine(lr, 10, steps)))


def loss_and_grads(model, params, batch, unshard=None):
    """``model.loss_fn(params, batch)`` and its gradient tree (zeros for
    leaves the loss does not read), by autograd of detached leaves of the
    parameters: the tree's own tensors never require grad. ``unshard``
    maps each leaf to the form the loss reads (inside autograd): the
    layer stacks' (``LAYER_STACKS``) a layer at a time, by the model
    where each layer runs (``param_gathering``), the others here."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = unflatten_like(params, leaves)
    if unshard is None:
        loss = model.loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    else:
        tree = {k: v if k in LAYER_STACKS else tree_map(unshard, v)
                for k, v in tree.items()}
        with param_gathering(unshard):  # the backward's remat gathers too
            loss = model.loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    return loss.detach(), unflatten_like(params, list(grads))


def make_train_step(model, opt, mesh=None):
    """``train_step(state, batch) -> (state, {"loss", "gnorm"})`` over the
    state ``{"params", "opt", "step"}``: :func:`loss_and_grads`, then the
    optimiser with every buffer donated: the state given is updated in
    place and returned. With ``mesh`` (DTensor parameters and batches):
    under implicit replication, the parameters unsharded over the batch
    axes for the loss (:func:`_unshard`), each gradient in its
    parameter's placements, the metrics whole on every rank."""
    unshard = None if mesh is None else _unshard(mesh)

    def train_step(state, batch):
        params = state["params"]
        with _distributed_ops(mesh):
            loss, grads = loss_and_grads(model, params, batch, unshard)
            if mesh is not None:
                grads = tree_map(_like_param, grads, params)
            gnorm = global_norm(grads)
            updates, opt_state = opt.update(grads, state["opt"], params,
                                            state["step"], donate=True)
            params = apply_updates(params, updates, donate=True)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": _global(loss), "gnorm": _global(gnorm)})
    return train_step


def make_init_state(model, opt, device, seed: int = 0, *, mesh=None,
                    strategy: str = "dp"):
    """``init_state()``: float32 parameters drawn from a generator on
    ``device`` seeded with ``seed`` (with ``mesh``: the same draw on every
    rank, each keeping its shard under ``specs_for(defs, strategy,
    mesh)``), the optimiser state, step 0."""
    def init_state():
        defs = model.param_defs()
        params = init_params(torch.Generator(device).manual_seed(seed),
                             defs, torch.float32)
        if mesh is not None:
            params = distribute_tree(params, specs_for(defs, strategy, mesh),
                                     mesh)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}
    return init_state


def make_batches(cfg, batch: int, seq: int, device,
                 mesh=None) -> ShardedBatchIterator:
    """The reference driver's token batches on ``device`` (with ``mesh``:
    DTensors sharded over its batch axes)."""
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=seq)
    return ShardedBatchIterator(
        lambda rows, step, host: synthetic_lm_batch(task, rows, step, host),
        batch, device=device, mesh=mesh)


def train(cfg, args, device, *, log=print):
    """Train ``cfg`` (its training form, :func:`train_config`) for
    ``args.steps`` steps from the newest checkpoint under ``args.ckpt``,
    over the initialised world's ranks (:func:`make_mesh`); returns
    ``(state, metrics per step, loop)``. Only rank 0 logs."""
    _check_strategy(args.strategy)
    model = build_model(train_config(cfg))
    opt = make_optimizer(args.lr, args.steps)
    mesh = make_mesh(device)
    rank0 = mesh is None or dist.get_rank() == 0
    loop = TrainLoop(make_train_step(model, opt, mesh),
                     make_init_state(model, opt, device, mesh=mesh,
                                     strategy=args.strategy), args.ckpt,
                     save_every=args.save_every, monitor=StragglerMonitor())
    if args.resume == "fresh":
        if rank0:
            shutil.rmtree(args.ckpt, ignore_errors=True)
        if mesh is not None:
            dist.barrier()
    batches = make_batches(cfg, args.batch, args.seq, device, mesh)
    with (activation_sharding(("data",)) if mesh is not None
          else contextlib.nullcontext()):
        state, hist = loop.run(batches, args.steps, fail_at=args.fail_at,
                               log=log if rank0 else None)
    return state, hist, loop


def _init_world(device) -> bool:
    """The process group of torchrun's ranks (``WORLD_SIZE`` above one in
    the environment), made here: NCCL on the card (one card a rank, by
    ``LOCAL_RANK``), gloo on the CPU. Whether it was made here."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise SystemExit(
                f"launch.train needs one card per rank (local rank {local}, "
                f"{torch.cuda.device_count()} cards)")
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def main(argv=None):
    """The CLI; returns ``(state, metrics per step)``."""
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    _check_strategy(args.strategy)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    made = _init_world(device)
    try:
        if device.type == "cuda" and made:
            device = torch.device("cuda", torch.cuda.current_device())
        state, hist, loop = train(cfg, args, device)
        rank0 = world_size() == 1 or dist.get_rank() == 0
        if rank0 and hist:
            print(f"final loss {hist[-1]['loss']:.4f} "
                  f"(first {hist[0]['loss']:.4f}); straggler events: "
                  f"{len(loop.monitor.events)}")
        elif rank0:
            print(f"resumed at step {int(state['step'])}: no step left to "
                  "run")
    finally:
        if made:
            dist.destroy_process_group()
    return state, hist


if __name__ == "__main__":
    main()
