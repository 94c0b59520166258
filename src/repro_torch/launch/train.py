"""Training driver of the port: an LM trained end to end on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt /tmp/run1 \
        --resume auto --device cpu

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

One process, one device: ``--strategy`` takes the reference's names
(``dp``, ``tp``, ``fsdp_tp``, ``serve_2d``), which on one device all
compute the same numbers, and places nothing; an unknown name raises, as
the reference's lookup does. A ``torch.distributed`` world larger than
one is refused: data-parallel training over ranks comes with
``parallel/`` and ``optim.zero1_specs`` (ROADMAP A12, item 7). An arch in
``input_mode="embeds"`` (musicgen-large, qwen2-vl-2b) is refused: the
synthetic batches are tokens only, and the reference's driver fails on it
with a ``KeyError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_config, get_smoke
from ..data import ShardedBatchIterator, TokenTaskConfig, synthetic_lm_batch
from ..device import resolve_device
from ..models import RWKV6Config, build_model, init_params
from ..optim import (adamw, apply_updates, chain, clip_by_global_norm,
                     global_norm, linear_warmup_cosine)
from ..runtime import StragglerMonitor, TrainLoop
from ..tree import tree_leaves, unflatten_like

__all__ = ["STRATEGIES", "parse_args", "train_config", "make_optimizer",
           "loss_and_grads", "make_train_step", "make_init_state",
           "make_batches", "train", "main"]

#: the reference's parameter-placement strategies (``models.common``'s
#: ``STRATEGIES``); on one device each places nothing
STRATEGIES = ("tp", "fsdp_tp", "dp", "serve_2d")


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


def _check_placement(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown --strategy {strategy!r}; have "
                       f"{list(STRATEGIES)}")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise RuntimeError(
            f"launch.train runs on one process (the world has {world}): "
            "data-parallel training over ranks comes with parallel/ and "
            "optim.zero1_specs (ROADMAP A12, item 7)")


def make_optimizer(lr: float, steps: int):
    """The reference driver's optimiser."""
    return chain(clip_by_global_norm(1.0),
                 adamw(linear_warmup_cosine(lr, 10, steps)))


def loss_and_grads(model, params, batch):
    """``model.loss_fn(params, batch)`` and its gradient tree (zeros for
    leaves the loss does not read), by autograd of detached leaves of the
    parameters: the tree's own tensors never require grad."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = model.loss_fn(unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten_like(params, list(grads))


def make_train_step(model, opt):
    """``train_step(state, batch) -> (state, {"loss", "gnorm"})`` over the
    state ``{"params", "opt", "step"}``: :func:`loss_and_grads`, then the
    optimiser with every buffer donated: the state given is updated in
    place and returned."""
    def train_step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(model, params, batch)
        gnorm = global_norm(grads)
        updates, opt_state = opt.update(grads, state["opt"], params,
                                        state["step"], donate=True)
        params = apply_updates(params, updates, donate=True)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss, "gnorm": gnorm})
    return train_step


def make_init_state(model, opt, device, seed: int = 0):
    """``init_state()``: float32 parameters drawn from a generator on
    ``device`` seeded with ``seed``, the optimiser state, step 0."""
    def init_state():
        params = init_params(torch.Generator(device).manual_seed(seed),
                             model.param_defs(), torch.float32)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}
    return init_state


def make_batches(cfg, batch: int, seq: int, device) -> ShardedBatchIterator:
    """The reference driver's token batches on ``device``."""
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=seq)
    return ShardedBatchIterator(
        lambda rows, step, host: synthetic_lm_batch(task, rows, step, host),
        batch, device=device)


def train(cfg, args, device, *, log=print):
    """Train ``cfg`` (its training form, :func:`train_config`) for
    ``args.steps`` steps from the newest checkpoint under ``args.ckpt``;
    returns ``(state, metrics per step, loop)``."""
    _check_placement(args.strategy)
    model = build_model(train_config(cfg))
    opt = make_optimizer(args.lr, args.steps)
    loop = TrainLoop(make_train_step(model, opt),
                     make_init_state(model, opt, device), args.ckpt,
                     save_every=args.save_every, monitor=StragglerMonitor())
    if args.resume == "fresh":
        shutil.rmtree(args.ckpt, ignore_errors=True)
    state, hist = loop.run(make_batches(cfg, args.batch, args.seq, device),
                           args.steps, fail_at=args.fail_at, log=log)
    return state, hist, loop


def main(argv=None):
    """The CLI; returns ``(state, metrics per step)``."""
    args = parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    state, hist, loop = train(cfg, args, device)
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} "
              f"(first {hist[0]['loss']:.4f}); straggler events: "
              f"{len(loop.monitor.events)}")
    else:
        print(f"resumed at step {int(state['step'])}: no step left to run")
    return state, hist


if __name__ == "__main__":
    main()
