"""Fault-tolerant LM training on the PyTorch port: train a smoke-scale
arch, inject a failure, and auto-resume from the latest committed
checkpoint.

    PYTHONPATH=src python examples/torch_lm_train_resume.py --arch rwkv6-3b
    PYTHONPATH=src python examples/torch_lm_train_resume.py --device cpu

It runs on the card by default (``--device cpu`` for the CPU). Run 1
crashes at ``--fail-at``; run 2 picks up the newest checkpoint and trains
to ``--steps``. The data pipeline is deterministic in the step and the
state is committed whole, so the loss stream continues exactly: run 2
trains again the steps between its checkpoint and the crash, and prints
whether their losses are run 1's, bit for bit. The step is
``launch.train``'s (the model's plain paths, the optimiser's buffers
donated); the optimiser is the reference example's ``adamw(1e-3)``
behind a clip at global norm 1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from repro_torch.configs import get_smoke
from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
from repro_torch.device import resolve_device
from repro_torch.launch.train import (make_init_state, make_train_step,
                                      train_config)
from repro_torch.models import build_model
from repro_torch.optim import adamw, chain, clip_by_global_norm
from repro_torch.runtime import InjectedFailure, TrainLoop


class Batches:
    """8 rows of 64 tokens a step, from ``synthetic_lm_batch``; ``step``
    is set by the loop on resume."""

    def __init__(self, task: TokenTaskConfig, device):
        self.task, self.device, self.step = task, device, 0

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        b = synthetic_lm_batch(self.task, 8, self.step)
        self.step += 1
        return {k: torch.as_tensor(b[k], device=self.device)
                for k in ("tokens", "labels")}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at", type=int, default=35)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_resume"))
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    cfg = train_config(get_smoke(args.arch))
    model = build_model(cfg)
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=64)
    opt = chain(clip_by_global_norm(1.0), adamw(1e-3))
    step_fn = make_train_step(model, opt)
    losses: dict = {}  # step -> the loss of each time it was trained

    def train_step(state, batch):
        k = int(state["step"])
        state, metrics = step_fn(state, batch)
        losses.setdefault(k, []).append(float(metrics["loss"]))
        return state, metrics

    def loop():
        return TrainLoop(train_step, make_init_state(model, opt, dev),
                         args.ckpt, save_every=args.save_every)

    print(f"=== run 1 (will crash at step {args.fail_at}) ===")
    try:
        loop().run(Batches(task, dev), args.steps, fail_at=args.fail_at,
                   log_every=10)
    except InjectedFailure as e:
        print(f"!! {e} — simulating node failure\n")

    print("=== run 2 (auto-resume from latest committed checkpoint) ===")
    state, hist = loop().run(Batches(task, dev), args.steps, log_every=10)
    start = int(state["step"]) - len(hist)
    again = [k for k, seen in sorted(losses.items()) if len(seen) == 2]
    exact = all(losses[k][0] == losses[k][1] for k in again)
    print(f"\nrecovered and finished: final loss {hist[-1]['loss']:.4f} "
          f"(started from step {start})")
    if again:
        print(f"steps {again[0]}-{again[-1]}, trained in both runs: run 2's "
              f"losses are run 1's bit for bit: {exact}")
    return {"losses": [h["loss"] for h in hist], "resumed_from": start,
            "retrained_steps": again, "retrained_exact": exact}


if __name__ == "__main__":
    main()
