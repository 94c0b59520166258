"""End-to-end script on the PyTorch port: train a small DiT denoiser for a
few hundred steps on a synthetic latent-field task, then sample it with
SA-Solver at several (tau, NFE) settings — the paper's full pipeline.

    PYTHONPATH=src python examples/torch_train_denoiser.py --steps 300
    PYTHONPATH=src python examples/torch_train_denoiser.py --device cpu

It runs on the card by default (``--device cpu`` for the CPU). Training
differentiates the DiT's plain attention (``use_flash=False``); sampling
goes through the legacy ``SASolver`` with the fused combine, on the card
through the flash-attention and combine kernels. The training loop is the
fault-tolerant one (checkpoints to --ckpt, auto-resume on rerun). The
draws of ``t`` and the noise at step k come from a generator seeded by
(42, k), so a resumed run draws what an uninterrupted run draws.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import SASolver, SASolverConfig, get_schedule
from repro_torch.core.metrics import sliced_w2
from repro_torch.data import ShardedBatchIterator, latent_batch
from repro_torch.device import resolve_device
from repro_torch.models import TransformerLM
from repro_torch.models.common import init_params
from repro_torch.optim import (adamw, apply_updates, chain,
                               clip_by_global_norm, linear_warmup_cosine)
from repro_torch.runtime import TrainLoop
from repro_torch.tree import tree_leaves, unflatten_like

#: the reference example's (tau, NFE) settings
SETTINGS = ((0.0, 10), (0.4, 10), (0.0, 30), (1.0, 30))


def denoise_loss(model, params, x0, t, eps, schedule):
    """Mean squared x0-prediction error at ``x_t = alpha_t x0 + sigma_t
    eps``, ``t`` [B] the per-sample times."""
    a = schedule.alpha_d(t)[:, None, None]
    s = schedule.sigma_d(t)[:, None, None]
    pred = model.denoise(params, a * x0 + s * eps, t)
    return torch.mean((pred - x0) ** 2)


def loss_and_grads(model, params, x0, t, eps, schedule):
    """``denoise_loss`` and its gradient tree (zeros for the leaves the
    loss does not read), by autograd of detached copies of the parameters:
    the tree's own tensors never require grad."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = denoise_loss(model, unflatten_like(params, leaves), x0, t, eps,
                        schedule)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten_like(params, grads)


def make_train_step(model, opt, schedule, draw):
    """``train_step(state, batch) -> (state, {"loss"})`` over the state
    ``{"params", "opt", "step"}``; ``draw(step, x0) -> (t, eps)``."""
    def train_step(state, batch):
        params, x0 = state["params"], batch["x0"]
        t, eps = draw(int(state["step"]), x0)
        loss, grads = loss_and_grads(model, params, x0, t, eps, schedule)
        upd, opt_state = opt.update(grads, state["opt"], params,
                                    state["step"])
        return ({"params": apply_updates(params, upd), "opt": opt_state,
                 "step": state["step"] + 1}, {"loss": loss})
    return train_step


def seeded_draw(step: int, x0: torch.Tensor):
    """(t, eps) for training step ``step``: t ~ U[1e-3, 1) per sample and
    eps ~ N(0, I), from a generator on ``x0``'s device seeded by
    (42, step)."""
    seed = int(np.random.SeedSequence([42, step]).generate_state(1)[0])
    g = torch.Generator(x0.device).manual_seed(seed)
    t = 1e-3 + (1.0 - 1e-3) * torch.rand(x0.shape[0], generator=g,
                                          device=x0.device)
    eps = torch.randn(x0.shape, generator=g, device=x0.device)
    return t, eps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_denoiser"))
    ap.add_argument("--fresh", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--samples", type=int, default=512,
                    help="latents sampled per setting (and held-out ones)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.fresh:
        shutil.rmtree(args.ckpt, ignore_errors=True)

    sched = get_schedule("vp_linear")
    cfg = dataclasses.replace(get_smoke("dit-s"), n_layers=4, d_model=128,
                              d_ff=512, n_heads=4, n_kv_heads=4,
                              dtype=torch.float32, use_flash=False)
    model = TransformerLM(cfg)
    dz, S = cfg.denoiser_latent, args.seq
    opt = chain(clip_by_global_norm(1.0),
                adamw(linear_warmup_cosine(2e-3, 20, args.steps),
                      weight_decay=0.0))

    def init_state():
        params = init_params(torch.Generator(dev).manual_seed(0),
                             model.param_defs(), torch.float32)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    batches = ShardedBatchIterator(
        lambda rows, step, host: latent_batch(dz, S, rows, step, host),
        args.batch, device=dev)
    loop = TrainLoop(make_train_step(model, opt, sched, seeded_draw),
                     init_state, args.ckpt, save_every=100)
    state, hist = loop.run(batches, args.steps, log_every=50)
    if hist:
        print(f"\ntraining: loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}")
    else:
        print(f"\ntraining: resumed at step {args.steps}, nothing to run")

    # ---- sample with SA-Solver at several settings --------------------
    sampler_model = TransformerLM(dataclasses.replace(cfg, use_flash=None))
    params, N = state["params"], args.samples
    data = torch.from_numpy(latent_batch(dz, S, N, step=10_000)["x0"]).to(dev)
    print("\nSA-Solver sampling (sliced-W2 to held-out data, lower=better):")
    w2 = {}
    for tau, nfe in SETTINGS:
        solver = SASolver(sched, SASolverConfig(
            n_steps=nfe - 1, predictor_order=3, corrector_order=3, tau=tau,
            combine="fused"))
        xT = solver.init_noise(torch.Generator(dev).manual_seed(5),
                               (N, S, dz))
        x0 = solver.sample(
            lambda x, t: sampler_model.denoise(params, x, t), xT,
            torch.Generator(dev).manual_seed(6))
        d = sliced_w2(x0.reshape(N, -1), data.reshape(N, -1),
                      torch.Generator(dev).manual_seed(9))
        w2[f"tau={tau},nfe={nfe}"] = d
        print(f"  tau={tau:<4} NFE={nfe:<3} sliced-W2={d:.4f}")
    d0 = sliced_w2(xT.reshape(N, -1), data.reshape(N, -1),
                   torch.Generator(dev).manual_seed(9))
    print(f"  (prior noise baseline: {d0:.4f})")
    return {"losses": [h["loss"] for h in hist], "sliced_w2": w2,
            "prior_sliced_w2": d0}


if __name__ == "__main__":
    main()
