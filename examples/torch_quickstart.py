"""Quickstart on the PyTorch port: sample a Gaussian mixture through the
sampler registry.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The reference quickstart (``examples/quickstart.py``) over
``repro_torch``: the analytic oracle (the exact x0-posterior) is the
"diffusion model", so the solver is the only approximation — swap
``model_fn`` for any network with the same (x, t) -> x0-hat signature.
Any registered sampler name works in ``make_sampler`` ("sa", "ddim",
"dpm_solver_pp_2m", ...); the ``nfe=`` keyword fixes the model-evaluation
budget across all of them. It runs on the card by default (``--device
cpu`` for the CPU); the draws come from generators seeded 0-3 on that
device.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import GMM, get_schedule, list_samplers, make_sampler
from repro_torch.core.metrics import sliced_w2
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e))
    gen = lambda seed: torch.Generator(dev).manual_seed(seed)

    schedule = get_schedule("vp_linear")
    target = GMM.default_2d()
    model_fn = target.model_fn(schedule, "data")   # exact E[x0 | x_t]

    sampler = make_sampler(
        "sa",                  # any of list_samplers()
        schedule=schedule,
        nfe=20,                # model-evaluation budget (PEC: 19 steps + 1)
        predictor_order=3,
        corrector_order=3,
        tau=1.0,               # full SDE stochasticity
    )

    x_T = sampler.init_noise(gen(0), (4096, 2))
    x_0 = sampler.sample(model_fn, x_T, gen(1))

    ref = target.sample(gen(2), 4096)
    sw2, prior = sliced_w2(x_0, ref, gen(3)), sliced_w2(x_T, ref, gen(3))
    print(f"registry: {list_samplers()}")
    print(f"sampled {x_0.shape[0]} points with NFE={sampler.nfe}")
    print(f"sliced-W2 to target: {sw2:.5f}")
    print(f"(prior baseline:     {prior:.5f})")
    return {"shape": tuple(x_0.shape), "nfe": sampler.nfe, "sliced_w2": sw2,
            "prior_sliced_w2": prior,
            "finite": bool(torch.isfinite(x_0).all())}


if __name__ == "__main__":
    main()
