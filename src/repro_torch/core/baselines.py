"""Baseline samplers the paper compares SA-Solver against (§6.4).

A pure re-export: the legacy free functions live with their families in
``repro_torch.core.samplers.baselines``, each a thin wrapper over the
plan/execute registry (new code should use ``make_sampler(name, ...)``).
They share the signature

    sampler(model_fn, x_T, generator, schedule, ts, **kw, noise=None) -> x_0

where ``ts`` is a decreasing float64 grid (from ``timestep_grid``),
``model_fn(x, t)`` a data-prediction model, and the per-step noise is
drawn from ``generator`` unless ``noise=`` gives it.
"""

from __future__ import annotations

from .samplers.baselines import (ddim, ddpm_ancestral, dpm_solver_pp_2m,
                                 edm_heun, edm_stochastic, euler_maruyama)

__all__ = [
    "ddim",
    "dpm_solver_pp_2m",
    "euler_maruyama",
    "ddpm_ancestral",
    "edm_heun",
    "edm_stochastic",
]
