"""SA-Solver (paper Algorithm 1): the legacy surface over the samplers API.

New code should go through the plan/execute registry::

    from repro_torch.core import samplers
    s = samplers.make_sampler("sa", nfe=20, tau=0.4)
    x0 = s.sample(model_fn, x_T, generator)

``SASolver`` and ``sample`` remain as thin shims: they build the same
coefficient tables and hand them to the registry's executor through its
compile cache, so a legacy call is bit for bit ``make_sampler("sa")``'s
solve and shares its cache entry.

The model is evaluated once per step, plus one initial evaluation:
NFE = n_steps + 1 for PEC, 2 n_steps + 1 for PECE. ``model_fn(x, t)`` must
match ``tables.parameterization`` ("data": it returns x0-hat; "noise":
eps-hat). The per-step noise is drawn from ``generator`` (one float32
``[M, *x_T.shape]`` buffer), or given as ``noise=``.
"""

from __future__ import annotations

import dataclasses

import torch

from .coefficients import SolverTables, build_tables
from .samplers.base import SamplerPlan, SamplerSpec
from .samplers.base import sample as registry_sample
from .samplers.multistep import multistep_statics, plan_from_tables
from .schedules import NoiseSchedule, timestep_grid
from .tau import TauSchedule

__all__ = ["SASolverConfig", "SASolver", "sample"]


@dataclasses.dataclass(frozen=True)
class SASolverConfig:
    n_steps: int = 20
    predictor_order: int = 3
    corrector_order: int = 3
    tau: float | TauSchedule = 1.0
    parameterization: str = "data"  # "data" | "noise"
    grid: str = "logsnr"  # "time" | "logsnr" | "karras"
    rho: float = 7.0
    t_start: float | None = None
    t_end: float | None = None
    #: replace the final state by the final buffered x0-prediction
    #: ("denoise to zero"; zero extra NFE). Data parameterization only.
    denoise_final: bool = True
    #: PEC (paper Algorithm 1) or PECE (re-evaluate after correction)
    mode: str = "PEC"
    #: "einsum", "kernel" or "fused" (see ``SamplerSpec.combine``)
    combine: str = "einsum"

    @property
    def nfe(self) -> int:
        per_step = 2 if self.mode == "PECE" else 1
        return self.n_steps * per_step + 1


class SASolver:
    """Bind (schedule, config) to reusable tables. (Legacy shim; prefer
    ``samplers.make_sampler("sa", ...)``.)"""

    def __init__(self, schedule: NoiseSchedule, config: SASolverConfig):
        self.schedule = schedule
        self.config = config
        ts = timestep_grid(
            schedule, config.n_steps, kind=config.grid,
            t_start=config.t_start, t_end=config.t_end, rho=config.rho,
        )
        self.tables = build_tables(
            schedule, ts,
            tau=config.tau,
            predictor_order=config.predictor_order,
            corrector_order=config.corrector_order,
            parameterization=config.parameterization,
        )

    def sample(self, model_fn, x_T: torch.Tensor,
               generator: torch.Generator | None = None, *,
               noise=None) -> torch.Tensor:
        return sample(model_fn, x_T, generator, self.tables, self.config,
                      noise=noise)

    def init_noise(self, generator: torch.Generator, shape,
                   dtype=torch.float32) -> torch.Tensor:
        """x_T ~ N(0, prior_scale^2 I) on ``generator``'s device."""
        scale = self.schedule.prior_scale(float(self.tables.ts[0]))
        return scale * torch.randn(shape, generator=generator, dtype=dtype,
                                   device=generator.device)


def _plan_from_tables(tables: SolverTables, config: SASolverConfig):
    """Package prebuilt tables as a SamplerPlan (no recompute)."""
    spec = SamplerSpec(
        name="sa",
        n_steps=tables.n_steps,
        ts=tuple(float(t) for t in tables.ts),
        parameterization=tables.parameterization,
        tau=config.tau,
        predictor_order=tables.predictor_order,
        corrector_order=tables.corrector_order,
        mode=config.mode,
        combine=config.combine,
        denoise_final=config.denoise_final,
    )
    statics = multistep_statics(spec, tables.parameterization)
    arrays, host = plan_from_tables(spec, tables)
    return SamplerPlan(spec=spec, arrays=arrays, host=host, statics=statics)


def sample(model_fn, x_T: torch.Tensor, generator: torch.Generator | None,
           tables: SolverTables, config: SASolverConfig, *,
           noise=None) -> torch.Tensor:
    """Run Algorithm 1 with prebuilt ``tables``. (Legacy shim: routes
    through the registry's executor and its compile cache.)"""
    return registry_sample(_plan_from_tables(tables, config), model_fn, x_T,
                           generator, noise=noise)
