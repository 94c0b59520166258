"""Noise schedules and timestep grids for diffusion SDE/ODE sampling.

Conventions (paper §3):
    forward:  x_t | x_0 ~ N(alpha_t x_0, sigma_t^2 I)
    log-SNR:  lambda_t = log(alpha_t / sigma_t)      (strictly decreasing in t)
    EDM sigma: sigma^EDM_t = sigma_t / alpha_t = exp(-lambda_t)

Sampling runs in *reverse* time: the step grid ``t_0 = T > t_1 > ... > t_M``
so ``lambda`` strictly increases along the solve.

Schedule math comes in two forms: float64 host (numpy) functions, used by
the coefficient engine where the h^s cancellations demand f64, and torch
functions (the ``*_d`` methods) evaluated on the solve's device at the
evaluation time ``t`` (a 0-d or batched tensor) for model conditioning and
prediction-type conversion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

__all__ = [
    "NoiseSchedule",
    "VPLinearSchedule",
    "VPCosineSchedule",
    "VESchedule",
    "EDMSchedule",
    "timestep_grid",
    "get_schedule",
]


class NoiseSchedule:
    """Base class. Subclasses implement log_alpha(t) / log_sigma(t) (numpy,
    float64, vectorized), their torch twins ``log_alpha_d``/``log_sigma_d``,
    and the inverse lambda -> t."""

    # ---- numpy (host, float64) ------------------------------------------
    def log_alpha(self, t):  # pragma: no cover - abstract
        raise NotImplementedError

    def log_sigma(self, t):  # pragma: no cover - abstract
        raise NotImplementedError

    def alpha(self, t):
        return np.exp(self.log_alpha(t))

    def sigma(self, t):
        return np.exp(self.log_sigma(t))

    def lam(self, t):
        return self.log_alpha(t) - self.log_sigma(t)

    def edm_sigma(self, t):
        """sigma_t / alpha_t = exp(-lambda_t)."""
        return np.exp(-self.lam(t))

    def t_of_lam(self, lam):  # pragma: no cover - abstract
        raise NotImplementedError

    def t_of_edm_sigma(self, s):
        s = np.asarray(s, dtype=np.float64)
        return self.t_of_lam(-np.log(s))

    # ---- torch (device) ---------------------------------------------------
    def log_alpha_d(self, t: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def log_sigma_d(self, t: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def alpha_d(self, t):
        return torch.exp(self.log_alpha_d(t))

    def sigma_d(self, t):
        return torch.exp(self.log_sigma_d(t))

    def lam_d(self, t):
        return self.log_alpha_d(t) - self.log_sigma_d(t)

    # ---- defaults ----------------------------------------------------------
    #: default integration span [t_end, t_start]
    t_start: float = 1.0
    t_end: float = 1e-3

    def validate_span(self, t_start: float, t_end: float) -> None:
        """Reject a requested solve span the schedule cannot represent.

        Default: every span is fine. Schedules with a hard usable boundary
        (the cosine schedule's saturation clip) override this to raise a
        targeted error instead of letting grid construction fail later
        with a confusing strictly-decreasing violation."""

    def prior_scale(self, t) -> float:
        """Std of the terminal prior x_T ~ N(0, prior_scale^2 I).

        VP schedules terminate at the unit Gaussian; variance-exploding
        schedules override this (VESchedule returns sigma(t))."""
        return 1.0


@dataclasses.dataclass(frozen=True)
class VPLinearSchedule(NoiseSchedule):
    """DDPM linear-beta VP schedule (continuous form, Song et al. 2021).

    log alpha_t = -t^2 (beta_1 - beta_0)/4 - t beta_0 / 2,   t in [0, 1]
    sigma_t = sqrt(1 - alpha_t^2)
    """

    beta_0: float = 0.1
    beta_1: float = 20.0
    t_start: float = 1.0
    t_end: float = 1e-3

    def log_alpha(self, t):
        t = np.asarray(t, dtype=np.float64)
        return -(t * t) * (self.beta_1 - self.beta_0) / 4.0 - t * self.beta_0 / 2.0

    def log_sigma(self, t):
        la = self.log_alpha(t)
        # log sqrt(1 - e^{2 la}) computed stably
        return 0.5 * np.log(-np.expm1(2.0 * la))

    def t_of_lam(self, lam):
        lam = np.asarray(lam, dtype=np.float64)
        # alpha^2 = sigmoid(2 lam)  =>  log alpha = -0.5 log(1 + e^{-2 lam})
        log_alpha = -0.5 * np.log1p(np.exp(-2.0 * lam))
        # solve (b1-b0)/4 t^2 + b0/2 t + log_alpha = 0 for t >= 0
        A = (self.beta_1 - self.beta_0) / 4.0
        B = self.beta_0 / 2.0
        L = -log_alpha  # >= 0
        return (-B + np.sqrt(B * B + 4.0 * A * L)) / (2.0 * A)

    def log_alpha_d(self, t):
        return -(t * t) * (self.beta_1 - self.beta_0) / 4.0 - t * self.beta_0 / 2.0

    def log_sigma_d(self, t):
        la = self.log_alpha_d(t)
        return 0.5 * torch.log(-torch.expm1(2.0 * la))


@dataclasses.dataclass(frozen=True)
class VPCosineSchedule(NoiseSchedule):
    """iDDPM cosine schedule (Nichol & Dhariwal), continuous form.

    alpha_t = cos(pi/2 * (t + s)/(1 + s)) / cos(pi/2 * s/(1 + s)),
    clipped so that log alpha stays finite near t=1.
    """

    s: float = 0.008
    t_start: float = 0.9946  # standard clip used by DPM-Solver for cosine
    t_end: float = 1e-3

    def validate_span(self, t_start: float, t_end: float) -> None:
        if t_start > self.t_start + 1e-12:
            raise ValueError(
                f"t_start={t_start:g} is beyond the cosine schedule's usable "
                f"span: log(alpha) saturates above t={self.t_start:g} (the "
                f"1e-12 clip), lambda is not invertible there, and a grid "
                f"over that region would collapse to duplicate timesteps. "
                f"Request t_start <= {self.t_start:g}, or construct "
                f"VPCosineSchedule(t_start=...) with a larger clip "
                f"boundary explicitly.")

    def log_alpha(self, t):
        t = np.asarray(t, dtype=np.float64)
        f = np.cos(np.pi / 2.0 * (t + self.s) / (1.0 + self.s))
        f0 = math.cos(math.pi / 2.0 * self.s / (1.0 + self.s))
        return np.log(np.clip(f / f0, 1e-12, None))

    def log_sigma(self, t):
        la = self.log_alpha(t)
        return 0.5 * np.log(-np.expm1(2.0 * np.minimum(la, -1e-12)))

    def t_of_lam(self, lam):
        lam = np.asarray(lam, dtype=np.float64)
        log_alpha = -0.5 * np.log1p(np.exp(-2.0 * lam))
        f0 = math.cos(math.pi / 2.0 * self.s / (1.0 + self.s))
        arg = np.clip(np.exp(log_alpha) * f0, -1.0, 1.0)
        t = (2.0 * (1.0 + self.s) / np.pi) * np.arccos(arg) - self.s
        # The upper end clips to the schedule's own t_start, not 1.0:
        # log_alpha saturates (the 1e-12 clip) as t -> 1, so the inversion
        # quantizes there and a [0, 1] clip would let near-duplicate t's
        # into high-step-count grids. The lower end stays at the formula's
        # domain edge 0.0 so custom-span grids below t_end keep working.
        return np.clip(t, 0.0, self.t_start)

    def log_alpha_d(self, t):
        f = torch.cos(math.pi / 2.0 * (t + self.s) / (1.0 + self.s))
        f0 = math.cos(math.pi / 2.0 * self.s / (1.0 + self.s))
        return torch.log(torch.clamp(f / f0, min=1e-12))

    def log_sigma_d(self, t):
        la = self.log_alpha_d(t)
        return 0.5 * torch.log(-torch.expm1(2.0 * torch.clamp(la, max=-1e-12)))


@dataclasses.dataclass(frozen=True)
class VESchedule(NoiseSchedule):
    """Variance-exploding / EDM-style schedule: alpha = 1, sigma_t = t.

    Time *is* the EDM sigma (the paper's EDM baseline-VE experiments).
    """

    sigma_min: float = 0.02
    sigma_max: float = 80.0

    @property
    def t_start(self):  # type: ignore[override]
        return self.sigma_max

    @property
    def t_end(self):  # type: ignore[override]
        return self.sigma_min

    def log_alpha(self, t):
        return np.zeros_like(np.asarray(t, dtype=np.float64))

    def log_sigma(self, t):
        return np.log(np.asarray(t, dtype=np.float64))

    def t_of_lam(self, lam):
        return np.exp(-np.asarray(lam, dtype=np.float64))

    def log_alpha_d(self, t):
        return torch.zeros_like(t)

    def log_sigma_d(self, t):
        return torch.log(t)

    def prior_scale(self, t) -> float:
        return float(self.sigma(t))


# EDM is the VE schedule plus Karras preconditioning at the model boundary;
# for solver purposes they are identical.
EDMSchedule = VESchedule


def timestep_grid(
    schedule: NoiseSchedule,
    n_steps: int,
    *,
    kind: str = "logsnr",
    t_start: float | None = None,
    t_end: float | None = None,
    rho: float = 7.0,
) -> np.ndarray:
    """Return ``t_0 > t_1 > ... > t_M`` (M = n_steps), float64.

    kind:
      "time"     uniform in t
      "logsnr"   uniform in lambda (log-SNR)           [paper's LDM setting]
      "karras"   uniform in sigma_EDM^{1/rho}          [paper's EDM setting]
    """
    t0 = float(schedule.t_start if t_start is None else t_start)
    t1 = float(schedule.t_end if t_end is None else t_end)
    if not t0 > t1:
        raise ValueError(f"need t_start > t_end, got {t0} <= {t1}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    schedule.validate_span(t0, t1)
    if kind == "time":
        ts = np.linspace(t0, t1, n_steps + 1, dtype=np.float64)
    elif kind == "logsnr":
        l0, l1 = float(schedule.lam(t0)), float(schedule.lam(t1))
        lams = np.linspace(l0, l1, n_steps + 1, dtype=np.float64)
        ts = schedule.t_of_lam(lams)
        ts[0], ts[-1] = t0, t1  # kill inverse round-off at the ends
    elif kind == "karras":
        s0, s1 = float(schedule.edm_sigma(t0)), float(schedule.edm_sigma(t1))
        grid = np.linspace(s0 ** (1.0 / rho), s1 ** (1.0 / rho), n_steps + 1)
        ts = schedule.t_of_edm_sigma(grid ** rho)
        ts[0], ts[-1] = t0, t1
    else:
        raise ValueError(f"unknown grid kind: {kind!r}")
    if not np.all(np.diff(ts) < 0):
        raise ValueError("timestep grid must be strictly decreasing")
    return ts


_REGISTRY: dict[str, Callable[[], NoiseSchedule]] = {
    "vp_linear": VPLinearSchedule,
    "vp_cosine": VPCosineSchedule,
    "ve": VESchedule,
    "edm": VESchedule,
}


def get_schedule(name: str, **kwargs) -> NoiseSchedule:
    try:
        return _REGISTRY[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown schedule {name!r}; have {sorted(_REGISTRY)}")
