"""tau(t) stochasticity schedules (paper §4, §6.3, Appendix E).

The paper uses either a constant tau or a piecewise-constant tau that is a
constant value inside an EDM-sigma band (band_lo, band_hi] and zero outside
(Appendix E: CIFAR10 band (0.05, 1], ImageNet64 band (0.05, 50]).

The coefficient engine (coefficients.py) assumes tau is constant on each
solver interval [t_{i+1}, t_i], so the schedule is evaluated once per
interval. For the banded schedule, band membership is decided at the
interval's *source* grid point t_i: the band edges snap to the step grid,
as in the paper's own discrete runs, and the band is half-open.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .schedules import NoiseSchedule

__all__ = ["TauSchedule", "ConstantTau", "BandedTau", "DDIMEtaTau"]


class TauSchedule:
    def on_intervals(self, schedule: NoiseSchedule, ts: np.ndarray) -> np.ndarray:
        """tau value for each interval [t_{i+1}, t_i]; shape [len(ts)-1]."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantTau(TauSchedule):
    tau: float = 1.0

    def on_intervals(self, schedule, ts):
        return np.full(len(ts) - 1, float(self.tau), dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class BandedTau(TauSchedule):
    """tau = value when band_lo < sigma_EDM(t_i) <= band_hi else 0.

    Membership is decided at each interval's source grid point ``t_i``
    (the higher-noise end in reverse time), so an interval is wholly in
    or wholly out of the band.
    """

    tau: float = 1.0
    band_lo: float = 0.05
    band_hi: float = 1.0

    def on_intervals(self, schedule, ts):
        ts = np.asarray(ts, dtype=np.float64)
        sig = np.exp(-schedule.lam(ts))[:-1]  # sigma_EDM at each source t_i
        # half-open membership with the edges snapped at relative float
        # tolerance: sigma is reconstructed through exp(-lambda), so a grid
        # point sitting exactly on an edge lands within ~1 ulp of it
        lo = self.band_lo * (1.0 + 1e-12)
        hi = self.band_hi * (1.0 + 1e-12)
        inside = (sig > lo) & (sig <= hi)
        return np.where(inside, float(self.tau), 0.0)


@dataclasses.dataclass(frozen=True)
class DDIMEtaTau(TauSchedule):
    """The piecewise-constant tau_eta of Corollary 5.3: for a given DDIM eta,
    the per-interval tau that makes the 1-step SA-Predictor coincide with
    DDIM-eta.

        tau_i^2 = log(1 - eta^2/sigma_{t_i}^2 (1 - alpha_{t_i}^2/alpha_{t_{i+1}}^2))
                  / (-2 (lambda_{t_{i+1}} - lambda_{t_i}))
    """

    eta: float = 1.0

    def on_intervals(self, schedule, ts):
        ts = np.asarray(ts, dtype=np.float64)
        a = schedule.alpha(ts)
        s = schedule.sigma(ts)
        lam = schedule.lam(ts)
        a_i, a_ip1 = a[:-1], a[1:]
        s_i = s[:-1]
        h = lam[1:] - lam[:-1]  # > 0
        inner = 1.0 - (self.eta**2 / s_i**2) * (1.0 - a_i**2 / a_ip1**2)
        inner = np.clip(inner, 1e-300, None)
        tau2 = np.log(inner) / (-2.0 * h)
        return np.sqrt(np.clip(tau2, 0.0, None))
