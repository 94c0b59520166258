"""Analytic diffusion oracle: Gaussian-mixture data with closed-form scores.

For p_0 = sum_k w_k N(mu_k, diag(s_k^2)) the marginal at time t is
p_t = sum_k w_k N(alpha_t mu_k, alpha_t^2 diag(s_k^2) + sigma_t^2 I), so the
exact data/noise prediction model is available in closed form and a
solver's error is the only error in a solve against it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .schedules import NoiseSchedule

__all__ = ["GMM", "gaussian_oracle", "perturb_model"]


@dataclasses.dataclass(frozen=True)
class GMM:
    """Gaussian mixture in R^d with diagonal covariances (numpy f64 on the
    host; evaluated in float32 on the device of the input, from one copy
    per device made at the first evaluation there, so a later one copies
    nothing from the host and can be captured in a CUDA graph)."""

    weights: np.ndarray  # [K]
    means: np.ndarray    # [K, d]
    stds: np.ndarray     # [K, d]
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                         compare=False)

    @staticmethod
    def default_2d() -> "GMM":
        means = np.array(
            [[-2.0, -2.0], [2.0, 2.0], [-2.0, 2.0], [2.0, -2.0], [0.0, 0.0]]
        )
        return GMM(
            weights=np.array([0.2, 0.2, 0.2, 0.2, 0.2]),
            means=means,
            stds=np.full((5, 2), 0.35),
        )

    @staticmethod
    def single(mean, std) -> "GMM":
        mean = np.atleast_1d(np.asarray(mean, dtype=np.float64))
        std = np.full(mean.shape, np.asarray(std, dtype=np.float64))
        return GMM(np.array([1.0]), mean[None], std[None])

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def _t(self, name: str, device) -> torch.Tensor:
        """Field ``name`` as float32 on ``device`` (copied once)."""
        device = torch.device(device)
        key = (name, device)
        t = self._on_device.get(key)
        if t is None:
            t = self._on_device[key] = torch.as_tensor(
                getattr(self, name), dtype=torch.float32, device=device)
        return t

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """n exact draws on ``generator``'s device."""
        dev = generator.device
        comp = torch.multinomial(self._t("weights", dev), n,
                                 replacement=True, generator=generator)
        z = torch.randn((n, self.dim), generator=generator, device=dev)
        return self._t("means", dev)[comp] + self._t("stds", dev)[comp] * z

    # ---- exact posteriors under the diffusion ---------------------------
    def x0_prediction(self, schedule: NoiseSchedule, x: torch.Tensor, t,
                      shift=None) -> torch.Tensor:
        """E[x_0 | x_t = x], the ideal data-prediction model. ``shift``
        (broadcastable against the [K, d] means) translates every
        component: an exact conditional family for guidance tests."""
        a = schedule.alpha_d(t)
        s = schedule.sigma_d(t)
        dev = x.device
        mu = self._t("means", dev)               # [K, d]
        if shift is not None:
            mu = mu + shift
        stds = self._t("stds", dev)
        var_k = (a * stds) ** 2 + s ** 2            # [K, d]
        logw = torch.log(self._t("weights", dev))
        diff = x[..., None, :] - a * mu             # [..., K, d]
        logp = logw - 0.5 * torch.sum(
            diff ** 2 / var_k + torch.log(2 * math.pi * var_k), dim=-1)
        r = torch.softmax(logp, dim=-1)             # responsibilities
        # E[x0 | x, k] = mu_k + (a s_k^2 / var_k) (x - a mu_k)  (per-dim)
        gain = a * stds ** 2 / var_k
        e_x0_k = mu + gain * diff
        return torch.sum(r[..., None] * e_x0_k, dim=-2)

    def eps_prediction(self, schedule, x, t, shift=None):
        a = schedule.alpha_d(t)
        s = schedule.sigma_d(t)
        return (x - a * self.x0_prediction(schedule, x, t, shift)) / s

    def v_prediction(self, schedule, x, t, shift=None):
        """v = alpha_t eps - sigma_t x_0, from the same exact posterior."""
        a = schedule.alpha_d(t)
        s = schedule.sigma_d(t)
        x0 = self.x0_prediction(schedule, x, t, shift)
        eps = (x - a * x0) / s
        return a * eps - s * x0

    def model_fn(self, schedule: NoiseSchedule, parameterization: str = "data"):
        """Ideal unconditional ``(x, t)`` model in any prediction type."""
        fn = {
            "data": self.x0_prediction, "x0": self.x0_prediction,
            "noise": self.eps_prediction, "eps": self.eps_prediction,
            "v": self.v_prediction,
        }[parameterization]
        return lambda x, t: fn(schedule, x, t)


def gaussian_oracle(schedule: NoiseSchedule, mean=0.0, std=1.0, dim: int = 2):
    """A single-Gaussian GMM (solver errors are exactly the discretization
    error)."""
    mu = np.full((dim,), float(mean))
    return GMM.single(mu, float(std))


def perturb_model(model_fn, dim: int, delta: float, seed: int = 0,
                  n_features: int = 32):
    """Emulate an inaccurate learned model (paper §6.5 / Appendix C).

    Adds a fixed smooth random-feature field ``delta * f(x)`` to the
    prediction; f has zero mean over x and unit RMS, so delta is the RMS
    prediction error. The features come from ``numpy``'s generator of
    ``seed`` (the reference's draws), held as float32 with one copy per
    device made at the first evaluation there (a CUDA graph can capture a
    later one).
    """
    rng = np.random.default_rng(seed)
    host = (rng.normal(size=(dim, n_features)) / np.sqrt(dim),
            rng.uniform(0, 2 * np.pi, size=(n_features,)),
            rng.normal(size=(n_features, dim)) * np.sqrt(2.0 / n_features))
    on_device: dict = {}

    def wrapped(x, t):
        consts = on_device.get(x.device)
        if consts is None:
            consts = on_device[x.device] = tuple(
                torch.as_tensor(a, dtype=torch.float32, device=x.device)
                for a in host)
        W, b, V = consts
        feat = torch.cos(x.to(torch.float32) @ W + b)
        return model_fn(x, t) + delta * (feat @ V)

    return wrapped
