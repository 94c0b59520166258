"""Denoiser adapter layer: raw network -> solver-facing model contract.

Every executor consumes ``model_fn(x, t)`` whose output is the plan's
parameterization (x0-prediction for the "data" SA-Solver path,
eps-prediction for the "noise" path). :class:`Denoiser` wraps a network
of any output convention:

- **prediction-type conversion**: ``convert_prediction`` maps any of
  ``eps``/``x0``/``v`` to any other on the solve's device, using the
  schedule's ``alpha_t``/``sigma_t`` at the evaluation time and the
  identities of ``x_t = alpha_t x_0 + sigma_t eps`` and
  ``v = alpha_t eps - sigma_t x_0``;
- **classifier-free guidance**: the cond and uncond branches combine as
  ``(1 - s) * uncond + s * cond``. That form, not ``uncond + s (cond -
  uncond)``, makes scale 1.0 exactly the conditional branch
  (``0 * u + c``), so a guided solve at s = 1 equals the unguided one.
  The two branches run as two network calls here; the reference fuses
  them into one doubled-lane call, which a later slice of the port takes
  over with batched serving.

NFE accounting: one guided evaluation costs two network evaluations
(``SamplerSpec.network_nfe``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .schedules import NoiseSchedule

__all__ = ["PREDICTION_TYPES", "Denoiser", "canonical_prediction",
           "convert_prediction"]

#: canonical prediction-type names (aliases: "data"/"x0", "noise"/"eps")
PREDICTION_TYPES = ("x0", "eps", "v")

_ALIASES = {
    "data": "x0", "x0": "x0",
    "noise": "eps", "eps": "eps", "epsilon": "eps",
    "v": "v", "v_prediction": "v",
}


def canonical_prediction(name: str) -> str:
    """Normalize a prediction-type name ("data"/"x0", "noise"/"eps", "v")."""
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown prediction type {name!r}; one of "
            f"{sorted(set(_ALIASES))}")


def convert_prediction(pred: torch.Tensor, x: torch.Tensor, t, src: str,
                       dst: str, schedule: NoiseSchedule) -> torch.Tensor:
    """Convert a network output between prediction types.

    ``a = alpha_t`` and ``s = sigma_t`` come from the schedule's torch
    functions at ``t`` (a float32 tensor). The operands are promoted to
    the widest of their dtypes and ``t``'s first, so a bfloat16 latent
    converts in float32 as in the reference (PyTorch would otherwise keep
    bfloat16 when a 0-d float32 tensor meets it). The v inversions use the
    general ``1/(a^2 + s^2)`` normalizer so non-VP schedules stay exact.
    """
    src, dst = canonical_prediction(src), canonical_prediction(dst)
    if src == dst:
        return pred
    a = schedule.alpha_d(t)
    s = schedule.sigma_d(t)
    dt = torch.promote_types(torch.promote_types(pred.dtype, x.dtype), a.dtype)
    pred, x = pred.to(dt), x.to(dt)
    if dst == "x0":
        if src == "eps":
            return (x - s * pred) / a
        return (a * x - s * pred) / (a * a + s * s)      # src == "v"
    if dst == "eps":
        if src == "x0":
            return (x - a * pred) / s
        return (s * x + a * pred) / (a * a + s * s)      # src == "v"
    # dst == "v"
    if src == "x0":
        return a * (x - a * pred) / s - s * pred
    return a * pred - s * (x - s * pred) / a             # src == "eps"


@dataclasses.dataclass(frozen=True, eq=False)
class Denoiser:
    """A raw network wrapped into the solver-facing model contract.

    Args:
        network: ``(x, t, cond) -> prediction`` in ``prediction``'s
            convention. Unconditional networks ignore ``cond``.
        schedule: the noise schedule whose ``alpha_t``/``sigma_t`` drive
            the prediction conversion. Must match the plan's.
        prediction: the network's output convention (``"eps"``/``"x0"``/
            ``"v"``; aliases ``"noise"``/``"data"`` accepted).
        guidance: enable classifier-free guidance with the per-call
            ``guidance_scale``; the unconditional branch gets zeros like
            the per-call cond (the null-embedding convention).
    """

    network: Callable[[torch.Tensor, Any, Any], torch.Tensor]
    schedule: NoiseSchedule
    prediction: str = "eps"
    guidance: bool = False

    def __post_init__(self):
        object.__setattr__(
            self, "prediction", canonical_prediction(self.prediction))

    @staticmethod
    def _combine(c_out, u_out, scale):
        s = torch.as_tensor(scale, dtype=c_out.dtype, device=c_out.device)
        # (1-s)*u + s*c: at s == 1.0 this is exactly the cond branch
        return (1.0 - s) * u_out + s * c_out

    def evaluate(self, x: torch.Tensor, t, cond, scale) -> torch.Tensor:
        """One guided (or plain) network evaluation, in ``self.prediction``
        convention."""
        if not self.guidance:
            return self.network(x, t, cond)
        null = None if cond is None else torch.zeros_like(cond)
        c_out = self.network(x, t, cond)
        u_out = self.network(x, t, null)
        return self._combine(c_out, u_out, scale)

    def as_model_fn(self, target: str, cond, scale) -> Callable:
        """Bind to a plan's parameterization and one call's conditioning
        and guidance scale: the ``model_fn(x, t)`` the executors consume."""
        target = canonical_prediction(target)

        def model_fn(x, t):
            raw = self.evaluate(x, t, cond, scale)
            return convert_prediction(raw, x, t, self.prediction, target,
                                      self.schedule)

        return model_fn

    def __repr__(self) -> str:
        return (f"Denoiser(prediction={self.prediction!r}, "
                f"guidance={self.guidance}, schedule={self.schedule!r})")
