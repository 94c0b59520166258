"""SEEDS: stochastic exponential derivative-free solvers as a table rule.

Gonzalez et al. 2023 derive exponential multistep SDE solvers in the
*noise*-prediction convention whose per-interval update has exactly the
multistep core's shape: decay the carried state by the alpha ratio,
combine a short history of eps-evaluations with exponentially-weighted
Adams rows, and inject Gaussian noise with the exact Ito variance of the
linear SDE. The family is therefore only this :class:`TableBuilder`;
plan, executor and statics come from
:mod:`repro_torch.core.samplers.multistep`.

Update rule (interval ``t_i -> t_{i+1}``, ``h = lam_{i+1} - lam_i``):

    x_{i+1} = (alpha_{i+1}/alpha_i) x_i
              - sigma_{i+1} (1 + tau^2) sum_j [Int_{-h}^0 e^{-u} l_j(u) du] eps_j
              + sigma_{i+1} tau sqrt(e^{2h} - 1) xi

with per-interval ``tau`` controlling the variance: tau=1 is the
published SEEDS SDE (stage s = ``predictor_order``), and tau=0 drops the
noise track; the rows then reduce to the deterministic exponential
integrator (DPM-Solver-1 at stage 1: ``b_0 = -sigma_{i+1} (e^h - 1)``).
SA-Solver in the noise parameterization is this rule (the paper's
Prop. A.1), computed through a different polynomial-basis reduction
(Newton here, Lagrange there), so the two families' tables agree to
float64 round-off.

The family pins the "noise" model convention: ``spec.parameterization``
is ignored and the denoiser adapter converts any wrapped network to
eps-hat. ``spec.tau``, program tau tracks, step programs and PEC/PECE
correctors work unchanged. The published SEEDS solvers are
predictor-only: near tau=1 a high-order corrector interpolates noisy eps
evaluations with O(1)-weighted alternating rows and amplifies the
injected noise, so prefer ``corrector_order=0`` at large tau.
"""

from __future__ import annotations

import math

import numpy as np

from ..coefficients import IntervalContext, TableBuilder, newton_exp_row
from .multistep import make_multistep_family

__all__ = ["SEEDSTableBuilder", "FAMILY"]


class SEEDSTableBuilder(TableBuilder):
    parameterization = "noise"

    def decay_noise(self, ctx: IntervalContext) -> tuple[float, float]:
        i = ctx.i
        decay = ctx.alphas[i + 1] / ctx.alphas[i]
        # exact Ito variance of the tau-SDE over the interval:
        # sigma_{i+1}^2 * tau^2 * (e^{2h} - 1)
        var = (ctx.tau * ctx.tau) * math.expm1(2.0 * ctx.h)
        noise = ctx.sigma_next * math.sqrt(max(var, 0.0))
        return decay, noise

    def row(self, ctx: IntervalContext, order: int,
            include_new: bool) -> np.ndarray:
        lam_next = ctx.lams[ctx.i + 1]
        nodes = [0.0] if include_new else []
        nodes.extend(ctx.lams[ctx.i - j] - lam_next for j in range(order))
        a_tau = 1.0 + ctx.tau * ctx.tau
        return -ctx.sigma_next * a_tau * newton_exp_row(
            np.asarray(nodes), ctx.h, -1.0)


FAMILY = make_multistep_family("seeds", lambda spec: SEEDSTableBuilder())
