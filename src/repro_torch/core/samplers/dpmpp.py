"""DPM-Solver++ multistep (2M/3M) as a deterministic table rule.

Lu et al. 2022 solve the probability-flow ODE in the *data*-prediction
convention with exponential multistep updates. SA-Solver's tau=0 limit
is exactly this integrator, so the family is the multistep core with:

- decay ``sigma_{i+1}/sigma_i`` (the tau=0 data-convention decay),
- predictor/corrector rows ``alpha_{i+1} Int_{-h}^0 e^{u} l_j(u) du``
  over the newest-first log-SNR history nodes,
- a noise track that is identically zero: every tau (``spec.tau`` and
  program tau tracks alike) is mapped to 0 by :meth:`map_taus`, because
  the family is the ODE limit (``tau_inert=True``).

``predictor_order`` 2/3 are the 2M/3M variants. This is the *exact
exponential-Adams* (phi-function) form: at order 2 the second-row
coefficient is ``b_1 = -alpha_{i+1} (h + e^{-h} - 1)/h_prev``, whereas the
official DPM-Solver++ 2M release uses the first-order Taylor split, which
differs at O(h^3). This family matches SA's tau=0 case to float64
round-off, computed through the independent Newton-basis reduction.

Step programs (order and mode tracks stay live; tau tracks are inert)
and PEC/PECE correctors come from
:mod:`repro_torch.core.samplers.multistep` unchanged.
"""

from __future__ import annotations

import numpy as np

from ..coefficients import IntervalContext, TableBuilder, newton_exp_row
from .multistep import make_multistep_family

__all__ = ["DPMppTableBuilder", "FAMILY"]


class DPMppTableBuilder(TableBuilder):
    parameterization = "data"

    def map_taus(self, taus: np.ndarray) -> np.ndarray:
        # the family is the tau=0 ODE limit: every requested tau collapses
        # to 0, so the noise track is identically zero
        return np.zeros_like(taus)

    def decay_noise(self, ctx: IntervalContext) -> tuple[float, float]:
        return ctx.sigmas[ctx.i + 1] / ctx.sigmas[ctx.i], 0.0

    def row(self, ctx: IntervalContext, order: int,
            include_new: bool) -> np.ndarray:
        lam_next = ctx.lams[ctx.i + 1]
        nodes = [0.0] if include_new else []
        nodes.extend(ctx.lams[ctx.i - j] - lam_next for j in range(order))
        return ctx.alpha_next * newton_exp_row(
            np.asarray(nodes), ctx.h, 1.0)


FAMILY = make_multistep_family(
    "dpmpp_multistep", lambda spec: DPMppTableBuilder(), tau_inert=True)
