"""Batched candidate evaluation for the program autotuner.

The whole point of searching :class:`~repro_torch.core.programs.StepProgram`
space is the plan/execute invariant: per-interval orders and taus are
zero-padded coefficient-table *data*, so every candidate sharing a mode
pattern (= executor statics) runs through ONE executor. This module turns
that invariant into throughput twice over:

1. **One entry per mode pattern.** Candidates are grouped by ``(executor
   statics, step count, the plan's host flags)``; each group runs through
   one entry of the compile cache (on the card one CUDA graph, captured at
   its first dispatch and replayed after), and the evaluator counts the
   groups it creates in ``stats["compiles"]``. The host flags are the
   cond fallback's per-step PECE flags (host data in the port, part of a
   graph's signature); candidates of one search unit share them, so a
   search's groups are its (statics, step count) pairs.
2. **Many candidates per device dispatch.** Within a group, a chunk of
   candidates runs as ONE candidate-stacked solve
   (:func:`repro_torch.core.samplers.base.stacked_solve`): lane
   ``c * n_seeds + s`` solves candidate c from seed s's initial state and
   step noise under candidate c's own tables, the combines go through the
   lane entries of the combine kernels, and the chunk's ``[chunk]`` scores
   are read back once. Ragged tails are padded by repeating the chunk's
   first candidate (pad scores are dropped), so a fixed chunk width keeps
   one lane count and no new graph.

Programs are width-floored before planning (``program.width``) so every
candidate in a group shares the coefficient tables' row count, which is
what makes the stack rectangular regardless of each candidate's max
order.

The evaluator accounts its spend in **NFE-equivalents**: one candidate
costs ``spec.nfe * n_seeds`` (solver-level model evaluations per solve,
times the seeds averaged into its score). Search budgets are quoted in
the same unit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.programs import StepProgram
from ..core.samplers import SamplerSpec, build_plan, get_family
from ..core.samplers.base import stacked_solve
from .objective import Objective

__all__ = ["ProgramEvaluator"]


def _host_flags(plan) -> tuple:
    return tuple((k, v) for k, v in sorted(plan.arrays.items())
                 if not isinstance(v, torch.Tensor))


class ProgramEvaluator:
    """Scores StepProgram candidates against an objective, batched.

    Args:
        objective: the :class:`~repro_torch.tune.objective.Objective` to
            score against (model + init + step noise + metric).
        family: registered sampler family to tune (``"sa"``, ``"ddim"``,
            ``"edm_stochastic"``, ...).
        nfe: model-evaluation budget per solve; each candidate's step
            count comes from ``SamplerSpec.from_nfe`` under its own mode
            pattern.
        width: coefficient-table row floor applied to every candidate
            (keeps plan-array shapes uniform across orders; set it to
            the search's max order).
        chunk: candidates per device dispatch.
        spec_kw: extra ``SamplerSpec`` fields (schedule, grid,
            parameterization, combine, precision, ...).
    """

    def __init__(self, objective: Objective, *, family: str = "sa",
                 nfe: int = 8, width: int = 3, chunk: int = 16,
                 spec_kw: dict | None = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.objective = objective
        self.family_name = family
        self.family = get_family(family)
        self.nfe = int(nfe)
        self.width = int(width)
        self.chunk = int(chunk)
        self.spec_kw = dict(spec_kw or {})
        self.stats = {"candidates": 0, "pad_evals": 0, "dispatches": 0,
                      "compiles": 0, "nfe_spent": 0}
        self._groups: set = set()  # (statics, n_steps, host flags) seen
        self._ctx: dict = {}       # (convention, fc on) -> (model, x_T)

    # ----------------------------------------------------------- plumbing
    def spec_for(self, program: StepProgram) -> SamplerSpec:
        """The full sampler spec a candidate runs as (width-floored, so
        the search artifact's winner reproduces these exact tables)."""
        if program.width < self.width:
            program = program.replace(width=self.width)
        return SamplerSpec.from_nfe(self.family_name, self.nfe,
                                    program=program, **self.spec_kw)

    def _context(self, spec: SamplerSpec):
        """The model (built once per convention and cache use, so its
        entries stay keyed to one live model) and the ``[n_seeds,
        *shape]`` initial states."""
        conv = self.family.model_convention(spec)
        fc_on = spec.feature_cache is not None
        ctx = self._ctx.get((conv, fc_on))
        if ctx is None:
            schedule = spec.resolve_schedule()
            model = (self.objective.cached_model_fn(conv, schedule)
                     if fc_on else self.objective.model_fn(conv, schedule))
            ctx = (model, self.objective.init(spec))
            self._ctx[(conv, fc_on)] = ctx
        return ctx

    def spec_for_fc(self, tau: float, thresh: float) -> SamplerSpec:
        """The spec a ``(tau, threshold)`` feature-cache candidate runs
        as: the family default order configuration in PECE mode (the
        residual policy reads the free predictor-vs-corrector residual,
        which only PECE produces) with ``("residual", thresh)`` caching.
        No step program: the threshold is tuned against the family's
        stock configuration so the artifact's fc winner composes with
        ANY program at serve time."""
        kw = dict(self.spec_kw)
        kw.update(tau=float(tau), mode="PECE",
                  feature_cache=("residual", float(thresh)))
        return SamplerSpec.from_nfe(self.family_name, self.nfe, **kw)

    # ----------------------------------------------------------- evaluate
    def evaluate(self, programs: Sequence[StepProgram]) -> np.ndarray:
        """Scores aligned with ``programs`` (lower is better; NaN scores
        come back as +inf so unstable candidates lose, never win)."""
        specs = [self.spec_for(p) for p in programs]
        return self._evaluate_specs(specs)

    def evaluate_fc(self, cands: Sequence[tuple]) -> np.ndarray:
        """Scores aligned with ``cands``: ``(tau, thresh)`` pairs run
        through the objective's ``cached_model_fn`` (prediction-reuse /
        split-segment eval), so a loose threshold really does pay its
        staleness cost in the score."""
        specs = [self.spec_for_fc(tau, thresh) for tau, thresh in cands]
        return self._evaluate_specs(specs)

    def _dispatch(self, plans, spec: SamplerSpec) -> np.ndarray:
        """One candidate-stacked solve of ``plans`` (one per candidate)
        and its ``[len(plans)]`` float64 scores: the one read-back."""
        model, x_T = self._context(spec)
        S = self.objective.n_seeds
        C = len(plans)
        reps = (C,) + (1,) * (x_T.dim() - 1)
        noise = self.objective.solve_noise(spec.n_steps)
        x0 = stacked_solve([p for p in plans for _ in range(S)], model,
                           x_T.repeat(reps), noise.repeat(reps + (1,)),
                           lane_group=S)
        x0 = x0.reshape((C, S) + tuple(x0.shape[1:]))
        scores = torch.stack([self.objective.batch_score(x0[c])
                              for c in range(C)])
        return scores.double().cpu().numpy()

    def _evaluate_specs(self, specs: Sequence[SamplerSpec]) -> np.ndarray:
        if not specs:
            return np.zeros((0,), np.float64)
        plans = [build_plan(s) for s in specs]
        groups: dict = {}
        for idx, (spec, plan) in enumerate(zip(specs, plans)):
            gkey = (plan.statics, spec.n_steps, _host_flags(plan))
            groups.setdefault(gkey, []).append(idx)

        scores = np.full(len(specs), np.inf, np.float64)
        for gkey, idxs in groups.items():
            if gkey not in self._groups:
                self._groups.add(gkey)
                self.stats["compiles"] += 1
            for lo in range(0, len(idxs), self.chunk):
                batch = idxs[lo:lo + self.chunk]
                n_pad = self.chunk - len(batch)
                padded = batch + [batch[0]] * n_pad
                out = self._dispatch([plans[i] for i in padded],
                                     specs[batch[0]])
                self.stats["dispatches"] += 1
                self.stats["pad_evals"] += n_pad
                for j, i in enumerate(batch):
                    scores[i] = out[j] if np.isfinite(out[j]) else np.inf
                    self.stats["candidates"] += 1
                    self.stats["nfe_spent"] += (specs[i].nfe
                                                * self.objective.n_seeds)
        return scores

    def cost_of(self, program: StepProgram) -> int:
        """NFE-equivalents one evaluation of ``program`` will spend."""
        return self.spec_for(program).nfe * self.objective.n_seeds

    def cost_of_fc(self, tau: float, thresh: float) -> int:
        """NFE-equivalents one ``(tau, thresh)`` evaluation will spend
        (nominal: accounted at the spec's full NFE even though the
        cache skips model segments, so budgets stay comparable)."""
        return self.spec_for_fc(tau, thresh).nfe * self.objective.n_seeds
