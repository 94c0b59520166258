"""repro_torch.tune — solver-program autotuner.

Searches :class:`~repro_torch.core.programs.StepProgram` space (per-interval
predictor/corrector order, P/PEC/PECE mode, tau) against a pluggable
objective, exploiting the plan/execute invariant that order/tau tracks
are table *data*: every candidate sharing a mode pattern reuses ONE
compile-cache entry (on the card one CUDA graph), and a chunk of
candidates runs as one candidate-stacked solve, each lane under its own
tables, through the lane entries of the combine kernels.

::

    presets (warm starts)  ──▶  one unit per mode pattern   (outer loop;
         │                      = one entry each)            the ONLY
         ▼                                                   new graphs
    coordinate descent  ──▶  all single-coordinate order/tau
         │                   neighbours, batched per dispatch
         ▼
    evolutionary refinement ──▶ tau tracks ~ N(mean, sigma),
         │                      elites update mean/sigma
         ▼
    JSON artifact: config echo, PCG64 RNG state, unit cursor,
    eval history, best program  — checkpoint/resume at unit
    boundaries; budget in NFE-equivalents (nfe x n_seeds per
    candidate, cached duplicates free)

The search itself (:mod:`.search`) and the artifact format are the
reference's, so each package reads the other's artifacts.

Quickstart (on the card; ``device="cpu"`` runs on the CPU)::

    from repro_torch.tune import SearchConfig, run_search

    result = run_search(SearchConfig(nfe=8, budget=4000, seed=0),
                        artifact="artifacts/tune_nfe8.json")
    print(result.best_score, result.best_program)

The winner closes the loop into serving as a quality tier::

    from repro_torch.serve import QualityTiers, ServeEngine

    tiers = QualityTiers.from_artifact("artifacts/tune_nfe8.json")
    engine = ServeEngine(model_fn, tiers=tiers)
    engine.submit(None, shape=(256, 2), quality_tier="best")

Driver: ``python -m repro_torch.launch.tune`` (CLI with ``--resume``).
"""

from .evaluate import ProgramEvaluator
from .objective import CallableObjective, GMMObjective, Objective
from .search import (SearchConfig, SearchResult, best_program,
                     default_presets, load_state, run_search, save_state,
                     spec_from_state)

__all__ = [
    "CallableObjective",
    "GMMObjective",
    "Objective",
    "ProgramEvaluator",
    "SearchConfig",
    "SearchResult",
    "best_program",
    "default_presets",
    "load_state",
    "run_search",
    "save_state",
    "spec_from_state",
]
