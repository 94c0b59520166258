"""Black-box search over StepProgram space, checkpointable and budgeted.

Search structure (cheap-to-expensive, mirroring what recompiles):

- **Outer loop — mode patterns.** Each warm-start preset (stamped at the
  NFE budget) contributes one *unit*: its P/PEC/PECE pattern. The mode
  pattern is the only trace-relevant part of a program, so the outer
  loop is exactly the compile loop — everything inside a unit reuses one
  executor (asserted via :class:`ProgramEvaluator` compile stats).
- **Coordinate descent** inside a unit: all single-coordinate neighbours
  of the incumbent (predictor/corrector order values, tau grid values)
  are evaluated in batched dispatches; the best strict improver becomes
  the new incumbent, for up to ``cd_passes`` rounds. Corrector-order
  proposals never include 0 and predictor proposals respect the warm-up
  clamp ``min(i+1, max_order)`` — proposals that would change the mode
  pattern (a recompile) or the effective tables (a wasted eval) are
  excluded at generation time.
- **Evolutionary refinement** (CMA-ES-style, diagonal): a population of
  tau tracks drawn from ``N(mean, diag(sigma^2))`` around the incumbent
  (plus occasional order point-mutations), elites update mean/sigma each
  generation. This explores off-grid tau values coordinate descent's
  fixed grid cannot reach.
- **Feature-cache unit** (when ``fc_thresholds`` is set): one final unit
  sweeps the residual-threshold x tau plane (grid, then log-threshold
  evolutionary refinement) against the objective's cache-capable model.
  Quality alone is a DEGENERATE objective for a threshold — smaller is
  always at least as good — so the winner is the *largest* threshold
  whose score stays within ``fc_slack`` of the program winner's (the
  anchor): the cheapest cache setting that is still quality-equivalent.
  It lands in ``state["best_fc"]`` beside (never instead of) the
  program winner.

Family capabilities come from the registry: families without
``full_programs`` search only the tau track, and ``tau_inert`` families
(deterministic ODE limits like ``dpmpp_multistep``) skip tau moves
entirely — their builders zero the tau track, so tau proposals would all
alias one table set.

Budget is quoted in **NFE-equivalents** (``spec.nfe * n_seeds`` per
candidate); duplicate candidates are served from the eval cache and cost
nothing. Search state — config echo, RNG state, unit cursor, full eval
history, best-so-far — round-trips through a JSON artifact
(:func:`save_state` / :func:`load_state`), checkpointed at every unit
boundary; resuming an interrupted run replays bit-identically to the
uninterrupted one (the RNG is a serialized numpy ``PCG64``). Serving
loads the winner straight from the artifact
(:func:`repro_torch.serve.tiers.QualityTiers.from_artifact`).

The module is the reference's (``repro.tune.search``) with its imports
moved to the port and a ``device`` for the default objective: the same
numpy ``PCG64`` stream, the same candidate order for the same scores,
and the same artifact format (``_VERSION``), so each package reads the
other's artifacts.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable

import numpy as np

from ..core.programs import StepProgram, program_preset_for_nfe
from ..core.samplers import SamplerSpec, get_family
from .evaluate import ProgramEvaluator
from .objective import GMMObjective, Objective

__all__ = ["SearchConfig", "SearchResult", "default_presets", "run_search",
           "save_state", "load_state", "best_program", "spec_from_state",
           "fc_spec_from_state"]

_VERSION = 1


def default_presets(family: str) -> tuple[str, ...]:
    """Warm-start presets (= the mode patterns the outer loop visits).
    Families that consume full step programs (``full_programs`` in the
    registry — the multistep core) get the structured presets; tau-only
    baselines keep uniform-mode presets, since their executors have no
    P/PEC/PECE structure to vary."""
    if get_family(family).full_programs:
        return ("nfe8-gmm", "predictor-tail", "tau-anneal")
    return ("tau-anneal", "constant")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Everything that determines a search run (and is echoed into the
    artifact, so a resumed run cannot silently diverge)."""

    family: str = "sa"
    nfe: int = 8
    #: total spend ceiling in NFE-equivalents (spec.nfe * n_seeds per
    #: candidate; cached duplicates are free)
    budget: int = 4000
    seed: int = 0
    #: warm-start preset names; () -> :func:`default_presets`
    presets: tuple[str, ...] = ()
    #: tau used to stamp the presets
    tau: float = 1.0
    max_order: int = 3
    #: the coordinate-descent tau grid
    tau_values: tuple[float, ...] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0, 1.4)
    cd_passes: int = 2
    evo_population: int = 12
    evo_generations: int = 3
    evo_elite: int = 4
    #: initial evo sigma (per tau coordinate)
    sigma0: float = 0.25
    #: residual feature-cache thresholds to sweep in a final search unit;
    #: () disables the unit (ROADMAP: the cache threshold joins the
    #: search space alongside tau)
    fc_thresholds: tuple[float, ...] = ()
    #: fc winner = LARGEST threshold scoring within ``fc_slack *
    #: anchor`` (anchor = the program winner's score) — the selection
    #: rule that keeps a pure-quality objective from degenerating to
    #: threshold -> 0
    fc_slack: float = 1.25
    # objective knobs (used when no explicit objective is passed)
    n_samples: int = 512
    n_seeds: int = 4
    n_proj: int = 64
    #: candidates per device dispatch
    chunk: int = 16
    #: extra SamplerSpec fields (schedule, grid, parameterization, ...)
    spec_kw: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "presets", tuple(self.presets))
        object.__setattr__(self, "tau_values",
                          tuple(float(v) for v in self.tau_values))
        object.__setattr__(self, "fc_thresholds",
                          tuple(float(v) for v in self.fc_thresholds))
        object.__setattr__(self, "spec_kw", dict(self.spec_kw))

    def resolved_presets(self) -> tuple[str, ...]:
        return self.presets or default_presets(self.family)

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_obj(cls, obj: dict) -> "SearchConfig":
        kw = dict(obj)
        for f in ("presets", "tau_values", "fc_thresholds"):
            if f in kw:
                kw[f] = tuple(kw[f])
        return cls(**kw)


@dataclasses.dataclass
class SearchResult:
    best_program: StepProgram | None
    best_score: float
    state: dict
    #: evaluator counters: candidates, dispatches, compiles, pad_evals
    stats: dict
    #: every unit has been searched
    done: bool
    #: the NFE budget ran out
    exhausted: bool
    #: feature-cache winner ``{"tau", "thresh", "score", "anchor",
    #: "slack"}`` from the fc unit, or None when disabled / not reached
    best_fc: dict | None = None


# ----------------------------------------------------------------- artifact
def save_state(path: str, state: dict) -> None:
    """Atomic JSON checkpoint (tmp + replace, so an interrupt mid-write
    never corrupts a resumable artifact)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_state(path: str) -> dict:
    with open(path) as f:
        state = json.load(f)
    if state.get("version") != _VERSION:
        raise ValueError(
            f"search artifact {path!r} has version "
            f"{state.get('version')!r}; this build reads {_VERSION}")
    return state


def best_program(state: dict) -> tuple[StepProgram, float]:
    """The winner recorded in a search state/artifact."""
    best = state.get("best")
    if not best:
        raise ValueError("search artifact records no evaluated program")
    return StepProgram.from_json(best["program"]), float(best["score"])


def _fresh_state(config: SearchConfig) -> dict:
    rng = np.random.default_rng(config.seed)
    return {
        "version": _VERSION,
        "config": config.to_obj(),
        "rng": rng.bit_generator.state,
        "unit": 0,
        "budget_spent": 0,
        "history": [],
        "best": None,
        "best_fc": None,
    }


# ------------------------------------------------------------------- search
def _explicit(program: StepProgram, evaluator: ProgramEvaluator,
              tau_only: bool) -> StepProgram:
    """Normalize a warm start to explicit per-interval tuple tracks (the
    search's coordinate space) at its own step count. Tau-only families
    keep orders/mode scalar — their planners reject anything else."""
    spec = evaluator.spec_for(program)
    M = spec.n_steps
    rp = program.resolve(spec.resolve_schedule(), spec.grid_ts())
    taus = tuple(round(float(v), 4) for v in rp.taus)
    width = max(program.width, evaluator.width)
    if tau_only:
        return StepProgram(tau=taus, width=width)
    flags = program.mode_flags(M)
    modes = tuple("PECE" if pe else ("PEC" if uc else "P")
                  for uc, pe in flags)
    return StepProgram(
        predictor_order=tuple(int(v) for v in rp.p_orders),
        corrector_order=tuple(int(v) for v in rp.c_orders),
        mode=modes, tau=taus, width=width)


def _neighbors(prog: StepProgram, config: SearchConfig,
               tau_only: bool, tau_inert: bool = False) -> list[StepProgram]:
    """All single-coordinate variants that keep the mode pattern (and
    therefore the compiled executor) fixed. ``tau_inert`` families skip
    tau proposals — their builders zero the tau track, so every grid
    value aliases the same tables."""
    out: list[StepProgram] = []
    M = len(prog.tau)
    for i in range(M):
        if not tau_only:
            # predictor order: warm-up clamp makes values > i+1 alias
            # the same tables — don't waste evaluations on them
            for v in range(1, min(i + 1, config.max_order) + 1):
                if v != prog.predictor_order[i]:
                    t = list(prog.predictor_order)
                    t[i] = v
                    out.append(prog.replace(predictor_order=tuple(t)))
            # corrector order: NEVER 0 — that flips the step to
            # predictor-only, changing the mode pattern (a recompile);
            # mode changes are the outer loop's business
            if prog.corrector_order[i] > 0:
                for v in range(1, config.max_order + 1):
                    if v != prog.corrector_order[i]:
                        t = list(prog.corrector_order)
                        t[i] = v
                        out.append(prog.replace(corrector_order=tuple(t)))
        if tau_inert:
            continue
        for tv in config.tau_values:
            if abs(tv - prog.tau[i]) > 1e-9:
                t = list(prog.tau)
                t[i] = round(float(tv), 4)
                out.append(prog.replace(tau=tuple(t)))
    return out


def _fc_key(tau: float, thresh: float) -> str:
    """Eval-cache key of a feature-cache candidate (the fc analogue of
    ``StepProgram.to_json``)."""
    return json.dumps({"fc": [round(float(tau), 6), float(thresh)]})


class _Session:
    """One run_search invocation: evaluator + eval cache + budget + log."""

    def __init__(self, config, objective, state, log):
        self.config = config
        self.state = state
        self.log = log or (lambda msg: None)
        self.objective = objective
        self.evaluator = ProgramEvaluator(
            objective, family=config.family, nfe=config.nfe,
            width=config.max_order, chunk=config.chunk,
            spec_kw=config.spec_kw)
        fam = get_family(config.family)
        self.tau_only = not fam.full_programs
        self.tau_inert = fam.tau_inert
        # dedup cache, rebuilt from history so resumes never re-spend;
        # history holds two entry kinds (program units and the fc unit)
        self.seen: dict[str, float] = {}
        for h in state["history"]:
            if "fc" in h:
                k = _fc_key(h["fc"]["tau"], h["fc"]["thresh"])
            else:
                k = StepProgram.from_json(h["program"]).to_json()
            self.seen[k] = float(h["score"])
        self.exhausted = False

    def evaluate(self, cands: list[StepProgram]) -> list[tuple]:
        """(program, score) for every candidate the budget allows; cached
        duplicates are free. Sets ``exhausted`` when the budget gate
        closes."""
        fresh, out = [], []
        for p in cands:
            k = p.to_json()
            if k in self.seen:
                out.append((p, self.seen[k]))
            else:
                fresh.append(p)
        kept = []
        for p in fresh:
            cost = self.evaluator.cost_of(p)
            if self.state["budget_spent"] + cost > self.config.budget:
                self.exhausted = True
                break
            self.state["budget_spent"] += cost
            kept.append(p)
        if kept:
            scores = self.evaluator.evaluate(kept)
            best = self.state["best"]
            for p, s in zip(kept, scores):
                s = float(s)
                self.seen[p.to_json()] = s
                self.state["history"].append({
                    "program": json.loads(p.to_json()), "score": s,
                    "nfe": self.evaluator.spec_for(p).nfe})
                if np.isfinite(s) and (best is None or s < best["score"]):
                    best = {"program": json.loads(p.to_json()), "score": s}
            self.state["best"] = best
            out.extend(zip(kept, [float(s) for s in scores]))
        return out

    def evaluate_fc(self, cands: list[tuple]) -> list[tuple]:
        """(cand, score) for ``(tau, thresh)`` candidates, budgeted and
        deduped exactly like program candidates — fc scores go to the
        shared history (as ``{"fc": ...}`` entries), never to
        ``state["best"]``: the fc winner has its own slack-based rule."""
        fresh, out = [], []
        claimed = set()
        for c in cands:
            k = _fc_key(*c)
            if k in self.seen:
                out.append((c, self.seen[k]))
            elif k not in claimed:
                claimed.add(k)
                fresh.append((k, c))
        kept = []
        for k, c in fresh:
            cost = self.evaluator.cost_of_fc(*c)
            if self.state["budget_spent"] + cost > self.config.budget:
                self.exhausted = True
                break
            self.state["budget_spent"] += cost
            kept.append((k, c))
        if kept:
            scores = self.evaluator.evaluate_fc([c for _, c in kept])
            for (k, c), s in zip(kept, scores):
                s = float(s)
                self.seen[k] = s
                self.state["history"].append({
                    "fc": {"tau": float(c[0]), "thresh": float(c[1])},
                    "score": s, "nfe": self.config.nfe})
                out.append((c, s))
        return out

    # -------------------------------------------------------------- phases
    def search_unit(self, warm: StepProgram, rng: np.random.Generator):
        config = self.config
        incumbent = _explicit(warm, self.evaluator, self.tau_only)
        res = self.evaluate([incumbent])
        if not res:
            return
        inc_score = dict((p.to_json(), s) for p, s in res)[incumbent.to_json()]

        for _ in range(config.cd_passes):
            res = self.evaluate(_neighbors(incumbent, config, self.tau_only,
                                           self.tau_inert))
            if not res:
                break
            p, s = min(res, key=lambda r: r[1])
            if s < inc_score - 1e-12:
                incumbent, inc_score = p, s
                self.log(f"  cd: {s:.5f}")
            else:
                break

        M = len(incumbent.tau)
        mean = np.asarray(incumbent.tau, np.float64)
        sigma = np.full(M, config.sigma0)
        tau_hi = max(config.tau_values)
        # tau-inert families have no tau dimension to explore: evo
        # degenerates to order point-mutations, made unconditional so the
        # population is not all-duplicates of the incumbent
        mut_p = 1.0 if self.tau_inert else 0.3
        for g in range(config.evo_generations):
            pop = []
            for _ in range(config.evo_population):
                if self.tau_inert:
                    cand = incumbent
                else:
                    taus = np.clip(rng.normal(mean, sigma), 0.0, tau_hi)
                    cand = incumbent.replace(
                        tau=tuple(round(float(t), 4) for t in taus))
                if not self.tau_only and rng.random() < mut_p:
                    i = int(rng.integers(M))
                    track = list(cand.predictor_order)
                    track[i] = int(rng.integers(1, config.max_order + 1))
                    cand = cand.replace(predictor_order=tuple(track))
                pop.append(cand)
            res = self.evaluate(pop)
            if not res:
                break
            res.append((incumbent, inc_score))
            res.sort(key=lambda r: r[1])
            p, s = res[0]
            if s < inc_score:
                incumbent, inc_score = p, s
                self.log(f"  evo gen {g}: {s:.5f}")
            elite = np.asarray([list(r[0].tau) for r
                                in res[:config.evo_elite]], np.float64)
            mean = elite.mean(axis=0)
            sigma = np.maximum(elite.std(axis=0), 0.02) * 0.85

    def search_fc_unit(self, rng: np.random.Generator):
        """The feature-cache unit: sweep the (tau, residual-threshold)
        plane, refine the threshold evolutionarily in log-space, then
        pick by the slack rule — the LARGEST threshold whose score stays
        within ``fc_slack`` of the program winner's (pure quality is
        degenerate for a threshold: smaller always scores at least as
        well, so argmin would pin the cache permanently on)."""
        config = self.config
        taus = (0.0,) if self.tau_inert else config.tau_values
        grid = [(round(float(t), 4), float(th))
                for t in taus for th in config.fc_thresholds]
        res = self.evaluate_fc(grid)
        if not res:
            return
        (bt, bth), bs = min(res, key=lambda r: r[1])

        tau_hi = max(config.tau_values)
        for g in range(config.evo_generations):
            pop = []
            for _ in range(config.evo_population):
                th = float(10.0 ** np.clip(
                    rng.normal(np.log10(max(bth, 1e-12)), 0.3), -9.0, 4.0))
                t = bt if self.tau_inert else float(np.clip(
                    rng.normal(bt, config.sigma0), 0.0, tau_hi))
                pop.append((round(t, 4), float(f"{th:.6g}")))
            batch = self.evaluate_fc(pop)
            if not batch:
                break
            res.extend(batch)
            (ct, cth), cs = min(batch, key=lambda r: r[1])
            if cs < bs:
                (bt, bth), bs = (ct, cth), cs
                self.log(f"  fc evo gen {g}: {cs:.5f}")

        finite = [(c, s) for c, s in res if np.isfinite(s)]
        if not finite:
            return
        best = self.state["best"]
        anchor = float(best["score"]) if best else bs
        within = [(c, s) for c, s in finite
                  if s <= config.fc_slack * anchor]
        if within:
            # largest threshold first; break threshold ties on score
            (t, th), s = max(within, key=lambda r: (r[0][1], -r[1]))
        else:
            (t, th), s = min(finite, key=lambda r: r[1])
        self.state["best_fc"] = {
            "tau": float(t), "thresh": float(th), "score": float(s),
            "anchor": anchor, "slack": float(config.fc_slack)}
        self.log(f"  fc winner: thresh={th:g} tau={t:g} score={s:.5f} "
                 f"(anchor {anchor:.5f}, slack {config.fc_slack:g})")


def run_search(config: SearchConfig | None = None, *,
               objective: Objective | None = None,
               state: dict | None = None,
               artifact: str | None = None, resume: bool = False,
               max_units: int | None = None,
               log: Callable[[str], None] | None = None,
               device="cuda") -> SearchResult:
    """Run (or resume) a program search.

    Args:
        config: search configuration; ignored when resuming (the
            artifact's echoed config wins, so a resume cannot diverge).
        objective: scoring objective; defaults to :class:`GMMObjective`
            built from the config's ``n_samples``/``n_seeds``/``n_proj``
            and ``seed``. A custom objective must be re-passed on resume.
        state: in-memory state to continue from (alternative to
            ``artifact`` + ``resume``).
        artifact: JSON checkpoint path — written at every unit boundary.
        resume: load ``artifact`` as the starting state if it exists.
        max_units: stop after this many units this call (the state stays
            resumable; used to split long searches across invocations).
        log: optional progress sink (e.g. ``print``).
        device: where the default objective solves (the card unless the
            caller asks for the CPU; a passed objective keeps its own).
    """
    if resume and artifact and os.path.exists(artifact):
        state = load_state(artifact)
    if state is not None:
        config = SearchConfig.from_obj(state["config"])
    elif config is None:
        config = SearchConfig()
    if state is None:
        state = _fresh_state(config)
    if objective is None:
        objective = GMMObjective(n_samples=config.n_samples,
                                 n_seeds=config.n_seeds,
                                 n_proj=config.n_proj, seed=config.seed,
                                 device=device)

    session = _Session(config, objective, state, log)
    rng = np.random.default_rng(config.seed)
    rng.bit_generator.state = state["rng"]

    presets = config.resolved_presets()
    n_units = len(presets) + (1 if config.fc_thresholds else 0)
    units_run = 0
    while state["unit"] < n_units:
        if max_units is not None and units_run >= max_units:
            break
        if state["unit"] < len(presets):
            name = presets[state["unit"]]
            warm = program_preset_for_nfe(name, config.nfe, tau=config.tau)
            if log:
                log(f"unit {state['unit']} [{name}] "
                    f"(budget {state['budget_spent']}/{config.budget})")
            session.search_unit(warm, rng)
        else:
            if log:
                log(f"unit {state['unit']} [feature-cache] "
                    f"(budget {state['budget_spent']}/{config.budget})")
            session.search_fc_unit(rng)
        state["unit"] += 1
        state["rng"] = rng.bit_generator.state
        units_run += 1
        if artifact:
            save_state(artifact, state)
        if session.exhausted:
            break

    best_p, best_s = (None, float("inf"))
    if state["best"]:
        best_p, best_s = best_program(state)
    return SearchResult(
        best_program=best_p, best_score=best_s, state=state,
        stats=dict(session.evaluator.stats),
        done=state["unit"] >= n_units,
        exhausted=session.exhausted,
        best_fc=state.get("best_fc"))


def spec_from_state(state: dict, **overrides) -> SamplerSpec:
    """The full serving spec of a search artifact's winner — the exact
    spec the evaluator scored it under (family, NFE-derived step count,
    spec_kw), so serving it reproduces the searched samples bitwise."""
    config = SearchConfig.from_obj(state["config"])
    prog, _ = best_program(state)
    kw = dict(config.spec_kw)
    kw.update(overrides)
    return SamplerSpec.from_nfe(config.family, config.nfe, program=prog,
                                **kw)


def fc_spec_from_state(state: dict, **overrides) -> SamplerSpec:
    """The serving spec of a search artifact's feature-cache winner: the
    family's stock PECE configuration with the tuned residual threshold
    and tau — exactly what the fc unit scored it as. Composable with a
    program via ``overrides`` (the threshold was tuned program-free so it
    transfers)."""
    config = SearchConfig.from_obj(state["config"])
    best = state.get("best_fc")
    if not best:
        raise ValueError(
            "search artifact records no feature-cache winner (run with "
            "fc_thresholds set)")
    kw = dict(config.spec_kw)
    kw.update(tau=float(best["tau"]), mode="PECE",
              feature_cache=("residual", float(best["thresh"])))
    kw.update(overrides)
    return SamplerSpec.from_nfe(config.family, config.nfe, **kw)
