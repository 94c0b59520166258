"""Per-step solver programs: the step dimension as a plan axis.

The paper's best FIDs come from tuning *per-step* stochasticity (§6.3 tau
bands, Appendix E) on top of a fixed-order Adams scheme; follow-up work
("A Unified Sampling Framework for Solver Searching of Diffusion
Probabilistic Models", "Adaptive Stochastic Coefficients for Accelerating
Diffusion Sampling") lets order, corrector usage and stochastic
coefficients vary along the trajectory. A :class:`StepProgram` assigns,
per solver interval:

- the predictor order (1..P) and corrector order (0..C),
- the step mode: ``"P"`` (predictor-only), ``"PEC"`` (predict, evaluate,
  correct; the paper's Algorithm 1), or ``"PECE"`` (re-evaluate after the
  correction; +1 NFE on that step),
- the tau value (any float, or any
  :class:`~repro_torch.core.tau.TauSchedule` evaluated on the grid:
  ``ConstantTau``/``BandedTau``/``DDIMEtaTau`` are all trivial programs).

Programs ride ``SamplerSpec.program``: the coefficient engine
(:func:`repro_torch.core.coefficients.build_tables`) emits per-interval
variable-order tables for them, and the multistep executor consumes those
tables *as data*: per-interval orders and taus are zero-padded table rows.
Only the per-step *mode pattern* is structure (a PECE step evaluates the
model twice): it goes into the executor statics as contiguous segments,
and a program whose mode is uniform collapses to exactly the fixed-spec
statics, so a program that pins constant order and tau is **bitwise
identical** to the fixed-spec path (same statics, byte-equal tables).

Orders requested beyond what the history can support are clamped to the
Adams warm-up ramp ``min(i + 1, requested)``: the program's order track
starts 1, 2, 3, ... exactly like the fixed-spec cold start.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from .schedules import NoiseSchedule
from .tau import BandedTau, ConstantTau, DDIMEtaTau, TauSchedule

__all__ = [
    "MODES",
    "StepProgram",
    "ResolvedProgram",
    "anneal_taus",
    "ramp_orders",
    "program_preset",
    "program_preset_for_nfe",
    "program_tau_track",
    "list_presets",
    "parse_program",
]

#: per-interval step modes: predictor-only / predict-evaluate-correct /
#: predict-evaluate-correct-evaluate
MODES = ("P", "PEC", "PECE")


def _as_track(value, name: str):
    """Normalize a per-interval track field: scalars pass through, any
    sequence becomes a tuple (hashability: the spec holds the program)."""
    if isinstance(value, (list, np.ndarray)):
        value = tuple(value.tolist() if isinstance(value, np.ndarray)
                      else value)
    return value


@dataclasses.dataclass(frozen=True)
class ResolvedProgram:
    """A program evaluated on one grid: plain per-interval host arrays.

    ``p_orders``/``c_orders`` are the *requested* orders (the coefficient
    engine applies the warm-up clamp ``min(i+1, order)``); ``pece`` marks
    the steps that re-evaluate after correction. A corrector order of 0
    and mode ``"P"`` are the same thing — both are normalized here, so
    ``c_orders[i] > 0`` iff step i runs a corrector.
    """

    p_orders: np.ndarray  # [M] int
    c_orders: np.ndarray  # [M] int, 0 = predictor-only step
    pece: np.ndarray      # [M] bool
    taus: np.ndarray      # [M] float64


@dataclasses.dataclass(frozen=True)
class StepProgram:
    """Per-interval solver program (hashable, so the spec that carries it
    stays hashable).

    Each track is either a scalar (broadcast over all intervals) or a
    tuple with one entry per interval; tuple tracks must agree on length,
    and that length must equal the spec's ``n_steps``. ``tau`` may also
    be any :class:`TauSchedule` (evaluated on the plan grid), which is
    how ``ConstantTau``/``BandedTau``/``DDIMEtaTau`` become trivial
    programs. ``width`` optionally floors the coefficient-table row count
    so programs of different max order can share one executor aval.
    """

    predictor_order: Any = 3    # int | tuple[int, ...]
    corrector_order: Any = 3    # int | tuple[int, ...]
    mode: Any = "PEC"           # str | tuple[str, ...]
    tau: Any = 1.0              # float | tuple[float, ...] | TauSchedule
    width: int = 0              # optional floor on buffer rows

    def __post_init__(self):
        for f in ("predictor_order", "corrector_order", "mode", "tau"):
            object.__setattr__(self, f, _as_track(getattr(self, f), f))
        for m in (self.mode if isinstance(self.mode, tuple)
                  else (self.mode,)):
            if m not in MODES:
                raise ValueError(f"mode {m!r}; expected one of {MODES}")
        for p in (self.predictor_order
                  if isinstance(self.predictor_order, tuple)
                  else (self.predictor_order,)):
            if int(p) < 1:
                raise ValueError("predictor_order entries must be >= 1")
        for c in (self.corrector_order
                  if isinstance(self.corrector_order, tuple)
                  else (self.corrector_order,)):
            if int(c) < 0:
                raise ValueError("corrector_order entries must be >= 0")
        L = self.length()
        if L is not None and L < 1:
            raise ValueError("program tracks must cover >= 1 interval")

    # ------------------------------------------------------------ shape
    def length(self) -> int | None:
        """The explicit interval count, or None if every track is scalar
        (an all-scalar program fits any step count)."""
        lens = {len(v) for v in (self.predictor_order,
                                 self.corrector_order, self.mode, self.tau)
                if isinstance(v, tuple)}
        if not lens:
            return None
        if len(lens) > 1:
            raise ValueError(
                f"program tracks disagree on interval count: {sorted(lens)}")
        return lens.pop()

    def _track(self, value, M: int, caster):
        if isinstance(value, tuple):
            if len(value) != M:
                raise ValueError(
                    f"program track has {len(value)} entries but the grid "
                    f"has {M} intervals")
            return [caster(v) for v in value]
        return [caster(value)] * M

    # ------------------------------------------------- mode normalization
    def mode_flags(self, M: int) -> list[tuple[bool, bool]]:
        """Per-interval ``(use_corrector, pece)`` after normalization:
        mode "P" zeroes the corrector, corrector order 0 forces mode "P"
        — the two spellings of a predictor-only step are one thing."""
        modes = self._track(self.mode, M, str)
        c = self._track(self.corrector_order, M, int)
        out = []
        for m, ci in zip(modes, c):
            uc = m != "P" and ci > 0
            out.append((uc, uc and m == "PECE"))
        return out

    def segments(self, M: int) -> tuple[tuple[bool, bool, int], ...]:
        """Contiguous runs of equal ``(use_corrector, pece)``: the only
        structural part of a program. One segment is the fixed-spec
        executor; more segments run one after another over the shared
        state and history, with one global step index."""
        flags = self.mode_flags(M)
        segs: list[list] = []
        for uc, pece in flags:
            if segs and segs[-1][0] == uc and segs[-1][1] == pece:
                segs[-1][2] += 1
            else:
                segs.append([uc, pece, 1])
        return tuple((uc, pece, n) for uc, pece, n in segs)

    def nfe(self, M: int) -> int:
        """Model evaluations this program spends over M intervals:
        1 (init) + 1 per step + 1 more per PECE step."""
        return 1 + M + sum(p for _, p in self.mode_flags(M))

    # ------------------------------------------------------------ resolve
    def resolve(self, schedule: NoiseSchedule,
                ts: np.ndarray) -> ResolvedProgram:
        """Evaluate every track on the grid ``ts`` (M+1 points)."""
        ts = np.asarray(ts, dtype=np.float64)
        M = len(ts) - 1
        if isinstance(self.tau, TauSchedule):
            taus = np.asarray(self.tau.on_intervals(schedule, ts),
                              dtype=np.float64)
            if len(taus) != M:
                raise ValueError("tau schedule returned wrong length")
        else:
            taus = np.asarray(self._track(self.tau, M, float))
        p = np.asarray(self._track(self.predictor_order, M, int))
        c = np.asarray(self._track(self.corrector_order, M, int))
        flags = self.mode_flags(M)
        c = np.where([uc for uc, _ in flags], c, 0)
        return ResolvedProgram(
            p_orders=p, c_orders=c,
            pece=np.asarray([pe for _, pe in flags], dtype=bool),
            taus=taus)

    def replace(self, **kw) -> "StepProgram":
        return dataclasses.replace(self, **kw)

    # --------------------------------------------------------------- json
    def to_json(self) -> str:
        """JSON form (see :func:`parse_program` for the schema)."""
        def tau_obj(tau):
            if isinstance(tau, ConstantTau):
                return {"kind": "constant", "tau": tau.tau}
            if isinstance(tau, BandedTau):
                return {"kind": "banded", "tau": tau.tau,
                        "band_lo": tau.band_lo, "band_hi": tau.band_hi}
            if isinstance(tau, DDIMEtaTau):
                return {"kind": "ddim_eta", "eta": tau.eta}
            if isinstance(tau, TauSchedule):  # pragma: no cover
                raise ValueError(f"no JSON form for {type(tau).__name__}")
            return list(tau) if isinstance(tau, tuple) else tau
        obj = {
            "predictor_order": list(self.predictor_order)
            if isinstance(self.predictor_order, tuple)
            else self.predictor_order,
            "corrector_order": list(self.corrector_order)
            if isinstance(self.corrector_order, tuple)
            else self.corrector_order,
            "mode": list(self.mode) if isinstance(self.mode, tuple)
            else self.mode,
            "tau": tau_obj(self.tau),
        }
        if self.width:
            obj["width"] = self.width
        return json.dumps(obj, sort_keys=True)

    @classmethod
    def from_json(cls, obj) -> "StepProgram":
        """Inverse of :meth:`to_json`; accepts a dict or a JSON string."""
        if isinstance(obj, str):
            obj = json.loads(obj)
        if not isinstance(obj, dict):
            raise ValueError("program JSON must be an object")
        unknown = set(obj) - {"predictor_order", "corrector_order",
                              "mode", "tau", "width"}
        if unknown:
            raise ValueError(f"unknown program fields: {sorted(unknown)}")
        tau = obj.get("tau", 1.0)
        if isinstance(tau, dict):
            kind = tau.get("kind")
            kw = {k: v for k, v in tau.items() if k != "kind"}
            try:
                tau = {"constant": ConstantTau, "banded": BandedTau,
                       "ddim_eta": DDIMEtaTau}[kind](**kw)
            except KeyError:
                raise ValueError(f"unknown tau kind {kind!r}")
        return cls(
            predictor_order=obj.get("predictor_order", 3),
            corrector_order=obj.get("corrector_order", 3),
            mode=obj.get("mode", "PEC"),
            tau=tau,
            width=int(obj.get("width", 0)),
        )


def program_tau_track(program: "StepProgram", schedule: NoiseSchedule,
                      ts: np.ndarray, family: str) -> np.ndarray:
    """Per-interval tau values ``[M]`` for a non-Adams solver family (the
    port's baseline families come with a later slice).

    The baselines have no order or P/PEC/PECE structure, but they DO have
    a per-step stochasticity knob: for DDIM-like steps tau is exactly the
    per-interval eta (0 = deterministic ODE step, 1 = ancestral), and the
    EDM stochastic sampler scales its per-step churn by it. Only the tau
    track carries over, so a program with per-interval order tracks or a
    non-PEC mode anywhere is rejected loudly instead of silently
    ignored."""
    if not isinstance(program, StepProgram):
        raise TypeError(
            f"spec.program must be a StepProgram, got "
            f"{type(program).__name__}")
    for f in ("predictor_order", "corrector_order"):
        if isinstance(getattr(program, f), tuple):
            raise ValueError(
                f"program {f} track has no meaning for the {family!r} "
                f"family — only the tau track applies (per-step eta / "
                f"churn scale)")
    if program.mode != "PEC":
        raise ValueError(
            f"program mode {program.mode!r} has no meaning for the "
            f"{family!r} family — only the tau track applies (per-step "
            f"eta / churn scale)")
    return program.resolve(schedule, np.asarray(ts, np.float64)).taus


# ------------------------------------------------------------------ presets
def ramp_orders(n_steps: int, cap: int = 3) -> tuple[int, ...]:
    """The Adams warm-up order track: 1, 2, ..., cap, cap, ... — exactly
    what the coefficient engine's clamp produces for a constant order."""
    return tuple(min(i + 1, cap) for i in range(n_steps))


def anneal_taus(tau: float, n_steps: int,
                floor: float = 0.0) -> tuple[float, ...]:
    """Linear tau anneal ``tau -> floor`` across the solve: stochastic
    early (contract accumulated error), deterministic at the end."""
    return tuple(floor + (tau - floor) * (1.0 - i / max(1, n_steps - 1))
                 for i in range(n_steps))


def _preset_constant(n_steps: int, tau: float) -> StepProgram:
    """The fixed-spec default spelled as a program: order 3, PEC,
    constant tau — bitwise identical to no program at all."""
    return StepProgram(predictor_order=3, corrector_order=3, mode="PEC",
                      tau=tau)


def _preset_order_ramp(n_steps: int, tau: float) -> StepProgram:
    """Explicit 1 -> 2 -> 3 order ramp: what the warm-up clamp produces
    anyway, spelled out (useful as a bitwise sanity preset)."""
    return StepProgram(predictor_order=ramp_orders(n_steps),
                      corrector_order=ramp_orders(n_steps), tau=tau)


def _preset_pece_head(n_steps: int, tau: float) -> StepProgram:
    """Spend the extra evaluations early, where steps are stiffest:
    PECE on the first quarter of the steps, PEC after. (Each PECE step
    costs one extra evaluation — under an NFE budget, stamp this out
    with :func:`program_preset_for_nfe`, not at the PEC step count.)"""
    head = max(1, n_steps // 4)
    return StepProgram(mode=("PECE",) * head + ("PEC",) * (n_steps - head),
                      tau=tau)


def _preset_predictor_tail(n_steps: int, tau: float) -> StepProgram:
    """Corrector on while the solve is coarse, predictor-only for the
    final third (the corrector's contraction matters least there)."""
    tail = max(1, n_steps // 3) if n_steps > 1 else 0
    return StepProgram(mode=("PEC",) * (n_steps - tail) + ("P",) * tail,
                      tau=tau)


def _preset_tau_anneal(n_steps: int, tau: float) -> StepProgram:
    """Linearly anneal tau to 0 along the solve."""
    return StepProgram(tau=anneal_taus(tau, n_steps))


def _preset_tau_band(n_steps: int, tau: float) -> StepProgram:
    """Appendix E's banded stochasticity as a program: tau inside the
    EDM-sigma band (0.05, 1], zero outside, edges snapped to the grid."""
    return StepProgram(tau=BandedTau(tau=tau))


def _preset_nfe8_gmm(n_steps: int, tau: float) -> StepProgram:
    """The best NFE<=8 program found by the JAX package's step-program
    search on the GMM oracle: tau annealed
    linearly to 0 with the corrector switched off for the final third of
    the steps — sliced-W2 0.024 vs 0.91 for the fixed P3C3 tau=1.0
    default at 7 steps. At 7 steps this is exactly the recorded winner
    (predictor-only last 2); other step counts generalize the shape."""
    tail = max(1, n_steps // 3) if n_steps > 1 else 0
    return StepProgram(mode=("PEC",) * (n_steps - tail) + ("P",) * tail,
                      tau=anneal_taus(tau, n_steps), width=3)


_PRESETS = {
    "constant": _preset_constant,
    "order-ramp": _preset_order_ramp,
    "pece-head": _preset_pece_head,
    "predictor-tail": _preset_predictor_tail,
    "tau-anneal": _preset_tau_anneal,
    "tau-band": _preset_tau_band,
    "nfe8-gmm": _preset_nfe8_gmm,
}


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def program_preset(name: str, n_steps: int, *, tau: float = 1.0) -> StepProgram:
    """Build a named preset program for an ``n_steps``-interval solve."""
    try:
        factory = _PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown program preset {name!r}; have {list_presets()}")
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    return factory(int(n_steps), float(tau))


def program_preset_for_nfe(name: str, nfe: int, *,
                           tau: float = 1.0) -> StepProgram:
    """Stamp a preset at the largest step count whose total cost fits the
    evaluation budget. A preset's per-step cost depends on its own mode
    track (PECE steps evaluate twice), so the step count cannot be
    derived from the fixed-spec mode — ``pece-head`` at ``nfe`` PEC-steps
    would always overdraw by its head length."""
    if nfe < 2:
        raise ValueError("nfe must be >= 2 (one init + one step)")
    for n_steps in range(nfe - 1, 0, -1):
        prog = program_preset(name, n_steps, tau=tau)
        if prog.nfe(n_steps) <= nfe:
            return prog
    # reachable: a preset whose single-step stamp already overdraws
    # (e.g. pece-head at nfe=2 — its one step is PECE and costs 3)
    raise ValueError(
        f"preset {name!r} cannot fit nfe={nfe}: even its 1-step stamp "
        f"spends {program_preset(name, 1, tau=tau).nfe(1)} evaluations")


def parse_program(text: str, n_steps: int, *, tau: float = 1.0,
                  nfe: int | None = None) -> StepProgram:
    """CLI front door: ``text`` is a preset name, an inline JSON object,
    or ``@path`` to a JSON file (schema = :meth:`StepProgram.to_json`).

    ``n_steps`` and ``tau`` parameterize *presets*; a JSON program
    carries its own tracks — except that a JSON object omitting the
    ``"tau"`` field inherits ``tau`` rather than silently resetting it
    to the dataclass default. When ``nfe`` is given, presets are stamped
    through :func:`program_preset_for_nfe` (the largest step count whose
    own PECE-aware cost fits the budget) instead of at ``n_steps`` —
    this is what ``launch.sample --program`` uses, so a PECE-bearing
    preset shrinks its step count rather than overdrawing ``--nfe``."""
    text = text.strip()
    if text.startswith(("@", "{")):
        if text.startswith("@"):
            with open(text[1:]) as f:
                text = f.read()
        obj = json.loads(text)
        prog = StepProgram.from_json(obj)
        if isinstance(obj, dict) and "tau" not in obj:
            prog = prog.replace(tau=tau)
        return prog
    if nfe is not None:
        return program_preset_for_nfe(text, nfe, tau=tau)
    return program_preset(text, n_steps, tau=tau)
