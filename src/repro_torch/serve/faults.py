"""Chaos injection for the serving engine: seeded, deterministic faults.

The fault-tolerance layer (per-lane numerical guards, per-bucket
containment, retry-with-degradation, quarantine) is only trustworthy if
its recovery paths run end-to-end under *controlled* failures. This
module provides that control plane:

- a :class:`Fault` names one planned event — ``"nan"`` (write NaN into a
  target request's lane state at a chosen scheduler tick, exercising the
  in-graph numerical guard), ``"raise"`` (raise
  :class:`repro_torch.runtime.InjectedFailure` at the tick boundary,
  exercising host-side containment + retry/backoff/quarantine), or
  ``"latency"`` (sleep inside the tick's timed region, exercising the
  straggler watchdog),
- a :class:`FaultPlan` is an immutable tuple of faults — written by hand
  for targeted tests, or drawn deterministically from a seed with
  :meth:`FaultPlan.seeded` so a chaos benchmark is exactly replayable,
- a :class:`FaultInjector` is the live hook the schedulers consult: the
  step scheduler calls ``on_tick(tick, batch)`` before advancing a
  running batch, the solve scheduler calls ``on_solve(index, mb, x_T)``
  before dispatching a microbatch. Each fault fires at most once
  (``fired`` records what actually happened, for assertions).

Injection is purely host-side: NaN poisoning is an eager lane-slice
write on the engine-owned carry (or the microbatch's initial noise) and
raising/sleeping happen between dispatches; no fault ever touches a
cached executor or a captured graph, so the zero-miss contract holds
under any fault mix.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..runtime import InjectedFailure

__all__ = ["Fault", "FaultPlan", "FaultInjector", "poison_lane"]


@dataclasses.dataclass(frozen=True)
class Fault:
    """One planned fault. ``tick`` is the scheduler tick (step scheduler)
    or microbatch index (solve scheduler) at which the fault *arms*; a
    ``"nan"`` fault targeting a ``rid`` stays armed until that request
    occupies a lane of the dispatched batch. ``bucket`` (a substring of
    the bucket label, see :func:`~repro_torch.serve.continuous.bucket_label`)
    scopes ``"raise"``/``"latency"`` faults to one bucket's dispatches;
    None fires on any batch."""

    kind: str  # "nan" | "raise" | "latency"
    tick: int = 0
    rid: int | None = None
    lane: int | None = None
    bucket: str | None = None
    seconds: float = 0.0

    def __post_init__(self):
        if self.kind not in ("nan", "raise", "latency"):
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected 'nan', "
                "'raise', or 'latency'")
        if self.kind == "nan" and self.rid is None and self.lane is None:
            raise ValueError("a 'nan' fault needs a target rid or lane")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable schedule of faults."""

    faults: tuple[Fault, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(self.faults))

    @classmethod
    def seeded(cls, seed: int, *, n_ticks: int, rids,
               nan: int = 1, raises: int = 1, latency: int = 1,
               seconds: float = 0.2) -> "FaultPlan":
        """Draw a deterministic fault mix from ``seed``: ``nan`` lane
        poisonings (targets drawn from ``rids``), ``raises`` host
        failures, and ``latency`` sleeps of ``seconds``, each armed at a
        tick uniform in ``[1, n_ticks)``. Same seed, same plan."""
        rng = np.random.default_rng(seed)
        rids = list(rids)
        faults = []
        for _ in range(nan):
            faults.append(Fault(
                "nan", tick=int(rng.integers(1, max(2, n_ticks))),
                rid=int(rng.choice(rids))))
        for _ in range(raises):
            faults.append(Fault(
                "raise", tick=int(rng.integers(1, max(2, n_ticks)))))
        for _ in range(latency):
            faults.append(Fault(
                "latency", tick=int(rng.integers(1, max(2, n_ticks))),
                seconds=seconds))
        return cls(tuple(sorted(faults, key=lambda f: f.tick)))


def poison_lane(carry: dict, lane: int) -> dict:
    """NaN one lane's family state (x and the ring history) in a copy of
    the carry: an eager lane-slice write; other lanes' bytes are untouched
    and no cached executor or graph is involved."""
    carry = dict(carry)
    inner = {}
    for k, v in carry["inner"].items():
        v = v.clone()
        if v.is_floating_point():
            v[lane] = float("nan")
        inner[k] = v
    carry["inner"] = inner
    return carry


class FaultInjector:
    """Live chaos hook, consulted by both schedulers.

    Stateful but deterministic: each fault fires at most once, in plan
    order, and ``fired`` records ``(kind, tick, detail)`` tuples for
    post-hoc assertions. Construct one per engine run.
    """

    def __init__(self, plan: FaultPlan):
        if isinstance(plan, (list, tuple)):
            plan = FaultPlan(tuple(plan))
        self.plan = plan
        self._spent: set[int] = set()
        self.fired: list[tuple] = []

    def _armed(self, tick: int, label: str | None):
        for idx, f in enumerate(self.plan.faults):
            if idx in self._spent or tick < f.tick:
                continue
            if f.bucket is not None and label is not None \
                    and f.bucket not in label:
                continue
            yield idx, f

    def _fire(self, idx: int, f: Fault, tick: int, detail=None) -> None:
        self._spent.add(idx)
        self.fired.append((f.kind, tick, detail))

    # ----------------------------------------------- step-scheduler hook
    def on_tick(self, tick: int, batch) -> None:
        """Called by the continuous batcher right before advancing one
        running batch; mutates ``batch.carry`` (nan), sleeps (latency),
        or raises :class:`InjectedFailure` (raise)."""
        from .continuous import bucket_label
        label = bucket_label(batch.key)
        for idx, f in list(self._armed(tick, label)):
            if f.kind == "latency":
                self._fire(idx, f, tick, label)
                time.sleep(f.seconds)
            elif f.kind == "raise":
                self._fire(idx, f, tick, label)
                raise InjectedFailure(
                    f"injected failure at tick {tick} ({label})")
            else:  # nan
                lane = f.lane
                if f.rid is not None:
                    lane = next((i for i, r in enumerate(batch.requests)
                                 if r is not None and r.rid == f.rid),
                                None)
                    if lane is None:  # stays armed until the rid joins
                        continue
                self._fire(idx, f, tick, (label, lane))
                batch.carry = poison_lane(batch.carry, lane)

    # ---------------------------------------------- solve-scheduler hook
    def on_solve(self, index: int, mb, x_T):
        """Called by the solve scheduler with the microbatch's initial
        noise; returns ``x_T`` (possibly with a target lane NaN'd), or
        sleeps/raises like ``on_tick``."""
        from .continuous import bucket_label
        label = bucket_label(mb.key)
        for idx, f in list(self._armed(index, label)):
            if f.kind == "latency":
                self._fire(idx, f, index, label)
                time.sleep(f.seconds)
            elif f.kind == "raise":
                self._fire(idx, f, index, label)
                raise InjectedFailure(
                    f"injected failure at microbatch {index} ({label})")
            else:  # nan
                lane = f.lane
                if f.rid is not None:
                    lane = next((i for i, r in enumerate(mb.requests)
                                 if r.rid == f.rid), None)
                    if lane is None:
                        continue
                self._fire(idx, f, index, (label, lane))
                x_T = x_T.clone()
                x_T[lane] = float("nan")
        return x_T
