"""Step-granular continuous batching: the LLM-style scheduler.

The solve-granular engine (``ServeEngine`` with ``scheduler="solve"``)
serves one bucket start-to-finish per dispatch: a straggler bucket blocks
the queue, and a lane freed at solve-end idles until the whole microbatch
returns. This module schedules at **solver-step** granularity instead,
over the step protocol in ``repro_torch.core.samplers.stepwise``:

- every bucket key maps to one or more :class:`RunningBatch` es — a fixed
  ``lanes``-wide carry plus its cached ``StepFns`` — and one
  scheduler **tick** advances every lane of one batch by one solver step
  (round-robin over batches, so buckets interleave fairly instead of
  queueing behind each other),
- requests **join at step boundaries**: admission writes one lane of the
  carry (initial state, the request's [M, *shape] step noise, early-exit
  knobs) while the other lanes are mid-solve; the shape never changes,
- a lane whose request finishes (full solve or masked early exit) is
  **recycled** on the same tick — the next pending request with that
  bucket key joins into it,
- half-empty same-key batches are **merged** by migrating lanes
  (``StepFns.copy`` moves the whole carry slice — state, ring history,
  step index, step noise — so migration is bitwise-invisible to the moved
  request), and empty batches retire; their step functions (and captured
  tick graphs) stay in the stepwise cache, so batch churn builds nothing,
- the pending queue is **priority/deadline ordered** — ``(-priority,
  deadline, arrival)`` — with admission control (``max_pending`` bounds
  the queue; ``submit`` raises when full) and deadline shedding (a
  pending request past its deadline returns ``status="shed"`` instead of
  occupying a lane).

Early exit rides the carry's residual channel: SA-Solver's
predictor-vs-corrector residual (free in PEC/PECE — both combines are
computed anyway) is compared against the request's ``early_exit_tol``
each tick, and a lane that satisfies it finishes early under the fixed
shape. ``early_exit_tol <= 0`` disables the exit; the disabled path
through any join/leave/migration churn equals the request's
``sample_batched`` solve (bitwise at one batch shape; held in
``tests/test_torch_serve.py``).

The host reads each tick's ``aux`` once (flags and step indices stacked
into one tensor), as the reference reads it with one ``device_get``.

Accounting is tick-exact: every tick charges ``lanes`` lane-steps to the
batch's bucket, split into active (a real request advanced) and wasted
(free/finished lanes that computed anyway — the price of the fixed
shape). ``stats()["buckets"]`` reports per-bucket occupancy; the
solve-granular engine reports the same shape of numbers, so the two
schedulers compare like for like.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

from ..core.denoiser import Denoiser
from ..core.samplers import (SamplerSpec, build_plan, fresh_carry,
                             make_stepfns, stepwise_cache_stats)
from ..device import resolve_device
from ..runtime import StragglerMonitor
from .batching import Request, bucket_key, request_draws

__all__ = ["ContinuousBatcher", "RunningBatch", "bucket_label"]


def bucket_label(key: tuple) -> str:
    """Human-readable stats key for one bucket: family/steps/shape/dtype.

    Coarser than the bucket key on purpose (tau, program data, cond
    values don't change the work per lane-step) — stats
    aggregate across them.
    """
    spec, shape, dtype = key[0], key[1], key[2]
    return (f"{spec.name}/{spec.n_steps}step/"
            f"{'x'.join(str(s) for s in shape)}/{dtype}")


class RunningBatch:
    """One fixed-width carry mid-flight: ``lanes`` slots, each free or
    owned by a request at its own step index."""

    __slots__ = ("key", "plan", "fns", "arrays", "carry", "requests",
                 "previews", "scale", "M")

    def __init__(self, key, plan, fns, arrays, carry, lanes, scale, M):
        self.key = key
        self.plan = plan
        self.fns = fns
        self.arrays = arrays
        self.carry = carry
        self.requests: list[Request | None] = [None] * lanes
        self.previews: list[list] = [[] for _ in range(lanes)]
        self.scale = scale  # prior noise scale (host float)
        self.M = M

    @property
    def lanes(self) -> int:
        return len(self.requests)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.requests)

    def free_lanes(self) -> list[int]:
        return [i for i, r in enumerate(self.requests) if r is None]


class ContinuousBatcher:
    """The step-granular scheduler behind ``ServeEngine(scheduler="step")``.

    Single-device (the carry is one lane-batched state on ``device``, the
    card unless the caller asks for the CPU). ``model_fn`` is lane-batched
    (``x`` [L, *shape], ``t`` [L]). ``draws(rid, attempt, shape, M) ->
    (z, noise)`` replaces the generators' unit-normal draws of a request
    (its initial latent before the prior scale, and its [M, *shape] step
    noise), e.g. with the reference's. See the module docstring for the
    scheduling model.
    """

    def __init__(self, model_fn: Callable, *, lanes: int = 8,
                 stream: bool = False,
                 on_result: Callable | None = None,
                 noise_seed: int = 7, solve_seed: int = 8,
                 max_pending: int | None = None,
                 result_factory: Callable | None = None,
                 max_retries: int = 0,
                 degrade_ladder: Sequence | None = None,
                 tiers=None,
                 guard_interval: int = 0,
                 retry_backoff: float = 0.05,
                 quarantine_after: int = 3,
                 quarantine_s: float = 1.0,
                 watchdog: StragglerMonitor | None = None,
                 shed_on_straggler: bool = False,
                 fault_injector=None,
                 device="cuda",
                 draws: Callable | None = None):
        if lanes < 1:
            raise ValueError("need at least one lane")
        self.model_fn = model_fn
        self.lanes = int(lanes)
        self.stream = stream
        self.on_result = on_result
        self.device = resolve_device(device)
        self.max_pending = max_pending
        self._result = result_factory
        self.max_retries = int(max_retries)
        self.degrade_ladder = tuple(degrade_ladder) if degrade_ladder \
            else ()
        self._tiers = tiers
        self.guard_interval = int(guard_interval)
        self.retry_backoff = float(retry_backoff)
        self.quarantine_after = int(quarantine_after)
        self.quarantine_s = float(quarantine_s)
        self.watchdog = watchdog if watchdog is not None \
            else StragglerMonitor()
        self.shed_on_straggler = shed_on_straggler
        self._inject = fault_injector
        self._noise_seed = int(noise_seed)
        self._solve_seed = int(solve_seed)
        self._draws = draws
        self._pending: list[tuple] = []  # (sort_key, seq, Request)
        self._seq = 0
        self._rr = 0
        self._batches: list[RunningBatch] = []
        self._network_factor = 2 if (isinstance(model_fn, Denoiser)
                                     and model_fn.guidance) else 1
        self._stats = {
            "requests": 0, "completed": 0, "shed": 0, "joins": 0,
            "migrations": 0, "ticks": 0, "model_evals": 0,
            "network_evals": 0, "warmups": 0, "serve_s": 0.0,
            "failed": 0, "failed_numerics": 0, "retries": 0,
            "degraded": 0, "quarantines": 0, "callback_errors": 0,
            "straggler_sheds": 0,
        }
        self._buckets: dict[str, dict] = {}
        #: bucket label -> consecutive failures (reset by any success)
        self._fail_streak: dict[str, int] = {}
        #: bucket label -> monotonic time the quarantine lifts
        self._quarantine: dict[str, float] = {}
        self._callback_errs: list[str] = []
        self._shed_deadlines = False

    # ------------------------------------------------------------- intake
    def enqueue(self, req: Request) -> None:
        """Admit one request to the pending queue (priority/deadline
        ordered). Raises when admission control rejects it."""
        if self.max_pending is not None and \
                len(self._pending) >= self.max_pending:
            raise RuntimeError(
                f"admission control: {len(self._pending)} requests "
                f"pending >= max_pending={self.max_pending}; drain with "
                "tick()/run() or shed load upstream")
        dl = float("inf") if req.deadline is None else float(req.deadline)
        self._pending.append(((-int(req.priority), dl, self._seq), req))
        self._seq += 1
        self._stats["requests"] += 1

    def pending(self) -> int:
        return len(self._pending)

    def active(self) -> int:
        return sum(b.n_active for b in self._batches)

    # ---------------------------------------------------------- internals
    def _bucket_stats(self, key) -> dict:
        label = bucket_label(key)
        if label not in self._buckets:
            self._buckets[label] = {
                "ticks": 0, "lane_steps": 0, "active_lane_steps": 0,
                "wasted_lane_steps": 0,
            }
        return self._buckets[label]

    def _make_result(self, **kw):
        if self._result is not None:
            return self._result(**kw)
        return kw

    def _emit(self, res):
        if self.on_result is not None:
            try:
                self.on_result(res)
            except Exception as e:  # a user callback must not lose
                self._stats["callback_errors"] += 1  # other results
                self._callback_errs.append(repr(e))
                del self._callback_errs[:-8]
        return res

    # --------------------------------------------------- fault handling
    @staticmethod
    def _label_of(req: Request) -> str:
        return bucket_label(bucket_key(req))

    def _quarantined(self, label: str, now: float) -> bool:
        until = self._quarantine.get(label)
        if until is None:
            return False
        if now >= until:  # cooldown elapsed: allow a probe
            del self._quarantine[label]
            return False
        return True

    def _note_failure(self, label: str) -> None:
        """Consecutive-failure counting -> quarantine with cooldown."""
        n = self._fail_streak.get(label, 0) + 1
        self._fail_streak[label] = n
        if n >= self.quarantine_after:
            self._quarantine[label] = time.monotonic() + self.quarantine_s
            self._fail_streak[label] = 0
            self._stats["quarantines"] += 1

    def _note_success(self, label: str) -> None:
        self._fail_streak.pop(label, None)

    def _degrade(self, req: Request, attempt: int):
        """Resolve the retry's spec through the degradation ladder.

        Ladder entries are tier names (resolved via the engine's
        ``QualityTiers``), the literal ``"tau0"`` (the deterministic
        ODE-limit fallback: same spec with tau=0, program dropped), or
        explicit ``SamplerSpec`` s. Attempt ``a`` runs at rung
        ``min(a-1, len(ladder)-1)``; an empty ladder retries unchanged.
        """
        if not self.degrade_ladder:
            return req.spec, req.degraded_to
        entry = self.degrade_ladder[min(attempt - 1,
                                        len(self.degrade_ladder) - 1)]
        if isinstance(entry, SamplerSpec):
            return entry, f"spec:{entry.name}/{entry.n_steps}"
        if entry == "tau0":
            return req.spec.replace(tau=0.0, program=None), "tau0"
        if self._tiers is None:
            raise ValueError(
                f"degrade ladder names tier {entry!r} but the engine "
                "has no QualityTiers to resolve it")
        return self._tiers.resolve(entry), entry

    def _fail(self, req: Request, err, *, numerics: bool) -> list:
        """Retry (bounded, degraded, backed off) or emit a failure."""
        if req.attempt < self.max_retries:
            self._stats["retries"] += 1
            attempt = req.attempt + 1
            spec, rung = self._degrade(req, attempt)
            # numerics failures retry immediately (a fresh folded seed /
            # degraded spec is the fix); host-side faults back
            # off exponentially to ride out transient breakage
            not_before = 0.0 if numerics else \
                time.monotonic() + self.retry_backoff * (2 ** req.attempt)
            retry = dataclasses.replace(
                req, spec=spec, attempt=attempt, not_before=not_before,
                degraded_to=rung)
            dl = float("inf") if retry.deadline is None \
                else float(retry.deadline)
            self._pending.append(
                ((-int(retry.priority), dl, self._seq), retry))
            self._seq += 1
            return []
        status = "failed_numerics" if numerics else "failed"
        self._stats[status] += 1
        return [self._emit(self._make_result(
            rid=req.rid, x0=None, status=status,
            attempts=req.attempt + 1, degraded_to=req.degraded_to,
            error=f"{type(err).__name__}: {err}"))]

    def _new_batch(self, req: Request) -> RunningBatch:
        key = bucket_key(req)
        spec = key[0]
        plan = build_plan(spec)
        dtype = getattr(torch, req.dtype)
        fns = make_stepfns(plan, self.model_fn, req.shape, dtype,
                           self.lanes, cond=req.cond,
                           guidance_scale=req.guidance_scale,
                           stream=self.stream, device=self.device)
        arrays = fns.adapter.arrays(plan, fns.device)
        carry = fresh_carry(plan, self.lanes, req.shape, dtype,
                            cond=req.cond, model_fn=self.model_fn,
                            guard_every=self.guard_interval,
                            device=fns.device)
        if not fns.warmed:
            fns.warm(arrays, carry, cond=req.cond)
            self._stats["warmups"] += 1
        scale = spec.resolve_schedule().prior_scale(float(plan.ts[0]))
        M = fns.adapter.n_steps_of(arrays)
        batch = RunningBatch(key, plan, fns, arrays, carry, self.lanes,
                             scale, M)
        self._batches.append(batch)
        return batch

    def request_inputs(self, batch: RunningBatch, req: Request):
        """``(x_T, noise)`` of one request on the batch's device: the
        prior-scaled initial latent and the [M, *shape] step noise. The
        same derivation as the solve scheduler's, pure in (rid, attempt),
        so a request's bytes do not depend on its lane, batch or
        scheduler. Attempt 0 is the base stream; a retry folds its
        attempt in (the stream that just failed is never replayed)."""
        if self._draws is not None:
            z, noise = self._draws(req.rid, req.attempt, req.shape, batch.M)
        else:
            z, noise = request_draws(self._noise_seed, self._solve_seed,
                                     req.rid, req.attempt, req.shape,
                                     batch.M, batch.fns.device)
        device = batch.fns.device
        z = torch.as_tensor(z, dtype=torch.float32).to(device)
        x_T = (batch.scale * z).to(getattr(torch, req.dtype))
        return x_T, torch.as_tensor(noise, dtype=torch.float32).to(device)

    def _join(self, batch: RunningBatch, lane: int, req: Request) -> None:
        spec = batch.key[0]
        x_T, noise = self.request_inputs(batch, req)
        min_i = req.min_steps
        if min_i is None:
            min_i = max(int(spec.predictor_order),
                        int(spec.corrector_order))
        batch.carry = batch.fns.join(
            batch.arrays, batch.carry, lane, x_T, noise,
            float(req.early_exit_tol), int(min_i),
            float(req.guidance_scale), guard=self.guard_interval,
            cond=req.cond)
        batch.requests[lane] = req
        batch.previews[lane] = []
        self._stats["joins"] += 1

    def _admit(self) -> list:
        """Priority-ordered admission: shed expired, hold quarantined /
        backed-off retries, fill free lanes, open new batches for
        whatever has no lane. A request whose bucket fails to build or
        warm (e.g. a raising model fn at trace time) fails alone — the
        other buckets' work is untouched. Returns shed/failed results."""
        if not self._pending:
            return []
        now = time.monotonic()
        self._pending.sort(key=lambda e: e[0])
        shed_deadlines = self._shed_deadlines
        self._shed_deadlines = False
        results, held = [], []
        # snapshot: _fail() re-enqueues retries onto self._pending, and
        # those must wait for the NEXT admission pass (backoff aside,
        # re-admitting a failing request in the same pass would loop)
        queue, self._pending = self._pending, []
        for sort_key, req in queue:
            if req.deadline is not None and now > float(req.deadline):
                self._stats["shed"] += 1
                results.append(self._emit(self._make_result(
                    rid=req.rid, x0=None, status="shed")))
                continue
            if shed_deadlines and req.deadline is not None:
                # straggler watchdog fired: deadline-bearing work can't
                # meet its SLO behind a slow tick — shed it now instead
                # of letting it expire in the queue
                self._stats["shed"] += 1
                self._stats["straggler_sheds"] += 1
                results.append(self._emit(self._make_result(
                    rid=req.rid, x0=None, status="shed")))
                continue
            label = self._label_of(req)
            if req.not_before > now or self._quarantined(label, now):
                held.append((sort_key, req))
                continue
            key = bucket_key(req)
            try:
                lane_home = None
                for b in self._batches:
                    if b.key == key:
                        free = b.free_lanes()
                        if free:
                            lane_home = (b, free[0])
                            break
                if lane_home is None:
                    b = self._new_batch(req)
                    lane_home = (b, 0)
                self._join(lane_home[0], lane_home[1], req)
            except Exception as err:
                self._note_failure(label)
                results.extend(self._fail(req, err, numerics=False))
        self._pending.extend(held)
        return results

    def _harvest(self, batch: RunningBatch, aux) -> list:
        """Collect finished + guard-tripped lanes after one step; frees
        them in place."""
        # one host round-trip per tick: the flags and step indices come
        # back together in one tensor (each read is a sync barrier on the
        # tick); the numerical-guard trips ride the same fetch
        flags = torch.stack([aux[k].long() for k in
                             ("finished", "stepped", "failed", "i")]).cpu()
        fin, stepped, bad, steps = (flags[0].bool(), flags[1].bool(),
                                    flags[2].bool(), flags[3])
        if self.stream:
            for lane, req in enumerate(batch.requests):
                if req is not None and stepped[lane]:
                    batch.previews[lane].append(aux["x0"][lane])
        if not fin.any() and not bad.any():
            return []
        label = bucket_label(batch.key)
        results = []
        for lane, req in enumerate(batch.requests):
            if req is None:
                continue
            if bad[lane]:
                # in-graph guard tripped: the lane was already masked
                # out; free it and retry/fail the request
                self._note_failure(label)
                results.extend(self._fail(
                    req, ArithmeticError(
                        f"non-finite state at step {int(steps[lane])}"),
                    numerics=True))
                batch.requests[lane] = None
                batch.previews[lane] = []
                continue
            if not fin[lane]:
                continue
            previews = None
            if self.stream:
                previews = torch.stack(batch.previews[lane])
            if req.degraded_to is not None:
                self._stats["degraded"] += 1
            results.append(self._emit(self._make_result(
                rid=req.rid, x0=batch.carry["x_final"][lane].clone(),
                previews=previews, status="ok",
                n_steps=int(steps[lane]), attempts=req.attempt + 1,
                degraded_to=req.degraded_to)))
            batch.requests[lane] = None
            batch.previews[lane] = []
            self._stats["completed"] += 1
            self._note_success(label)
        return results

    def _merge(self) -> None:
        """Fold same-key half-empty batches together (migrating each
        lane's full carry slice) and retire empties."""
        by_key: dict[tuple, list[RunningBatch]] = {}
        for b in self._batches:
            by_key.setdefault(b.key, []).append(b)
        retired = []
        for key, group in by_key.items():
            group.sort(key=lambda b: b.n_active)
            i, j = 0, len(group) - 1
            while i < j:
                src, dst = group[i], group[j]
                free = dst.free_lanes()
                movable = [(l, r) for l, r in enumerate(src.requests)
                           if r is not None]
                if len(movable) > len(free):
                    break  # smallest doesn't fit in the fullest's gaps
                for (src_lane, req), dst_lane in zip(movable, free):
                    dst.carry = dst.fns.copy(dst.carry, src.carry,
                                             dst_lane, src_lane)
                    dst.requests[dst_lane] = req
                    dst.previews[dst_lane] = src.previews[src_lane]
                    self._stats["migrations"] += 1
                retired.append(src)
                i += 1
        pending_keys = {bucket_key(r) for _, r in self._pending}
        for b in self._batches:
            if b.n_active == 0 and b.key not in pending_keys \
                    and b not in retired:
                retired.append(b)
        if retired:
            self._batches = [b for b in self._batches if b not in retired]
            self._rr = 0

    def _contain(self, batch: RunningBatch, err: Exception) -> list:
        """One bucket's tick raised: fail ONLY that batch's in-flight
        requests (retry path included) and drop the batch — its carry
        may hold a poisoned dispatch. The step functions stay cached, so
        a post-quarantine probe re-warms nothing."""
        label = bucket_label(batch.key)
        self._note_failure(label)
        results = []
        for req in batch.requests:
            if req is not None:
                results.extend(self._fail(req, err, numerics=False))
        self._batches.remove(batch)
        self._rr = 0
        return results

    # ------------------------------------------------------------ serving
    def tick(self) -> list:
        """One scheduler tick: admit, advance one batch, harvest, merge.

        Per-tick execution is containment-wrapped: an exception (model
        fault, injected failure, runtime error surfacing at the tick's
        host read) fails only the stepped batch's requests; every
        other batch and the pending queue are untouched. Returns the
        results completed this tick (possibly empty).
        """
        t0 = time.perf_counter()
        results = self._admit()
        if not self._batches:
            self._stats["serve_s"] += time.perf_counter() - t0
            return results
        self._rr %= len(self._batches)
        batch = self._batches[self._rr]
        self._rr += 1
        n_active = batch.n_active
        tick_no = self._stats["ticks"]
        try:
            if self._inject is not None:
                self._inject.on_tick(tick_no, batch)
            batch.carry, aux = batch.fns.step(batch.arrays, batch.carry)
            self._stats["ticks"] += 1
            evals = batch.fns.adapter.evals_per_tick * n_active
            self._stats["model_evals"] += evals
            self._stats["network_evals"] += evals * self._network_factor
            bs = self._bucket_stats(batch.key)
            bs["ticks"] += 1
            bs["lane_steps"] += batch.lanes
            bs["active_lane_steps"] += n_active
            bs["wasted_lane_steps"] += batch.lanes - n_active
            results.extend(self._harvest(batch, aux))
        except Exception as err:
            results.extend(self._contain(batch, err))
        if results or self._pending:
            self._merge()
        dt = time.perf_counter() - t0
        self._stats["serve_s"] += dt
        # watchdog: injected latency, a straggling device, or a slow
        # host all show up as a per-tick wall-time outlier
        if self.watchdog.observe(tick_no, dt) and self.shed_on_straggler:
            self._shed_deadlines = True
        return results

    def _next_wake(self) -> float:
        """Earliest monotonic time any held pending request becomes
        admittable (backoff expiry or quarantine lift); inf if none."""
        wake = float("inf")
        for _, req in self._pending:
            w = req.not_before
            until = self._quarantine.get(self._label_of(req))
            if until is not None:
                w = max(w, until)
            wake = min(wake, w)
        return wake

    def run(self) -> list:
        """Drain pending + running work; results in completion order."""
        out = []
        while self._pending or self._batches:
            got = self.tick()
            out.extend(got)
            if got or self._batches:
                continue
            if not self._pending:
                break
            # pending-only: everything is backed off or quarantined —
            # sleep until the earliest becomes admittable instead of
            # spinning (quarantine cooldowns are wall-clock)
            wake = self._next_wake()
            if wake == float("inf"):
                break
            wait = wake - time.monotonic()
            if wait > 0:
                time.sleep(min(wait, 0.05))
        return out

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        s = dict(self._stats)
        dt = s["serve_s"]
        s["requests_per_s"] = s["completed"] / dt if dt > 0 else 0.0
        s["model_evals_per_s"] = s["model_evals"] / dt if dt > 0 else 0.0
        buckets = {}
        for label, b in self._buckets.items():
            b = dict(b)
            b["occupancy"] = (b["active_lane_steps"] / b["lane_steps"]
                              if b["lane_steps"] else 0.0)
            buckets[label] = b
        s["buckets"] = buckets
        s["stepwise_cache"] = stepwise_cache_stats()
        s["callback_error_messages"] = list(self._callback_errs)
        s["straggler_events"] = len(self.watchdog.events)
        return s

    def health(self) -> dict:
        """Machine-readable health snapshot (no device sync)."""
        now = time.monotonic()
        quarantined = {label: round(until - now, 6)
                       for label, until in self._quarantine.items()
                       if until > now}
        s = self._stats
        return {
            "status": "degraded" if quarantined else "ok",
            "scheduler": "step",
            "pending": len(self._pending),
            "active": self.active(),
            "running_batches": len(self._batches),
            "quarantined": quarantined,
            "consecutive_failures": dict(self._fail_streak),
            "completed": s["completed"],
            "failed": s["failed"],
            "failed_numerics": s["failed_numerics"],
            "retries": s["retries"],
            "degraded_results": s["degraded"],
            "shed": s["shed"],
            "quarantines": s["quarantines"],
            "callback_errors": s["callback_errors"],
            "straggler_events": len(self.watchdog.events),
        }
