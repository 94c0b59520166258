"""The diffusion serve engine: queue -> microbatch -> cached solve.

One :class:`ServeEngine` owns one model (``model_fn``), a FIFO request
queue, and the serving loop, on one device (the card unless the caller
asks for the CPU), or with ``mesh=`` on every rank of a mesh:

- ``submit()`` enqueues a request: any registered :class:`SamplerSpec`
  (sampler family, NFE, tau, ...) plus a latent shape and, for
  Denoiser-backed engines, a per-request conditioning tensor and guidance
  scale. Requests with different specs/shapes coexist in the queue; the
  engine groups them by ``(spec, shape, dtype, cond structure)`` bucket
  (see :mod:`repro_torch.serve.batching`); conditioning *values* and the
  guidance scale are data and never split a bucket or add a cache entry.
  The spec's ``precision`` and ``history`` ride the bucket key like every
  other static.
- ``step()`` serves the oldest bucket as one microbatch: ragged tails are
  padded with *masked* dummy lanes (never duplicated requests), each lane
  draws its initial noise and step noise from generators seeded by
  ``(seed, rid)``, so results are independent of bucketing, and the whole
  batch runs as ONE ``sample_batched`` solve over its lanes.
- the first encounter of a bucket warms it (``warmup(batch=...)``: on the
  card the solve is captured as a CUDA graph); after that the hot path
  replays (``compile_cache_stats()`` shows zero misses across tau sweeps,
  since tau is table data).
- ``stream=True`` threads the trajectory through: each
  :class:`ServeResult` carries the per-step denoised ``x0`` previews, and
  the optional ``on_result`` callback fires as each microbatch completes.
- ``scheduler="step"`` serves through the continuous batcher
  (:mod:`repro_torch.serve.continuous`) instead: one solver step of one
  running batch per call.
- ``mesh=`` (a named ``DeviceMesh``; :mod:`repro_torch.serve.sharding`)
  shards each microbatch's lanes over the mesh's ``data`` axis through
  ``sample_sharded``, bucket sizes rounded up to multiples of that axis;
  ``cfg_axis=`` also splits the guided pair over a size-2 axis. Every rank
  runs the same engine on the same requests (the lanes' draws stay per
  request id) and gets every result.

The model is lane-batched: ``model_fn(x, t)`` takes ``x`` [L, *shape] and
``t`` [L] (one time per lane) and returns [L, *shape], each lane's output
depending on that lane's input only, or a
:class:`~repro_torch.core.denoiser.Denoiser` over such a network (a
per-lane cond is stacked as [L, ...]; under guidance give the Denoiser
``cond_rank``). The reference's per-request closure is vmapped by its
engine instead; the port has no vmap over its CUDA kernels.

Throughput accounting counts **real** requests only: ``model_evals`` is
``spec.nfe`` (guided, solver-level evaluations) per served request, and
``network_evals`` is ``spec.network_nfe``: under classifier-free
guidance every guided evaluation is one network forward over a
*doubled* lane count, so a CFG bucket of B lanes drives 2B network lanes
(and a padded slot wastes two network lanes instead of one). Padded
lanes are reported separately as ``padded_slots`` (they cost compute
but serve nobody).

``quality_tier=`` names a tier of the engine's :class:`QualityTiers`
(``default_tiers()``, or ``QualityTiers.from_artifact`` of an autotuner
search, whose winner is ``"best"``); it resolves to its spec at submit
time, so a tier request is bitwise its explicit spec.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.denoiser import Denoiser
from ..core.samplers import (SamplerSpec, build_plan, compile_cache_stats,
                             sample_batched, sample_sharded, warmup)
from ..device import resolve_device
from ..runtime import StragglerMonitor
from .batching import (MicroBatch, Request, bucket_key, form_microbatches,
                       request_draws)
from .continuous import ContinuousBatcher, bucket_label
from .sharding import align_bucket_sizes, data_axis_size
from .tiers import QualityTiers, default_tiers

__all__ = ["ServeEngine", "ServeResult"]


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served request: final latent plus optional streamed previews."""

    rid: int
    x0: torch.Tensor | None
    #: ``[n_steps, *shape]`` per-step denoised previews (stream=True
    #: only), in per-request step order — under the step scheduler an
    #: early-exited lane carries fewer rows than the full solve
    previews: torch.Tensor | None = None
    #: terminal status — x0 is None for everything but "ok":
    #: - "ok": served (possibly on a degraded retry; see degraded_to)
    #: - "shed": deadline expired before the request got a lane (step
    #:   scheduler only)
    #: - "failed_numerics": the per-lane numerical guard tripped
    #:   (non-finite state) and retries were exhausted
    #: - "failed": a host-side fault (model exception, injected failure)
    #:   outlived the retry budget
    status: str = "ok"
    #: solver steps actually run (step scheduler; None under "solve",
    #: where every request runs its spec's full step count)
    n_steps: int | None = None
    #: serve attempts consumed (1 = first try succeeded; retries add 1
    #: each, so a result that failed after 2 retries reports 3)
    attempts: int = 1
    #: degradation-ladder rung the final attempt ran at (a tier name,
    #: "tau0", or "spec:name/steps"); None when served undegraded
    degraded_to: str | None = None
    #: last error string for failed results; None on success
    error: str | None = None


class ServeEngine:
    """Continuously microbatched diffusion sampling service on one device
    (or, with ``mesh``, on every rank of a mesh).

    Args:
        model_fn: lane-batched model: a plain ``(x [L, *shape], t [L]) ->
            [L, *shape]`` callable speaking the plan's parameterization,
            or a :class:`repro_torch.core.denoiser.Denoiser` wrapping a
            raw eps/x0/v-prediction network (with or without
            classifier-free guidance). Held strongly for the engine's
            lifetime.
        bucket_sizes: allowed microbatch lane counts; tails take the
            smallest that fits.
        mesh: a named ``DeviceMesh`` (``repro_torch.launch.mesh``): each
            microbatch's lanes are sharded over its ``data_axis`` through
            ``sample_sharded`` (bucket sizes rounded up to multiples of
            that axis's size); every rank of the mesh runs this engine on
            the same requests and gets every result. Solve scheduler only.
        cfg_axis: a size-2 mesh axis carrying the guided pair (sharded
            classifier-free guidance); needs ``mesh``.
        stream: solve with the trajectory and attach per-step x0
            previews to every result.
        on_result: optional callback invoked with each ServeResult as its
            microbatch completes (streaming consumption).
        noise_seed / solve_seed: bases of the per-request generator seeds
            (initial noise and step noise respectively).
        tiers: the :class:`~repro_torch.serve.tiers.QualityTiers` map
            behind ``submit(..., quality_tier=...)``; defaults to
            :func:`~repro_torch.serve.tiers.default_tiers`.
        scheduler: "solve" (whole-solve microbatches through
            ``sample_batched``) or "step" (continuous batching at
            solver-step granularity, ``lanes`` wide).
        max_retries: serve attempts beyond the first for a failed
            request (numerical-guard trip or host-side fault). Each
            retry folds its attempt count into the request's generator
            seeds (attempt 0 is the base stream) and may run degraded
            (see ``degrade_ladder``). 0 disables retries.
        degrade_ladder: per-retry quality fallback: a sequence of tier
            names (resolved through ``tiers``), the literal ``"tau0"``
            (same spec at tau=0, the deterministic ODE limit), or
            explicit :class:`SamplerSpec` s; attempt ``a`` runs at rung
            ``min(a-1, len-1)``. Empty/None retries at full quality.
        guard_interval: every N solver steps, a per-lane finiteness
            check on the full family state (step scheduler); a tripped
            lane is masked out and its request fails with
            ``status="failed_numerics"`` (or retries). The interval is
            carry data: toggling or sweeping it adds no cache entry.
            Under the solve scheduler, any non-zero value enables a
            post-solve per-lane check on the final latent. 0 disables.
        retry_backoff: base seconds for exponential backoff before a
            host-fault retry (numerics retries re-enqueue immediately).
        quarantine_after: consecutive failures of one bucket before it
            is quarantined (its pending work held, not dropped).
        quarantine_s: quarantine cooldown; after it elapses the next
            request through is the probe.
        watchdog: a :class:`repro_torch.runtime.StragglerMonitor`
            observing per-tick (step scheduler) / per-microbatch (solve)
            wall times; defaults to a fresh monitor. ``shed_on_straggler``
            makes a straggler event shed deadline-bearing pending work
            (step scheduler only).
        fault_injector: a :class:`repro_torch.serve.faults.FaultInjector`
            consulted before each dispatch; chaos testing only.
        device: where the engine serves: the card (``"cuda"``, raising
            with no card) unless the caller asks for ``"cpu"``.
        draws: ``(rid, attempt, shape, M) -> (z, noise)``, replacing the
            generators' unit-normal draws of a request (its initial latent
            before the prior scale, and its [M, *shape] step noise), e.g.
            with the reference's in parity tests.
    """

    def __init__(self, model_fn: Callable, *,
                 bucket_sizes: Sequence[int] = (1, 2, 4, 8),
                 mesh=None, data_axis: str = "data",
                 cfg_axis: str | None = None,
                 stream: bool = False,
                 on_result: Callable[[ServeResult], None] | None = None,
                 noise_seed: int = 7, solve_seed: int = 8,
                 tiers: QualityTiers | None = None,
                 scheduler: str = "solve", lanes: int = 8,
                 max_pending: int | None = None,
                 max_retries: int = 0,
                 degrade_ladder: Sequence | None = None,
                 guard_interval: int = 0,
                 retry_backoff: float = 0.05,
                 quarantine_after: int = 3,
                 quarantine_s: float = 1.0,
                 watchdog: StragglerMonitor | None = None,
                 shed_on_straggler: bool = False,
                 fault_injector=None,
                 device="cuda",
                 draws: Callable | None = None):
        if not bucket_sizes:
            raise ValueError("need at least one bucket size")
        if scheduler not in ("solve", "step"):
            raise ValueError(
                f"scheduler={scheduler!r}; expected 'solve' "
                "(whole-solve microbatches) or 'step' (continuous "
                "batching at solver-step granularity)")
        if scheduler == "step" and mesh is not None:
            raise ValueError(
                "the step scheduler is single-device (one lane-batched "
                "carry per running batch); use scheduler='solve' with a "
                "mesh")
        if cfg_axis is not None and mesh is None:
            raise ValueError(
                "cfg_axis needs a mesh (sharded CFG splits the cond/"
                "uncond pair across a size-2 mesh axis); without one the "
                "engine already runs the fused doubled-lane eval")
        self.model_fn = model_fn
        self.device = resolve_device(device)
        self.mesh = mesh
        self.data_axis = data_axis
        self.cfg_axis = cfg_axis
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"a {mesh.device_type!r} mesh cannot serve on "
                    f"{self.device}; build the mesh on the engine's device")
            bucket_sizes = align_bucket_sizes(
                bucket_sizes, data_axis_size(mesh, data_axis))
        self.bucket_sizes = tuple(sorted(set(int(b) for b in bucket_sizes)))
        self.stream = stream
        self.on_result = on_result
        self.tiers = tiers if tiers is not None else default_tiers()
        self.scheduler = scheduler
        self.max_pending = max_pending
        self.max_retries = int(max_retries)
        self.degrade_ladder = tuple(degrade_ladder) if degrade_ladder \
            else ()
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
        self._queue: list[Request] = []
        self._next_rid = 0
        self._warmed: set[tuple] = set()
        self._stats = {
            "requests": 0, "microbatches": 0, "padded_slots": 0,
            "model_evals": 0, "network_evals": 0, "warmups": 0,
            "serve_s": 0.0, "completed": 0,
            "failed": 0, "failed_numerics": 0, "retries": 0,
            "degraded": 0, "quarantines": 0, "callback_errors": 0,
        }
        self._buckets: dict[str, dict] = {}
        self._fail_streak: dict[str, int] = {}
        self._quarantine: dict[str, float] = {}
        self._callback_errs: list[str] = []
        self._batcher = None
        if scheduler == "step":
            self._batcher = ContinuousBatcher(
                model_fn, lanes=lanes, stream=stream,
                on_result=on_result,
                noise_seed=noise_seed, solve_seed=solve_seed,
                max_pending=max_pending,
                result_factory=ServeResult,
                max_retries=self.max_retries,
                degrade_ladder=self.degrade_ladder,
                tiers=self.tiers,
                guard_interval=self.guard_interval,
                retry_backoff=self.retry_backoff,
                quarantine_after=self.quarantine_after,
                quarantine_s=self.quarantine_s,
                watchdog=self.watchdog,
                shed_on_straggler=shed_on_straggler,
                fault_injector=fault_injector,
                device=self.device, draws=draws)

    # ------------------------------------------------------------- intake
    def submit(self, spec: SamplerSpec | None, shape: Sequence[int],
               dtype="float32", rid: int | None = None, *,
               cond=None, guidance_scale: float = 1.0,
               quality_tier: str | None = None,
               priority: int = 0, deadline: float | None = None,
               early_exit_tol: float = 0.0,
               min_steps: int | None = None) -> int:
        """Enqueue one request; returns its rid (for RNG identity and
        result matching). An explicit ``rid`` makes a request replayable
        — the same rid always produces the same sample. ``cond`` is the
        request's conditioning (one request's, without a lane axis; the
        engine model must be a Denoiser; only its shape/dtype affects
        bucketing) and ``guidance_scale`` its CFG scale (pure data: a
        scale sweep rides one warmed entry). Pass ``quality_tier`` ("draft" |
        "standard" | "best" with default tiers) with ``spec=None`` to let
        the engine's tier map pick the spec — resolution happens here, so
        tier requests bucket (and sample) exactly like explicit-spec
        requests.

        Scheduling knobs (honored by ``scheduler="step"``; the solve
        scheduler serves FIFO at full NFE and ignores them):
        ``priority`` (higher first), ``deadline`` (absolute
        ``time.monotonic()``; expired pending work is shed with
        ``status="shed"``), ``early_exit_tol`` (masked per-lane early
        exit on the predictor-vs-corrector residual; <= 0 disables —
        the disabled path is bitwise the solo solve), ``min_steps``
        (completed steps before an exit may fire; defaults to the spec's
        solver order)."""
        if quality_tier is not None:
            if spec is not None:
                raise ValueError(
                    "pass either spec or quality_tier, not both")
            spec = self.tiers.resolve(quality_tier)
        elif spec is None:
            raise ValueError("need a spec (or a quality_tier)")
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid + 1)
        # validate here, where the scale is still a host float: by serve
        # time it rides the executor as a per-lane device buffer, so the
        # base layer's sync-free guard can no longer see its value
        guided = isinstance(self.model_fn, Denoiser) and \
            self.model_fn.guidance
        if not guided and float(guidance_scale) != 1.0:
            raise ValueError(
                "guidance_scale has no effect without a guidance-enabled "
                "Denoiser engine model — it would be silently dropped")
        if cond is not None:
            cond = torch.as_tensor(cond)
        if isinstance(dtype, torch.dtype):
            dtype = str(dtype).replace("torch.", "")
        if not isinstance(getattr(torch, dtype, None), torch.dtype):
            raise ValueError(f"dtype={dtype!r} is not a torch dtype")
        req = Request(
            rid=rid, spec=spec, shape=tuple(int(s) for s in shape),
            dtype=dtype, cond=cond,
            guidance_scale=float(guidance_scale),
            priority=int(priority), deadline=deadline,
            early_exit_tol=float(early_exit_tol), min_steps=min_steps)
        if self._batcher is not None:
            self._batcher.enqueue(req)  # admission control lives there
            return rid
        if self.max_pending is not None and \
                len(self._queue) >= self.max_pending:
            raise RuntimeError(
                f"admission control: {len(self._queue)} requests pending "
                f">= max_pending={self.max_pending}; drain with "
                "step()/run() or shed load upstream")
        self._queue.append(req)
        return rid

    def pending(self) -> int:
        if self._batcher is not None:
            return self._batcher.pending()
        return len(self._queue)

    # --------------------------------------------------- fault handling
    # (solve scheduler; the step scheduler's ContinuousBatcher carries
    # its own copy of this state so containment is per-scheduler-tick)
    def _emit(self, res: ServeResult) -> ServeResult:
        if self.on_result is not None:
            try:
                self.on_result(res)
            except Exception as e:  # a user callback must not lose
                self._stats["callback_errors"] += 1  # other results
                self._callback_errs.append(repr(e))
                del self._callback_errs[:-8]
        return res

    def _quarantined(self, label: str, now: float) -> bool:
        until = self._quarantine.get(label)
        if until is None:
            return False
        if now >= until:  # cooldown elapsed: allow a probe
            del self._quarantine[label]
            return False
        return True

    def _note_failure(self, label: str) -> None:
        n = self._fail_streak.get(label, 0) + 1
        self._fail_streak[label] = n
        if n >= self.quarantine_after:
            self._quarantine[label] = time.monotonic() + self.quarantine_s
            self._fail_streak[label] = 0
            self._stats["quarantines"] += 1

    def _note_success(self, label: str) -> None:
        self._fail_streak.pop(label, None)

    def _degrade(self, req: Request, attempt: int):
        if not self.degrade_ladder:
            return req.spec, req.degraded_to
        entry = self.degrade_ladder[min(attempt - 1,
                                        len(self.degrade_ladder) - 1)]
        if isinstance(entry, SamplerSpec):
            return entry, f"spec:{entry.name}/{entry.n_steps}"
        if entry == "tau0":
            return req.spec.replace(tau=0.0, program=None), "tau0"
        return self.tiers.resolve(entry), entry

    def _fail(self, req: Request, err, *, numerics: bool) -> list:
        """Retry (bounded, degraded, backed off) or emit a failure."""
        if req.attempt < self.max_retries:
            self._stats["retries"] += 1
            attempt = req.attempt + 1
            spec, rung = self._degrade(req, attempt)
            not_before = 0.0 if numerics else \
                time.monotonic() + self.retry_backoff * (2 ** req.attempt)
            self._queue.append(dataclasses.replace(
                req, spec=spec, attempt=attempt, not_before=not_before,
                degraded_to=rung))
            return []
        status = "failed_numerics" if numerics else "failed"
        self._stats[status] += 1
        return [self._emit(ServeResult(
            rid=req.rid, x0=None, status=status,
            attempts=req.attempt + 1, degraded_to=req.degraded_to,
            error=f"{type(err).__name__}: {err}"))]

    def _eligible(self) -> tuple[list[Request], list[Request]]:
        """Split the queue into (servable now, held) — held requests are
        backed off or their bucket is quarantined."""
        now = time.monotonic()
        ok, held = [], []
        for r in self._queue:
            label = bucket_label(bucket_key(r))
            if r.not_before > now or self._quarantined(label, now):
                held.append(r)
            else:
                ok.append(r)
        return ok, held

    def _next_wake(self) -> float:
        wake = float("inf")
        for r in self._queue:
            w = r.not_before
            until = self._quarantine.get(bucket_label(bucket_key(r)))
            if until is not None:
                w = max(w, until)
            wake = min(wake, w)
        return wake

    def _serve_safe(self, mb: MicroBatch) -> list[ServeResult]:
        """Containment boundary: a fault anywhere in one microbatch's
        warmup or solve (a model exception, an injected failure, a
        runtime error at the host read) fails ONLY this
        bucket's requests — queue and other buckets are untouched."""
        try:
            return self._serve(mb)
        except Exception as err:
            self._note_failure(bucket_label(mb.key))
            results = []
            for req in mb.requests:
                results.extend(self._fail(req, err, numerics=False))
            return results

    # ------------------------------------------------------------ serving
    def warmup_bucket(self, mb: MicroBatch) -> None:
        """Build (and on the card capture) this microbatch's executor if
        not already warm.

        The per-request cond prototype comes from the bucket's first
        request (all requests in a bucket share cond structure — it is
        part of the bucket key); under guidance the captured graph
        already carries the doubled network lane count."""
        ident = (mb.key, mb.size)
        if ident in self._warmed:
            return
        plan = build_plan(mb.spec)
        warmup(plan, self.model_fn, mb.shape, getattr(torch, mb.dtype),
               batch=mb.size, cond=mb.requests[0].cond,
               trajectory=self.stream, device=self.device, mesh=self.mesh,
               data_axis=self.data_axis, cfg_axis=self.cfg_axis)
        self._warmed.add(ident)
        self._stats["warmups"] += 1

    def step(self) -> list[ServeResult]:
        """Serve one scheduling unit; [] when idle (or mid-solve).

        Under ``scheduler="solve"`` that is one whole microbatch (oldest
        bucket first); under ``"step"`` it is ONE solver step of one
        running batch — joins, leaves, and merges happen between calls.
        """
        if self._batcher is not None:
            return self._batcher.tick()
        if not self._queue:
            return []
        eligible, _ = self._eligible()
        if not eligible:
            return []  # everything is backed off / quarantined
        mb = form_microbatches(eligible, self.bucket_sizes)[0]
        taken = set(id(r) for r in mb.requests)
        self._queue = [r for r in self._queue if id(r) not in taken]
        return self._serve_safe(mb)

    def run(self) -> list[ServeResult]:
        """Drain the queue; results in service order (completion order
        under the step scheduler).

        Under the solve scheduler, microbatches are formed once per drain
        pass (linear in queue length, unlike repeated ``step()`` which
        regroups the remaining queue each call); requests submitted from
        ``on_result`` callbacks are picked up by the next pass.
        """
        if self._batcher is not None:
            return self._batcher.run()
        out: list[ServeResult] = []
        while self._queue:
            eligible, held = self._eligible()
            if not eligible:
                # everything is backed off or quarantined — sleep until
                # the earliest becomes admittable instead of spinning
                wake = self._next_wake()
                if wake == float("inf"):
                    break
                wait = wake - time.monotonic()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
                continue
            self._queue = held  # retries from _serve_safe append here
            for mb in form_microbatches(eligible, self.bucket_sizes):
                out.extend(self._serve_safe(mb))
        return out

    def _lane_draws(self, rid: int, attempt: int, shape, M: int):
        """One lane's unit-normal initial latent and [M, *shape] step noise
        on the engine's device: the injected ``draws`` or the generators
        seeded by (seed, rid, attempt), as the step scheduler draws them."""
        if self._draws is not None:
            z, noise = self._draws(rid, attempt, shape, M)
            return (torch.as_tensor(z, dtype=torch.float32).to(self.device),
                    torch.as_tensor(noise, dtype=torch.float32).to(
                        self.device))
        return request_draws(self._noise_seed, self._solve_seed, rid,
                             attempt, shape, M, self.device)

    def _serve(self, mb: MicroBatch) -> list[ServeResult]:
        self.warmup_bucket(mb)
        spec, shape = mb.spec, mb.shape
        dtype = getattr(torch, mb.dtype)
        plan = build_plan(spec)
        rids = mb.rids()

        t0 = time.perf_counter()
        attempts = [r.attempt for r in mb.requests] + [0] * mb.n_padded
        scale = spec.resolve_schedule().prior_scale(float(plan.ts[0]))
        draws = [self._lane_draws(rid, a, shape, spec.n_steps)
                 for rid, a in zip(rids, attempts)]
        x_T = (scale * torch.stack([z for z, _ in draws])).to(dtype)
        noise = torch.stack([n for _, n in draws])
        if self._inject is not None:
            x_T = self._inject.on_solve(self._stats["microbatches"],
                                        mb, x_T)
        if self.mesh is not None:
            out = sample_sharded(
                plan, self.model_fn, x_T, noise=noise, mesh=self.mesh,
                data_axis=self.data_axis, cfg_axis=self.cfg_axis,
                cond=mb.stacked_cond(self.device),
                guidance_scale=mb.scales(), trajectory=self.stream)
        else:
            out = sample_batched(
                plan, self.model_fn, x_T, noise=noise,
                cond=mb.stacked_cond(self.device),
                guidance_scale=mb.scales(), trajectory=self.stream)
        if self.stream:
            x0, traj = out
            previews = traj["x0"]
        else:
            x0, previews = out, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self._stats["serve_s"] += dt
        self.watchdog.observe(self._stats["microbatches"], dt)

        n_real = len(mb.requests)
        self._stats["requests"] += n_real
        self._stats["microbatches"] += 1
        self._stats["padded_slots"] += mb.n_padded
        self._stats["model_evals"] += spec.nfe * n_real
        self._stats["network_evals"] += spec.network_nfe * n_real
        # per-bucket lane-step accounting, same shape of numbers as the
        # step scheduler: here every lane rides the full solve, so a
        # padded lane wastes n_steps lane-steps in one indivisible chunk
        label = bucket_label(mb.key)
        bs = self._buckets.setdefault(label, {
            "ticks": 0, "lane_steps": 0, "active_lane_steps": 0,
            "wasted_lane_steps": 0})
        bs["ticks"] += spec.n_steps
        bs["lane_steps"] += mb.size * spec.n_steps
        bs["active_lane_steps"] += n_real * spec.n_steps
        bs["wasted_lane_steps"] += mb.n_padded * spec.n_steps

        # post-solve numerical guard (the solve scheduler has no
        # in-graph per-step check — the whole solve is one dispatch —
        # so any non-zero guard_interval means "check the final latent")
        bad = np.zeros(n_real, bool)
        if self.guard_interval and n_real:
            bad = (~torch.isfinite(x0[:n_real].float()).flatten(1).all(1)
                   ).cpu().numpy()

        results = []
        for lane, req in enumerate(mb.requests):  # pad lanes dropped here
            if bad[lane]:
                self._note_failure(label)
                results.extend(self._fail(
                    req, ArithmeticError("non-finite final latent"),
                    numerics=True))
                continue
            if req.degraded_to is not None:
                self._stats["degraded"] += 1
            results.append(self._emit(ServeResult(
                rid=req.rid, x0=x0[lane],
                previews=previews[lane] if previews is not None else None,
                attempts=req.attempt + 1, degraded_to=req.degraded_to)))
            self._stats["completed"] += 1
            self._note_success(label)
        return results

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Engine counters plus a compile-cache snapshot.

        ``model_evals`` counts guided (solver-level) evaluations and
        ``network_evals`` raw network forwards — 2x under classifier-free
        guidance — for real requests only (``spec.nfe`` /
        ``spec.network_nfe`` each); padded lanes show up in
        ``padded_slots``, never in throughput. ``buckets`` breaks lane
        occupancy down per bucket: ``lane_steps`` (compute spent),
        ``active_lane_steps`` (compute that served a request),
        ``wasted_lane_steps`` (padded / free lanes that computed anyway),
        and their ratio ``occupancy`` — the same accounting the step
        scheduler reports, so the two schedulers compare directly.
        Under ``scheduler="step"`` the counters come from the
        continuous batcher (``completed``, ``shed``, ``joins``,
        ``migrations``, ``ticks``, per-tick-exact ``model_evals``).
        """
        if self._batcher is not None:
            s = self._batcher.stats()
            s["compile_cache"] = compile_cache_stats()
            return s
        s = dict(self._stats)
        s["callback_error_messages"] = list(self._callback_errs)
        s["straggler_events"] = len(self.watchdog.events)
        dt = s["serve_s"]
        s["requests_per_s"] = s["requests"] / dt if dt > 0 else 0.0
        s["model_evals_per_s"] = s["model_evals"] / dt if dt > 0 else 0.0
        s["network_evals_per_s"] = s["network_evals"] / dt if dt > 0 else 0.0
        buckets = {}
        for label, b in self._buckets.items():
            b = dict(b)
            b["occupancy"] = (b["active_lane_steps"] / b["lane_steps"]
                              if b["lane_steps"] else 0.0)
            buckets[label] = b
        s["buckets"] = buckets
        s["compile_cache"] = compile_cache_stats()
        return s

    def health(self) -> dict:
        """Machine-readable health snapshot — no device sync, cheap
        enough for a poll loop. ``status`` is "degraded" while any
        bucket is quarantined, else "ok"; ``quarantined`` maps bucket
        labels to seconds of cooldown remaining."""
        if self._batcher is not None:
            return self._batcher.health()
        now = time.monotonic()
        quarantined = {lbl: round(until - now, 6)
                       for lbl, until in self._quarantine.items()
                       if until > now}
        s = self._stats
        return {
            "status": "degraded" if quarantined else "ok",
            "scheduler": "solve",
            "pending": len(self._queue),
            "active": 0,  # solve dispatches are synchronous
            "running_batches": 0,
            "quarantined": quarantined,
            "consecutive_failures": dict(self._fail_streak),
            "completed": s["completed"],
            "failed": s["failed"],
            "failed_numerics": s["failed_numerics"],
            "retries": s["retries"],
            "degraded_results": s["degraded"],
            "shed": 0,
            "quarantines": s["quarantines"],
            "callback_errors": s["callback_errors"],
            "straggler_events": len(self.watchdog.events),
        }
