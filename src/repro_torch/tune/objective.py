"""Pluggable objectives for the solver-program autotuner.

An objective owns what the evaluator composes into one candidate-stacked
solve and its scores:

- the **model** the solver drives (``model_fn(convention, schedule)``),
  lane-batched: ``x`` [L, *shape], ``t`` [L] (one time per lane), or a
  :class:`~repro_torch.core.denoiser.Denoiser` over such a network;
- the **initial state** per evaluation seed (``init(spec)``: the prior
  draw, ``[n_seeds, *shape]``, shape fixed so every candidate shares one
  entry) and the **step noise** (``solve_noise(M)``: ``[n_seeds, M,
  *shape]`` float32, one row per solver step);
- the **score** (``batch_score(x0)``: a 0-d tensor over the
  ``[n_seeds, *shape]`` stack of solved sample sets, computed on the
  device; LOWER IS BETTER).

Everything is deterministic given the objective's ``seed``: the initial
states, the step noise, the target sample sets and the metric's projection
directions are drawn on the CPU from ``torch.Generator``s seeded by
``(seed, stream, lane)`` (the reference derives the same four streams by
``fold_in``) and then moved to the objective's device, so a search scores
a candidate identically on every run and on either device, and resumes
bit for bit. Threefry streams cannot be drawn with torch, so every draw
can also be injected (``init_draws``, ``noise_fn``, ``target_draws``,
``dir_draws``): tests feed the reference's own draws in through them. The
reference's step noise is ``split(key, M)`` then one normal a step, so it
differs with M (a PECE pattern spends two evaluations a step, so one NFE
gives another M): the noise source is a function of M.

:class:`GMMObjective` is the out-of-the-box oracle objective (the exact
Gaussian-mixture posterior model from :mod:`repro_torch.core.oracle`,
lane-batched, scored by sliced Wasserstein-2 against exact target draws:
the benchmark suite's FID stand-in). :class:`CallableObjective` adapts a
real backbone and any metric to the same interface.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..core.denoiser import lane_view
from ..core.metrics import sliced_w2_stat
from ..core.oracle import GMM
from ..core.samplers import SamplerSpec
from ..core.schedules import NoiseSchedule
from ..device import resolve_device

__all__ = ["Objective", "GMMObjective", "CallableObjective"]

F32 = torch.float32


def _generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU generator for draw stream ``stream`` of ``seed`` (the
    reference's ``fold_in`` path): distinct streams never share a seed."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, *stream])
    return torch.Generator().manual_seed(int(ss.generate_state(1)[0]))


def _prior(spec: SamplerSpec, z: torch.Tensor) -> torch.Tensor:
    """Unit-normal draws ``z`` scaled to the spec's terminal prior."""
    schedule = spec.resolve_schedule()
    return schedule.prior_scale(float(spec.grid_ts()[0])) * z


class Objective:
    """Interface the evaluator consumes; subclass or use the adapters.

    Attributes:
        shape: per-solve latent shape (e.g. ``(n_samples, dim)``); every
            candidate/seed solves one latent of this shape.
        n_seeds: independent solves averaged per candidate score.
        device: where the solves run (the card unless the caller asks for
            the CPU).
    """

    shape: tuple[int, ...]
    n_seeds: int
    device: Any = "cuda"

    def model_fn(self, convention: str,
                 schedule: NoiseSchedule) -> Callable:  # pragma: no cover
        """The lane-batched ``(x, t)`` model in the family's prediction
        convention."""
        raise NotImplementedError

    def cached_model_fn(self, convention: str,
                        schedule: NoiseSchedule) -> Callable:
        """A feature-cache-capable model for scoring
        ``feature_cache=("residual", thresh)`` candidates: a callable
        additionally exposing ``cached_call(x, t, feats, refresh)`` and
        ``init_feats(x)`` (the executor's cached-eval contract; ``refresh``
        is a bool or one flag per lane). Override to let the residual
        threshold join the search space; the default refuses so threshold
        candidates fail loudly rather than score a cache-less model."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement cached_model_fn; "
            "feature-cache threshold search needs an objective whose "
            "model exposes the cached-eval contract")

    def init(self, spec: SamplerSpec) -> torch.Tensor:  # pragma: no cover
        """``[n_seeds, *shape]`` initial states (the prior draw)."""
        raise NotImplementedError

    def solve_noise(self, n_steps: int) -> torch.Tensor:  # pragma: no cover
        """``[n_seeds, n_steps, *shape]`` float32 step noise."""
        raise NotImplementedError

    def batch_score(self,
                    x0: torch.Tensor) -> torch.Tensor:  # pragma: no cover
        """0-d score of ``[n_seeds, *shape]`` solves, on their device;
        lower is better. Reads nothing back to the host."""
        raise NotImplementedError

    def _device(self) -> torch.device:
        return resolve_device(self.device)


def _memo(obj, key, make):
    """``make()`` cached on ``obj`` under ``key`` (a frozen dataclass keeps
    its draws in the non-compared ``_draws`` dict)."""
    cache = obj._draws
    if key not in cache:
        cache[key] = make()
    return cache[key]


def _seed_noise(seed: int, n_seeds: int, n_steps: int, shape) -> torch.Tensor:
    """Lane s's M step normals from stream (seed, 1, s)."""
    return torch.stack([
        torch.randn((n_steps,) + tuple(shape),
                    generator=_generator(seed, 1, s))
        for s in range(n_seeds)])


def lane_oracle(gmm: GMM, schedule: NoiseSchedule,
                convention: str = "data") -> Callable:
    """The GMM's exact ``(x, t)`` model, lane-batched: ``x`` [L, *batch, d]
    and ``t`` [L] (or 0-d). The posterior runs with ``t`` viewed against
    the mixture's [K, d] axes, so each lane's output is the oracle's at its
    own time, element for element."""
    conv = {"data": "x0", "x0": "x0", "noise": "eps", "eps": "eps",
            "v": "v"}[convention]

    def fn(x, t):
        tk = t.reshape(tuple(t.shape) + (1,) * x.dim()) if t.dim() else t
        x0 = gmm.x0_prediction(schedule, x, tk)
        if conv == "x0":
            return x0
        tl = lane_view(t, x)
        a, s = schedule.alpha_d(tl), schedule.sigma_d(tl)
        eps = (x - a * x0) / s
        return eps if conv == "eps" else a * eps - s * x0

    return fn


@dataclasses.dataclass(frozen=True)
class GMMObjective(Objective):
    """GMM-oracle sliced-W2: the solver is the ONLY error source, so the
    score isolates exactly what a step program can influence.

    ``init_draws`` ([n_seeds, *shape] unit normals, scaled here by the
    prior), ``noise_fn`` (``M -> [n_seeds, M, *shape]``), ``target_draws``
    ([n_seeds, n_samples, dim]) and ``dir_draws`` ([n_seeds, n_proj, dim]
    raw directions) replace the objective's own draws."""

    gmm: GMM = dataclasses.field(default_factory=GMM.default_2d)
    n_samples: int = 512
    n_seeds: int = 4
    n_proj: int = 64
    seed: int = 0
    device: Any = "cuda"
    init_draws: Any = dataclasses.field(default=None, compare=False)
    noise_fn: Callable | None = dataclasses.field(default=None, compare=False)
    target_draws: Any = dataclasses.field(default=None, compare=False)
    dir_draws: Any = dataclasses.field(default=None, compare=False)
    _draws: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.n_samples, self.gmm.dim)

    def model_fn(self, convention: str, schedule: NoiseSchedule) -> Callable:
        return lane_oracle(self.gmm, schedule, convention)

    def cached_model_fn(self, convention: str,
                        schedule: NoiseSchedule) -> Callable:
        """Prediction-reuse wrapper over the oracle: on refresh steps the
        real model runs and its prediction is stored as the feature
        state; on skipped steps the stored prediction is returned
        verbatim. The oracle has no intermediate features to cache, so
        this is the degenerate-but-faithful cache: skipping a step
        reuses a stale prediction, which is exactly the quality/NFE
        trade a residual threshold modulates. ``refresh`` is a host bool
        (the plan's refresh steps, the PECE re-evaluation) or one device
        flag per lane (the residual's decision)."""
        base = lane_oracle(self.gmm, schedule, convention)

        def fn(x, t):
            return base(x, t)

        def cached_call(x, t, feats, refresh):
            if isinstance(refresh, bool):
                pred = base(x, t).to(F32) if refresh else feats
            else:
                pred = torch.where(lane_view(refresh, x), base(x, t).to(F32),
                                   feats)
            return pred, pred

        fn.cached_call = cached_call
        fn.init_feats = lambda x: torch.zeros(x.shape, dtype=F32,
                                              device=x.device)
        return fn

    def init(self, spec: SamplerSpec) -> torch.Tensor:
        def make():
            z = self.init_draws
            if z is None:
                z = torch.randn((self.n_seeds,) + self.shape,
                                generator=_generator(self.seed, 0))
            return torch.as_tensor(z, dtype=F32)
        z = _memo(self, "init", make)
        return _prior(spec, z).to(self._device())

    def solve_noise(self, n_steps: int) -> torch.Tensor:
        def make():
            if self.noise_fn is not None:
                xi = self.noise_fn(n_steps)
            else:
                xi = _seed_noise(self.seed, self.n_seeds, n_steps, self.shape)
            return torch.as_tensor(xi, dtype=F32).to(self._device())
        return _memo(self, ("noise", n_steps), make)

    def targets(self) -> torch.Tensor:
        """``[n_seeds, n_samples, dim]`` exact target draws (one set per
        seed, so the metric's sampling noise averages out too)."""
        def make():
            y = self.target_draws
            if y is None:
                g = _generator(self.seed, 2)
                y = torch.stack([self.gmm.sample(g, self.n_samples)
                                 for _ in range(self.n_seeds)])
            return torch.as_tensor(y, dtype=F32).to(self._device())
        return _memo(self, "targets", make)

    def directions(self) -> torch.Tensor:
        """``[n_seeds, n_proj, dim]`` raw projection directions, one set
        per seed."""
        def make():
            d = self.dir_draws
            if d is None:
                d = torch.randn((self.n_seeds, self.n_proj, self.gmm.dim),
                                generator=_generator(self.seed, 3))
            return torch.as_tensor(d, dtype=F32).to(self._device())
        return _memo(self, "dirs", make)

    def batch_score(self, x0: torch.Tensor) -> torch.Tensor:
        y, dirs = self.targets(), self.directions()
        per_seed = [sliced_w2_stat(x0[s].to(F32), y[s], dirs[s])
                    for s in range(self.n_seeds)]
        return torch.mean(torch.stack(per_seed))


@dataclasses.dataclass(frozen=True)
class CallableObjective(Objective):
    """Adapter for real backbones / custom metrics.

    Args:
        model: ``(convention, schedule) -> model_fn`` factory, or a
            lane-batched ``(x, t)`` callable (or a Denoiser) already
            speaking every requested convention (e.g. a data-prediction
            net tuned with data-convention families only).
        score: ``(x0 [n_seeds, *shape]) -> 0-d tensor`` on the device,
            lower is better.
        shape: per-solve latent shape.
        init_fn: optional ``(spec, n_seeds) -> [n_seeds, *shape]`` initial
            states; defaults to the schedule-scaled unit-normal prior.
        noise_fn: optional ``M -> [n_seeds, M, *shape]`` step noise;
            defaults to the objective's own seeded draws.
        n_seeds / seed: evaluation replication and RNG base.
        device: where the solves run.
    """

    model: Any = None
    score: Callable[[torch.Tensor], torch.Tensor] = None
    shape: tuple[int, ...] = ()
    init_fn: Callable | None = None
    n_seeds: int = 2
    seed: int = 0
    device: Any = "cuda"
    noise_fn: Callable | None = dataclasses.field(default=None, compare=False)
    _draws: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def model_fn(self, convention: str, schedule: NoiseSchedule) -> Callable:
        try:
            fn = self.model(convention, schedule)
            if callable(fn):
                return fn
        except TypeError:  # a model (or a Denoiser), not a factory
            pass
        return self.model

    def init(self, spec: SamplerSpec) -> torch.Tensor:
        if self.init_fn is not None:
            return torch.as_tensor(self.init_fn(spec, self.n_seeds)).to(
                self._device())
        z = _memo(self, "init", lambda: torch.randn(
            (self.n_seeds,) + tuple(self.shape),
            generator=_generator(self.seed, 0)))
        return _prior(spec, z).to(self._device())

    def solve_noise(self, n_steps: int) -> torch.Tensor:
        def make():
            xi = (self.noise_fn(n_steps) if self.noise_fn is not None else
                  _seed_noise(self.seed, self.n_seeds, n_steps, self.shape))
            return torch.as_tensor(xi, dtype=F32).to(self._device())
        return _memo(self, ("noise", n_steps), make)

    def batch_score(self, x0: torch.Tensor) -> torch.Tensor:
        return self.score(x0)
