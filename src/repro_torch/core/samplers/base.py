"""Plan/execute sampler API.

1. **Spec**: a frozen, hashable :class:`SamplerSpec` naming a registered
   sampler family plus its hyperparameters. ``SamplerSpec.from_nfe``
   converts a model-evaluation budget into the family's step count.
2. **Plan**: :func:`build_plan` runs the family's host-side float64
   precompute (timestep grid, coefficient tables) and packages it as a
   :class:`SamplerPlan` whose ``arrays`` are f32 tensors, copied once to
   each device a solve runs on.
3. **Execute**: :func:`sample` runs the family's executor eagerly: a
   Python loop over the steps on the device of ``x_T``.

The model argument is a plain ``model_fn(x, t)`` already speaking the
plan's parameterization, or a :class:`repro_torch.core.denoiser.Denoiser`
wrapping a raw eps-/x0-/v-prediction network (optionally under
classifier-free guidance, optionally with a feature-cached companion),
bound to the per-call ``cond`` and ``guidance_scale``.

The per-step Gaussian noise is injectable: ``noise`` is a callable
``step -> xi`` (float32, the shape of ``x_T``, on its device). By default
it draws from a :class:`torch.Generator` on ``x_T``'s device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..denoiser import Denoiser, canonical_prediction, convert_prediction
from ..schedules import NoiseSchedule, get_schedule, timestep_grid

__all__ = [
    "PRECISIONS", "carry_dtype", "SamplerSpec", "SamplerPlan",
    "SamplerFamily", "Sampler", "register_sampler", "get_family",
    "make_sampler", "list_samplers", "build_plan", "sample",
]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[[int], torch.Tensor]

#: legal values of ``SamplerSpec.precision``
PRECISIONS = ("f32", "bf16")


def carry_dtype(precision: str) -> torch.dtype:
    """Carried-state dtype of the precision policy: step arithmetic
    accumulates in f32 either way; at "bf16" only the carried state,
    history and model input narrow."""
    if precision not in PRECISIONS:
        raise ValueError(
            f"precision={precision!r}; expected one of {PRECISIONS}")
    return torch.bfloat16 if precision == "bf16" else torch.float32


# --------------------------------------------------------------------- spec
@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    """Frozen, hashable description of one configured sampler.

    Families read the subset of fields they understand. ``schedule`` is a
    registry name ("vp_linear") or a frozen :class:`NoiseSchedule`.
    ``ts`` overrides the (grid, n_steps) construction with an explicit
    decreasing grid.
    """

    name: str = "sa"
    schedule: Any = "vp_linear"
    n_steps: int = 20
    grid: str = "logsnr"  # "time" | "logsnr" | "karras"
    rho: float = 7.0
    t_start: float | None = None
    t_end: float | None = None
    ts: tuple[float, ...] | None = None
    parameterization: str = "data"  # "data" | "noise"
    # SA-Solver family
    tau: Any = 1.0  # float or TauSchedule
    predictor_order: int = 3
    corrector_order: int = 3
    mode: str = "PEC"  # "PEC" | "PECE"
    #: optional :class:`repro_torch.core.programs.StepProgram`: per-interval
    #: (predictor order, corrector order, P/PEC/PECE mode, tau) tracks.
    #: When set it shadows tau/predictor_order/corrector_order/mode above.
    #: Per-interval orders and taus are table *data*; only the mode
    #: pattern reaches the executor statics. A program pinning constant
    #: order and tau is bitwise identical to the fixed-spec path.
    program: Any = None
    #: "einsum" (one torch.einsum contraction), "kernel" (the sa_update
    #: kernel), or "fused" (the dual-output predictor+corrector kernel:
    #: one pass over x/xi/history, ring history only)
    combine: str = "einsum"
    #: evaluation-history layout: "ring" (fixed ring buffer, one row
    #: written per step) or "concat" (the seed layout that re-stacks the
    #: buffer every step; kept as the regression baseline)
    history: str = "ring"
    denoise_final: bool = True
    #: "f32", or "bf16" to carry the state and history (and feed the
    #: model) in bfloat16 with f32 accumulation in every combine
    precision: str = "f32"
    # DDIM family
    eta: float = 0.0
    # EDM stochastic family
    s_churn: float = 40.0
    s_tmin: float = 0.05
    s_tmax: float = 50.0
    s_noise: float = 1.003
    # Denoiser adapter (see repro_torch.core.denoiser)
    #: output convention of the network behind the model argument; None
    #: means "already the plan's parameterization"
    prediction: str | None = None
    #: classifier-free guidance (requires a Denoiser)
    guidance: bool = False
    #: step-to-step backbone feature caching (needs a Denoiser built with
    #: ``cached=``): None, an int K (refresh every K-th step), or
    #: ``("residual", threshold)`` (refresh when the previous step's
    #: predictor-vs-corrector residual reaches the threshold)
    feature_cache: Any = None

    def resolve_schedule(self) -> NoiseSchedule:
        if isinstance(self.schedule, NoiseSchedule):
            return self.schedule
        return get_schedule(self.schedule)

    def grid_ts(self) -> np.ndarray:
        """The decreasing float64 solve grid ``t_0 > ... > t_M``."""
        if self.ts is not None:
            ts = np.asarray(self.ts, dtype=np.float64)
            if len(ts) != self.n_steps + 1:
                raise ValueError(
                    f"explicit ts has {len(ts)} points but n_steps="
                    f"{self.n_steps} needs {self.n_steps + 1}")
            return ts
        return timestep_grid(
            self.resolve_schedule(), self.n_steps, kind=self.grid,
            t_start=self.t_start, t_end=self.t_end, rho=self.rho)

    @property
    def nfe(self) -> int:
        """Guided (solver-level) model evaluations this spec spends."""
        return get_family(self.name).nfe_of(self)

    @property
    def network_nfe(self) -> int:
        """Raw network forwards: 2x under classifier-free guidance."""
        return self.nfe * (2 if self.guidance else 1)

    @classmethod
    def from_nfe(cls, name: str, nfe: int, **kw) -> "SamplerSpec":
        """A spec whose step count spends at most ``nfe`` evaluations
        (PEC: NFE = M + 1, PECE: 2M + 1)."""
        if nfe < 1:
            raise ValueError("nfe must be >= 1")
        n_steps = get_family(name).steps_from_nfe(nfe, kw)
        return cls(name=name, n_steps=n_steps, **kw)


# --------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True, eq=False)
class SamplerPlan:
    """Host precompute. ``arrays`` are f32 CPU tensors (copied once per
    device by :meth:`arrays_on`) and host values that stay on the host
    (a step program's per-step flags, which the executor's Python loop
    reads without a device sync); ``host`` keeps the float64 grid and
    tables; ``statics`` are the spec fields the executor branches on."""

    spec: SamplerSpec
    arrays: dict
    host: dict
    statics: tuple
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ts(self) -> np.ndarray:
        return self.host["ts"]

    def arrays_on(self, device) -> dict:
        device = torch.device(device)
        dev = self._on_device.get(device)
        if dev is None:
            dev = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                   for k, v in self.arrays.items()}
            self._on_device[device] = dev
        return dev


# ----------------------------------------------------------------- registry
@dataclasses.dataclass(frozen=True)
class SamplerFamily:
    name: str
    #: spec -> (arrays: dict[str, torch.Tensor], host: dict)
    plan: Callable[[SamplerSpec], tuple]
    #: (statics, arrays, model_fn, x_T, noise) -> x0
    execute: Callable
    #: spec -> hashable tuple of the fields the executor branches on
    statics: Callable[[SamplerSpec], tuple]
    nfe_of: Callable[[SamplerSpec], int]
    steps_from_nfe: Callable[[int, dict], int]
    #: spec -> the prediction convention the executor consumes
    model_convention: Callable[[SamplerSpec], str]
    #: whether the family consumes FULL step programs (per-interval order
    #: and mode tracks, not just the tau track): the multistep core's
    #: families do
    full_programs: bool = False
    #: whether tau is definitionally inert for this family (a
    #: deterministic family maps every tau to 0)
    tau_inert: bool = False


_REGISTRY: dict[str, SamplerFamily] = {}


def register_sampler(family: SamplerFamily) -> SamplerFamily:
    if not isinstance(family, SamplerFamily):
        raise TypeError("register_sampler takes a SamplerFamily")
    _REGISTRY[family.name] = family
    return family


def get_family(name: str) -> SamplerFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r}; registered: {list_samplers()}")


def list_samplers() -> list[str]:
    return sorted(_REGISTRY)


def build_plan(spec: SamplerSpec) -> SamplerPlan:
    """Resolve a spec into its plan (host f64 precompute, f32 arrays)."""
    family = get_family(spec.name)
    statics = family.statics(spec)  # validates the spec before planning
    arrays, host = family.plan(spec)
    if "ts" not in host:
        host["ts"] = spec.grid_ts()
    return SamplerPlan(spec=spec, arrays=arrays, host=host, statics=statics)


# -------------------------------------------------- denoiser adapter hooks
def _check_model(plan: SamplerPlan, model_fn, cond, guidance_scale) -> None:
    """Validate the model argument against the spec's denoiser fields."""
    spec = plan.spec
    if isinstance(model_fn, Denoiser):
        if bool(spec.guidance) != bool(model_fn.guidance):
            raise ValueError(
                f"spec.guidance={spec.guidance} but the Denoiser has "
                f"guidance={model_fn.guidance}; keep them consistent (the "
                "spec is what NFE accounting reads)")
        if spec.prediction is not None and \
                canonical_prediction(spec.prediction) != model_fn.prediction:
            raise ValueError(
                f"spec.prediction={spec.prediction!r} but the Denoiser "
                f"predicts {model_fn.prediction!r}")
    else:
        if spec.guidance:
            raise ValueError(
                "spec.guidance=True needs a Denoiser model (classifier-"
                "free guidance requires the cond/uncond network contract)")
        if cond is not None:
            raise ValueError(
                "conditioning requires a Denoiser model; a plain "
                "model_fn(x, t) has no cond input")
    if spec.feature_cache is not None and not (
            isinstance(model_fn, Denoiser) and model_fn.cached is not None):
        raise ValueError(
            "spec.feature_cache requires a Denoiser built with cached= (a "
            "CachedNetwork exposing the split-segment evaluation)")
    guided = isinstance(model_fn, Denoiser) and model_fn.guidance
    if not guided and float(guidance_scale) != 1.0:
        raise ValueError(
            "guidance_scale has no effect without a guidance-enabled "
            "Denoiser; wrap the network in Denoiser(..., guidance=True) "
            "and set spec.guidance")


def _bind_model(plan: SamplerPlan, model_fn, cond, scale) -> ModelFn:
    """The executor-facing ``model_fn(x, t)``: a Denoiser bound to the
    plan's convention and this call's cond/scale, or a plain model whose
    output ``spec.prediction`` names, converted to the plan's convention.
    A Denoiser with a feature-cached companion also carries
    ``cached_call(x, t, feats, refresh) -> (pred, feats)`` and
    ``init_feats(x)`` for the feature-caching executor."""
    target = get_family(plan.spec.name).model_convention(plan.spec)
    if isinstance(model_fn, Denoiser):
        fn = model_fn.as_model_fn(target, cond, scale)
        if model_fn.cached is not None:
            fn.cached_call = model_fn.as_cached_model_fn(target, cond, scale)
            fn.init_feats = model_fn.init_feats
        return fn
    pred = plan.spec.prediction
    if pred is not None and \
            canonical_prediction(pred) != canonical_prediction(target):
        schedule = plan.spec.resolve_schedule()
        return lambda x, t: convert_prediction(model_fn(x, t), x, t, pred,
                                               target, schedule)
    return model_fn


def gaussian_noise(shape, generator: torch.Generator) -> NoiseFn:
    """The default noise source: one float32 standard normal of ``shape``
    per step, drawn on ``generator``'s device."""
    return lambda step: torch.randn(shape, generator=generator,
                                    device=generator.device,
                                    dtype=torch.float32)


# -------------------------------------------------------------- entrypoint
def sample(plan: SamplerPlan, model_fn, x_T: torch.Tensor,
           generator: torch.Generator | None = None, *,
           noise: NoiseFn | None = None, cond=None, guidance_scale=1.0,
           trajectory: bool = False) -> torch.Tensor:
    """Run one sampler end to end, ``x_T -> x_0``, on ``x_T``'s device.

    ``noise`` (``step -> xi``) replaces the default per-step Gaussian
    draws from ``generator`` (a fresh generator seeded 0 on ``x_T``'s
    device when None). ``cond`` and ``guidance_scale`` are forwarded to a
    :class:`Denoiser` model.
    """
    if trajectory:
        raise NotImplementedError(
            "trajectory previews come with the serving slice of the "
            "PyTorch port (stepwise/serve); call sample() without "
            "trajectory=True")
    _check_model(plan, model_fn, cond, guidance_scale)
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=x_T.device).manual_seed(0)
        noise = gaussian_noise(x_T.shape, generator)
    family = get_family(plan.spec.name)
    return family.execute(plan.statics, plan.arrays_on(x_T.device),
                          _bind_model(plan, model_fn, cond, guidance_scale),
                          x_T, noise)


# ------------------------------------------------------------ bound sampler
class Sampler:
    """A spec bound to its plan: ``make_sampler("sa", nfe=20, tau=0.4)``
    plans once, then ``.sample`` runs solves."""

    def __init__(self, spec: SamplerSpec):
        self.spec = spec
        self.plan = build_plan(spec)
        self.schedule = spec.resolve_schedule()

    @property
    def nfe(self) -> int:
        return self.spec.nfe

    def sample(self, model_fn, x_T: torch.Tensor,
               generator: torch.Generator | None = None, *,
               noise: NoiseFn | None = None, cond=None, guidance_scale=1.0,
               trajectory: bool = False) -> torch.Tensor:
        return sample(self.plan, model_fn, x_T, generator, noise=noise,
                      cond=cond, guidance_scale=guidance_scale,
                      trajectory=trajectory)

    def init_noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        """x_T ~ N(0, prior_scale^2 I), float32 on ``generator``'s device."""
        scale = self.schedule.prior_scale(float(self.plan.ts[0]))
        return scale * torch.randn(shape, generator=generator,
                                   device=generator.device)

    def __repr__(self) -> str:
        return f"Sampler({self.spec!r})"


def make_sampler(name: str, **kw) -> Sampler:
    """Registry front door. ``nfe=`` routes through ``SamplerSpec.from_nfe``;
    all other keywords are ``SamplerSpec`` fields."""
    if "nfe" in kw:
        spec = SamplerSpec.from_nfe(name, kw.pop("nfe"), **kw)
    else:
        spec = SamplerSpec(name=name, **kw)
    return Sampler(spec)
