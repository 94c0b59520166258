"""Plan/execute sampler API.

1. **Spec**: a frozen, hashable :class:`SamplerSpec` naming a registered
   sampler family plus its hyperparameters. ``SamplerSpec.from_nfe``
   converts a model-evaluation budget into the family's step count.
2. **Plan**: :func:`build_plan` runs the family's host-side float64
   precompute (timestep grid, coefficient tables) and packages it as a
   :class:`SamplerPlan` whose ``arrays`` are f32 tensors, copied once to
   each device a solve runs on.
3. **Execute**: :func:`sample` runs the family's executor through the
   compile cache: an LRU of entries keyed on the family, its statics, the
   latent's shape, dtype and device, a weak identity of the model, the
   model adapter's statics and the shape of ``cond``. An entry holds the
   solve's inputs as device buffers (the plan's tables, ``x_T``, the
   noise, ``cond`` and the guidance scale), which each call copies into.
   On a CUDA device it captures the solve as a CUDA graph, one per graph
   signature (the tables' shapes and the host flags the executor's loop
   branches on), and replays it; so a re-plan at one step count (another
   tau, program or grid) replays the same graph. On the CPU the entry
   runs the eager executor over the same buffers. :func:`warmup` builds
   an entry (and its graph) ahead of the first call;
   :func:`compile_cache_stats` counts hits, misses, evictions, eager
   calls (``aot_fallbacks``) and captured graphs.

The model argument is a plain ``model_fn(x, t)`` already speaking the
plan's parameterization, or a :class:`repro_torch.core.denoiser.Denoiser`
wrapping a raw eps-/x0-/v-prediction network (optionally under
classifier-free guidance, optionally with a feature-cached companion),
bound to the entry's ``cond`` and guidance-scale buffers.

The per-step Gaussian noise is one float32 ``[M, *x_T.shape]`` buffer,
row i for step i (the reference draws ``split(key, M)`` and one normal per
step). By default it is drawn at once from a :class:`torch.Generator` on
``x_T``'s device; ``noise=`` gives it as such a tensor, or as a callable
``step -> xi`` called for every step before the solve.

Serving entry points: ``sample(trajectory=True)`` also returns the
per-step states and denoised previews (``{"x", "x0"}``, each
``[M, *x_T.shape]``), written into per-step buffers of the entry (so a
replayed graph reads nothing back). :func:`sample_batched` solves K
requests, each with its own ``x_T``, noise, ``cond`` and guidance scale,
as ONE solve over the stacked lanes: every lane is at the same step with
the same tables, so the one-coefficient combine kernels apply, and the
model is called lane-batched (``x`` [K, *shape], ``t`` [K]; see
:mod:`repro_torch.core.denoiser`). The trajectory flag and the lane count
join the cache key, as in the reference.

Sharded entry points: :func:`sample_sharded` runs ``sample_batched`` over
the ``data`` axis of a named :class:`torch.distributed.device_mesh.
DeviceMesh` (``repro_torch.launch.mesh``): every rank is called with the
global request batch, solves its own share of the lanes through the same
lane-batched entry, and gathers the result over the data axis, so every
rank returns the global batch. ``cfg_axis`` names a size-2 axis that
carries the guided pair (sharded classifier-free guidance, one branch a
rank; see :mod:`repro_torch.core.denoiser`). The mesh's identity joins the
cache key.

The autotuner's entry point: :func:`stacked_solve` solves L lanes, each
under its OWN plan (a chunk of candidate programs, each repeated over its
evaluation seeds), as one solve through one lane-batched entry: the
counterpart of the reference's ``vmap`` over stacked ``plan.arrays``. The
plans must share their statics, step count, grid and table shapes (orders
and taus are table data); their tables are stacked on a lane axis
(:func:`stack_plans`) that the executors read per lane, and the combines
go through the lane entries of the combine kernels. The lane count and
the stacked flag join the cache key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import types
import weakref
from collections import OrderedDict
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ...device import resolve_device
from ...distributed import all_gather
from ...kernels import ops
from ..denoiser import Denoiser, canonical_prediction, convert_prediction
from ..schedules import NoiseSchedule, get_schedule, timestep_grid

__all__ = [
    "PRECISIONS", "carry_dtype", "SamplerSpec", "SamplerPlan",
    "SamplerFamily", "Sampler", "register_sampler", "get_family",
    "make_sampler", "list_samplers", "build_plan", "sample", "warmup",
    "sample_batched", "sample_sharded", "compile_cache_stats",
    "clear_compile_cache", "eager", "cond_struct",
]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
#: a float32 [M, *x_T.shape] tensor, or a callable ``step -> xi``
Noise = Any

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

    def replace(self, **kw) -> "SamplerSpec":
        return dataclasses.replace(self, **kw)

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
    #: (statics, arrays, model_fn, x_T, noise, traj) -> x0; ``traj`` is
    #: None or the ``{"x", "x0"}`` per-step buffers the solve writes
    execute: Callable
    #: spec -> hashable tuple of the fields the executor branches on
    statics: Callable[[SamplerSpec], tuple]
    nfe_of: Callable[[SamplerSpec], int]
    steps_from_nfe: Callable[[int, dict], int]
    #: spec -> the prediction convention the executor consumes
    model_convention: Callable[[SamplerSpec], str] = lambda spec: "data"
    #: spec -> :class:`repro_torch.core.samplers.stepwise.StepAdapter`, or
    #: None when the family has no step-granular executor (whole solves
    #: only; the step scheduler refuses it)
    stepwise: Callable | None = None
    #: whether the family's executors dispatch the Denoiser's cached
    #: (split-segment) evaluation; ``spec.feature_cache`` is refused
    #: otherwise (the knob would be silently inert)
    supports_feature_cache: bool = False
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
def check_feature_cache_family(spec: SamplerSpec) -> None:
    """Refuse ``spec.feature_cache`` on a family whose executors never
    dispatch the cached evaluation (the reference's capability gate)."""
    if spec.feature_cache is not None and \
            not get_family(spec.name).supports_feature_cache:
        raise ValueError(
            f"feature_cache is not supported by the {spec.name!r} family "
            "(its executors never dispatch the cached eval, so the knob "
            "would be silently inert); use a multistep-core family (sa, "
            "seeds, dpmpp_multistep)")


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
    check_feature_cache_family(spec)
    if spec.feature_cache is not None and not (
            isinstance(model_fn, Denoiser) and model_fn.cached is not None
            or _has_cached_eval(model_fn)):
        raise ValueError(
            "spec.feature_cache requires a Denoiser built with cached= (a "
            "CachedNetwork exposing the split-segment evaluation), or a "
            "model exposing cached_call and init_feats")
    guided = isinstance(model_fn, Denoiser) and model_fn.guidance
    if not guided and not isinstance(guidance_scale, torch.Tensor) and \
            bool((np.asarray(guidance_scale, dtype=np.float64) != 1.0).any()):
        # a host-side check only: a tensor scale is not read back (a
        # non-unity tensor scale without a guided Denoiser is inert)
        raise ValueError(
            "guidance_scale has no effect without a guidance-enabled "
            "Denoiser; wrap the network in Denoiser(..., guidance=True) "
            "and set spec.guidance")


def _has_cached_eval(model_fn) -> bool:
    """A plain model that carries the executor's cached-eval contract
    itself (``cached_call(x, t, feats, refresh) -> (pred, feats)`` and
    ``init_feats(x)``), as the autotuner's objectives build it."""
    return (not isinstance(model_fn, Denoiser)
            and hasattr(model_fn, "cached_call")
            and hasattr(model_fn, "init_feats"))


def _adapter_statics(plan: SamplerPlan, model_fn) -> tuple | None:
    """What the model's binding computes, for the cache key: None for a
    model already speaking the plan's convention, a tuple for a Denoiser
    binding or a plain model's prediction-type conversion."""
    target = get_family(plan.spec.name).model_convention(plan.spec)
    if isinstance(model_fn, Denoiser):
        return model_fn.statics(target)
    pred = plan.spec.prediction
    if pred is not None and \
            canonical_prediction(pred) != canonical_prediction(target):
        return ("convert", canonical_prediction(pred),
                canonical_prediction(target), plan.spec.resolve_schedule())
    return None


def _bind_model(m, adapter, cond, scale, lanes: bool = False,
                cfg_group=None) -> ModelFn:
    """The executor-facing ``model_fn(x, t)``: a Denoiser bound to the
    plan's convention and the entry's cond and scale buffers, or a plain
    model whose output the adapter converts. A Denoiser with a
    feature-cached companion also carries ``cached_call(x, t, feats,
    refresh) -> (pred, feats)`` and ``init_feats(x)`` for the
    feature-caching executor. ``lanes``: the executor passes the one 0-d
    time of a solve over stacked lanes, and the lane-batched model gets it
    as [L], one per lane; the bound function's ``lanes`` attribute tells
    the executor (whose feature cache then decides its refresh per
    lane). ``cfg_group`` (the process group of a mesh's cfg axis) asks
    the Denoiser for sharded classifier-free guidance, as the reference's
    ``cfg_shard``."""
    fn = _bind_plain(m, adapter, cond, scale, cfg_group)
    if not lanes:
        return fn

    def lane_fn(x, t):
        return fn(x, t.expand(x.shape[0]))

    lane_fn.lanes = True

    if hasattr(fn, "cached_call"):
        cached = fn.cached_call
        lane_fn.cached_call = lambda x, t, feats, refresh: cached(
            x, t.expand(x.shape[0]), feats, refresh)
        lane_fn.init_feats = fn.init_feats
    return lane_fn


def _bind_plain(m, adapter, cond, scale, cfg_group=None) -> ModelFn:
    if adapter is None:
        return m
    if adapter[0] == "denoiser":
        fn = m.as_model_fn(adapter[3], cond, scale, cfg_group)
        if m.cached is not None:
            fn.cached_call = m.as_cached_model_fn(adapter[3], cond, scale,
                                                  cfg_group)
            fn.init_feats = functools.partial(m.init_feats,
                                              cfg_group=cfg_group)
        return fn
    _, src, dst, schedule = adapter  # a plain model, its output converted
    return lambda x, t: convert_prediction(m(x, t), x, t, src, dst, schedule)


def cond_struct(cond):
    """The part of ``cond`` that keys an entry (and a serving bucket): its
    shape and dtype; its values are data, copied into the entry's buffer.
    The one definition both layers share, so the compile-cache key and the
    bucket key never hash a cond differently."""
    if cond is None:
        return None
    return (tuple(cond.shape), str(cond.dtype))


def _check_lanes(plan: SamplerPlan, model_fn, cond, lanes: int) -> None:
    """Refuse a per-lane cond that a lane-batched solve cannot take: one
    not stacked per lane, or one a guided Denoiser would not read per
    lane."""
    if cond is None:
        return
    if cond.dim() < 1 or cond.shape[0] != lanes:
        raise ValueError(
            f"cond of shape {tuple(cond.shape)}: a lane-batched solve takes "
            f"one cond per lane, [{lanes}, ...]")
    if isinstance(model_fn, Denoiser) and model_fn.guidance and \
            model_fn.cond_rank is None:
        raise ValueError(
            "a per-lane cond under guidance needs Denoiser(cond_rank=...): "
            "without it the guided pair would share the whole [L, ...] "
            "cond across the batch")


# ------------------------------------------------------------ compile cache
_COMPILE_CACHE_MAX = 64
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0, "aot_fallbacks": 0,
                "graphs": 0, "eager_entries": 0}
#: depth of nested :func:`eager` contexts
_EAGER_DEPTH = 0
#: per CUDA device: the side stream that warms and captures every graph,
#: and the memory pool all of the cache's graphs share
_STREAMS: dict = {}
_POOLS: dict = {}


def compile_cache_stats() -> dict:
    """``hits``/``misses``/``evictions`` as the reference counts them;
    ``aot_fallbacks``: calls that did not run the entry's CUDA graph
    (calls inside :func:`eager`), on any device; ``graphs``: CUDA graphs
    captured; ``eager_entries``: entries built to run eager on every
    device (a cfg-sharded entry exchanges the guided pair inside every
    evaluation, which no graph captures yet); ``size``: live entries."""
    return dict(_CACHE_STATS, size=len(_COMPILE_CACHE))


def clear_compile_cache() -> None:
    _CACHE.clear()


@contextlib.contextmanager
def eager():
    """Inside this context every :func:`sample` runs the eager executor
    over its entry's buffers (counted in ``aot_fallbacks``) and nothing is
    captured: the analog of ``jax.disable_jit()``, for code that must see
    each kernel call run (a check that reads a call's result back)."""
    global _EAGER_DEPTH
    _EAGER_DEPTH += 1
    try:
        yield
    finally:
        _EAGER_DEPTH -= 1


def graph_stream(device) -> torch.cuda.Stream:
    """The side stream that warms and captures every CUDA graph on
    ``device`` (the compile cache's and the step protocol's), whose
    shared memory pool is ``_POOLS[device]``."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return stream


def drop_graph_stream(device) -> None:
    """After a failed capture: the capture never ended cleanly, so the
    caching allocator still routes allocations into the shared pool (and
    every later capture into it would fail, "already recording to
    mempool_id"; a memory pool destroyed later, such as the conditional
    bodies' of ``kernels.graph_gate``, would abort the process on it).
    The routing is ended here, and the next capture gets a fresh side
    stream and pool; graphs captured before keep the old pool alive."""
    _STREAMS.pop(device, None)
    pool = _POOLS.pop(device, None)
    end = getattr(torch._C, "_cuda_endAllocateToPool", None)
    if pool is not None and end is not None:
        try:
            end(device.index, pool)
        except RuntimeError:  # the capture's own end got that far
            pass


def capture_graph(fn, device, what: str):
    """One eager call of ``fn`` on ``device``'s side stream (it builds the
    kernels, loads their libraries and sets up cuBLAS and the kernels'
    attributes, none of which may run in a capture), then the capture of a
    second call into a CUDA graph in the shared pool. Returns ``(eager
    result, graph, the captured call's result, launches)``: ``launches``
    are the kernel launches the capture recorded, taken back from the
    counts (the capture launched nothing; each replay adds them), while
    the eager call's stay counted. A failed capture raises, naming
    ``what``, and gives the next capture a fresh stream and pool."""
    stream = graph_stream(device)
    current = torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        first = fn()
    current.wait_stream(stream)
    if isinstance(first, torch.Tensor):
        first.record_stream(current)
    graph = torch.cuda.CUDAGraph()
    before = ops.launch_counts()
    collecting = gc.isenabled()
    gc.disable()  # no weakref eviction frees a graph mid-capture
    try:
        with torch.cuda.graph(graph, pool=_POOLS[device], stream=stream):
            out = fn()
    except RuntimeError as e:
        drop_graph_stream(device)
        raise RuntimeError(f"CUDA graph capture of {what} failed: {e}") from e
    finally:
        if collecting:
            gc.enable()
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        ops.add_launches({k: -n for k, n in launches.items()})
    return first, graph, out, launches


class _Run:
    """One graph signature of an entry: the plan's tables as device
    buffers (host flags kept as they are), the noise buffer, the per-step
    trajectory buffers of a ``trajectory`` entry, and on a CUDA device the
    captured graph, its output buffer and the kernel launches one replay
    makes."""

    __slots__ = ("arrays", "noise", "traj", "plan", "graph", "out",
                 "launches")

    def __init__(self, plan: SamplerPlan, x: torch.Tensor, trajectory: bool):
        self.arrays = {k: torch.empty_like(v, device=x.device)
                       if isinstance(v, torch.Tensor) else v
                       for k, v in plan.arrays.items()}
        rows = (plan.spec.n_steps,) + tuple(x.shape)
        self.noise = torch.zeros(rows, dtype=torch.float32, device=x.device)
        cdt = carry_dtype(plan.spec.precision)
        self.traj = {k: torch.zeros(rows, dtype=cdt, device=x.device)
                     for k in ("x", "x0")} if trajectory else None
        self.plan = None  # weak reference to the plan last copied in
        self.graph = None
        self.out = None
        self.launches: dict = {}

    def load_plan(self, plan: SamplerPlan) -> None:
        if self.plan is not None and self.plan() is plan:
            return
        src = plan.arrays_on(self.noise.device)
        for k, v in self.arrays.items():
            if isinstance(v, torch.Tensor):
                v.copy_(src[k])
        self.plan = weakref.ref(plan)


def _signature(plan: SamplerPlan) -> tuple:
    """What one CUDA graph of an entry is captured for: the shapes of the
    plan's tensors (the step count and table width) and its host values
    (the flags the executor's loop branches on)."""
    return tuple((k, tuple(v.shape)) if isinstance(v, torch.Tensor)
                 else (k, v) for k, v in sorted(plan.arrays.items()))


class _CacheEntry:
    """One compiled executor: the family's executor bound to its statics
    and model adapter, the solve's input buffers on the latent's device
    (``x``, ``cond``, the float32 guidance ``scale``: 0-d, or [K] for a
    batched entry), one :class:`_Run` per graph signature, and a weak
    reference to the model (weak so the cache never pins model
    parameters; a graph reads them by address, so the entry is evicted
    when the model dies)."""

    __slots__ = ("family", "statics", "adapter", "model", "x", "cond",
                 "scale", "runs", "trajectory", "batch", "eager_only")

    def __init__(self, family, statics, adapter, model, x, cond,
                 trajectory: bool = False, batch: int | None = None,
                 eager_only: bool = False):
        self.family = family
        self.statics = statics
        self.adapter = adapter
        self.model = model
        self.x = x
        self.cond = cond
        self.trajectory = trajectory
        self.batch = batch
        self.scale = torch.ones(() if batch is None else (batch,),
                                dtype=torch.float32, device=x.device)
        self.runs: dict = {}
        #: a cfg-sharded entry: never captured (see compile_cache_stats)
        self.eager_only = eager_only

    def run_for(self, plan: SamplerPlan) -> _Run:
        sig = _signature(plan)
        run = self.runs.get(sig)
        if run is None:
            run = self.runs[sig] = _Run(plan, self.x, self.trajectory)
        return run

    def execute(self, run: _Run, cfg_group=None) -> torch.Tensor:
        """The eager solve over the entry's buffers (with ``cfg_group``,
        the call's cfg axis group, for a cfg-sharded entry)."""
        model = _bind_model(_deref_model(self.model), self.adapter,
                            self.cond, self.scale,
                            lanes=self.batch is not None,
                            cfg_group=cfg_group)
        return self.family.execute(self.statics, run.arrays, model, self.x,
                                   run.noise, run.traj)

    def capture(self, run: _Run) -> torch.Tensor:
        """The warm-up solve and the capture of the same solve into
        ``run.graph`` (:func:`capture_graph`). Returns the warm-up solve's
        output."""
        out, run.graph, run.out, run.launches = capture_graph(
            lambda: self.execute(run), self.x.device,
            f"the {self.family.name!r} solve (statics {self.statics})")
        _CACHE_STATS["graphs"] += 1
        return out

    def replay(self, run: _Run) -> torch.Tensor:
        run.graph.replay()
        ops.add_launches(run.launches)
        return run.out


class _WeakIdToken:
    """Weak *identity* of a model for the cache key.

    Hashes by ``id`` and compares equal only to tokens of the same live
    object, so unhashable callables work, value-equal but distinct
    models never share an executor, and the token holds no strong
    reference. A dead token equals nothing (and its entry is evicted by
    the death callback before the id can be recycled under a live key).
    """

    __slots__ = ("ref", "oid")

    def __init__(self, obj, callback=None):
        self.ref = weakref.ref(obj, callback)
        self.oid = id(obj)

    def __hash__(self):
        return self.oid

    def __eq__(self, other):
        if not isinstance(other, _WeakIdToken):
            return NotImplemented
        a = self.ref()
        return a is not None and a is other.ref()


def _model_token(model_fn, callback=None):
    """Weak identity token for the cache key; None -> strong fallback.
    Bound methods go through :class:`weakref.WeakMethod` (equality by
    instance and function, surviving the transient method object); other
    callables get a :class:`_WeakIdToken`."""
    if isinstance(model_fn, types.MethodType):
        try:
            tok = weakref.WeakMethod(model_fn, callback)
            hash(tok)  # hashes the method -> needs a hashable instance
            return tok
        except TypeError:
            return None
    try:
        return _WeakIdToken(model_fn, callback)
    except TypeError:
        return None


def _token_matches(token, ref) -> bool:
    if token is ref:  # WeakMethod
        return True
    # no class lookup: a callback may run while the interpreter tears
    # the module's globals down
    return getattr(token, "ref", None) is ref


class _ModelCache:
    """An LRU cache of entries keyed on tuples that hold a weak model token
    at ``token_idx`` (the compile cache and the step cache): hits, misses
    and evictions counted into ``stats`` as the reference counts them (its
    step cache counts an LRU drop as an eviction, its compile cache does
    not: ``count_lru``), and a model's entries evicted when the model dies
    (their graphs read its parameters by address)."""

    def __init__(self, stats: dict, token_idx: int, count_lru: bool):
        self.entries: OrderedDict = OrderedDict()
        self.stats = stats
        self.token_idx = token_idx
        self.count_lru = count_lru

    @staticmethod
    def lookup_token(model_fn):
        """The model's token for a lookup key: weak, or where the model
        cannot be weakly keyed its identity (the entry then holds a strong
        reference, which pins the object so its id cannot recycle)."""
        token = _model_token(model_fn)
        return ("strong", id(model_fn)) if token is None else token

    def get(self, key):
        """The entry under ``key`` (a hit, made most recent), or None (a
        miss)."""
        entry = self.entries.get(key)
        if entry is None:
            self.stats["misses"] += 1
        else:
            self.entries.move_to_end(key)
            self.stats["hits"] += 1
        return entry

    def put(self, key, model_fn, make, maxsize: int):
        """Store ``make(model)`` under ``key`` and return it. ``model`` is
        a weak reference to ``model_fn`` whose storage token (equal to the
        lookup token while the model lives, with the eviction callback)
        replaces the lookup token in the key; or ``model_fn`` itself where
        it cannot be weakly referenced. The least recent entries past
        ``maxsize`` go."""
        model, token = model_fn, key[self.token_idx]
        if not isinstance(token, tuple):
            token = _model_token(model_fn, self._on_model_death)
            i = self.token_idx
            key = key[:i] + (token,) + key[i + 1:]
            model = token.ref if isinstance(token, _WeakIdToken) else token
        entry = self.entries[key] = make(model)
        while len(self.entries) > maxsize:
            self.entries.popitem(last=False)
            if self.count_lru:
                self.stats["evictions"] += 1
        return entry

    #: reached through the instance: a model that dies while the
    #: interpreter tears the module's globals down still finds it
    _matches = staticmethod(_token_matches)

    def _on_model_death(self, ref) -> None:
        """Weakref callback: the model behind ``ref`` was garbage-collected;
        evict its entries, graphs and buffers with them."""
        for key in [k for k in self.entries
                    if self._matches(k[self.token_idx], ref)]:
            if self.entries.pop(key, None) is not None:
                self.stats["evictions"] += 1

    def clear(self) -> None:
        self.entries.clear()
        for k in self.stats:
            self.stats[k] = 0


#: the compile cache (the model token is the key's fifth field)
_CACHE = _ModelCache(_CACHE_STATS, token_idx=4, count_lru=False)
_COMPILE_CACHE = _CACHE.entries


def _deref_model(ref):
    """The model behind an entry's reference (a weak one, or the model
    itself where it cannot be weakly referenced)."""
    m = ref() if isinstance(ref, weakref.ref) else ref
    if m is None:
        raise RuntimeError(
            "the model_fn behind this cached executor was garbage-"
            "collected; call sample() with a live model_fn")
    return m


class _MeshIdent(NamedTuple):
    """Identity of a mesh placement, for the cache key: the axes (names
    and sizes), the global ranks in mesh order, and the data and cfg axes.
    Sharded and unsharded entries never collide, and neither do two
    layouts over the same ranks."""

    axes: tuple
    ranks: tuple
    data_axis: str
    cfg_axis: str | None


def _mesh_ident(mesh, data_axis: str, cfg_axis: str | None) -> _MeshIdent:
    return _MeshIdent(tuple(zip(mesh.mesh_dim_names,
                                tuple(mesh.mesh.shape))),
                      tuple(int(r) for r in mesh.mesh.flatten().tolist()),
                      data_axis, cfg_axis)


def _compiled(plan: SamplerPlan, model_fn, shape, dtype, device,
              cond=None, *, trajectory: bool = False,
              batch: int | None = None,
              mesh: _MeshIdent | None = None,
              stacked: bool = False) -> _CacheEntry:
    """LRU-cached executor entry.

    Keyed on (family name, executor statics, per-request latent shape,
    dtype, model token, model-adapter statics, cond shape and dtype,
    device, trajectory, lane count (None: unbatched; a sharded entry's
    lanes are one rank's share), mesh identity (None: unsharded), whether
    the lanes carry their own tables (:func:`stacked_solve`)), as the
    reference keys its jitted executors. A cfg-sharded entry
    (``mesh.cfg_axis``) runs eager on every device and is counted in
    ``eager_entries``. The model token is a weak identity of
    ``model_fn``: the cache holds no strong reference to the model, and an
    entry is evicted when its model is garbage-collected. ``plan.arrays``,
    the cond values and the guidance scale are data copied into the
    entry's buffers, so another plan of the same statics and step count
    (tau, grid, coefficient values), a new cond of the same shape or a new
    scale reuse the entry and its graph; a new step count is a hit that
    captures one more graph in the same entry.
    """
    adapter = _adapter_statics(plan, model_fn)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (plan.spec.name, plan.statics, tuple(shape), str(dtype),
           _CACHE.lookup_token(model_fn), adapter, cond_struct(cond), device,
           bool(trajectory), batch, mesh, bool(stacked))
    entry = _CACHE.get(key)
    if entry is not None:
        return entry
    lanes = () if batch is None else (batch,)
    x = torch.zeros(lanes + tuple(shape), dtype=dtype, device=device)
    cond_buf = None if cond is None else torch.zeros(
        tuple(cond.shape), dtype=cond.dtype, device=device)
    eager_only = mesh is not None and mesh.cfg_axis is not None
    _CACHE_STATS["eager_entries"] += eager_only
    return _CACHE.put(key, model_fn, lambda model: _CacheEntry(
        get_family(plan.spec.name), plan.statics, adapter, model, x, cond_buf,
        bool(trajectory), batch, eager_only), _COMPILE_CACHE_MAX)


def _load_noise(run: _Run, noise, generator, device) -> None:
    """Fill the run's [M, *shape] noise buffer: from ``noise`` (such a
    tensor, or a callable called once per step, here, before the solve)
    or, by default, one draw from ``generator``."""
    buf = run.noise
    if noise is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        buf.normal_(generator=generator)
    elif isinstance(noise, torch.Tensor):
        if tuple(noise.shape) != tuple(buf.shape):
            raise ValueError(
                f"noise of shape {tuple(noise.shape)}; the solve takes "
                f"[M, *x_T.shape] = {tuple(buf.shape)}")
        buf.copy_(noise)
    else:
        for i in range(buf.shape[0]):
            buf[i].copy_(noise(i))


def _load_scale(entry: _CacheEntry, guidance_scale) -> None:
    """Copy the guidance scale (a number, a tensor, or for a batched
    entry one per lane) into the entry's buffer."""
    if not isinstance(guidance_scale, torch.Tensor):
        guidance_scale = torch.as_tensor(guidance_scale, dtype=torch.float32)
    entry.scale.copy_(guidance_scale.reshape(
        () if entry.batch is None or guidance_scale.numel() == 1
        else (entry.batch,)).expand(entry.scale.shape))


def _solve(entry: _CacheEntry, run: _Run, cfg_group=None):
    """Run one solve over the entry's loaded buffers and return fresh
    tensors: the graph's replay on a CUDA device once captured, else the
    eager executor (on a CUDA device, the warm-up that the capture
    follows; a cfg-sharded entry, over ``cfg_group``, always). With a
    trajectory, ``(x0, {"x", "x0"})``."""
    if _EAGER_DEPTH:
        _CACHE_STATS["aot_fallbacks"] += 1
        out = entry.execute(run, cfg_group)
    elif entry.x.device.type != "cuda" or entry.eager_only:
        out = entry.execute(run, cfg_group)
    elif run.graph is None:
        out = entry.capture(run)
    else:
        out = entry.replay(run)
    if run.traj is None:
        return out.clone()
    return out.clone(), {k: v.clone() for k, v in run.traj.items()}


# -------------------------------------------------------------- entrypoint
@torch.no_grad()
def sample(plan: SamplerPlan, model_fn, x_T: torch.Tensor,
           generator: torch.Generator | None = None, *,
           noise: Noise = None, cond=None, guidance_scale=1.0,
           trajectory: bool = False) -> torch.Tensor:
    """Run one sampler end to end, ``x_T -> x_0``, on ``x_T``'s device,
    through the compile cache (no autograd).

    ``noise`` replaces the default draw from ``generator`` (a fresh
    generator seeded 0 on ``x_T``'s device when None): a float32
    ``[M, *x_T.shape]`` tensor, or a callable ``step -> xi`` called for
    every step before the solve. ``cond`` and ``guidance_scale`` are
    forwarded to a :class:`Denoiser` model as the entry's device buffers.
    The result is a new tensor, never one of the entry's buffers. With
    ``trajectory=True`` it is ``(x0, traj)``: ``traj["x"]`` the state after
    each step and ``traj["x0"]`` the step's denoised preview, each
    ``[M, *x_T.shape]``.
    """
    _check_model(plan, model_fn, cond, guidance_scale)
    if cond is not None:
        cond = torch.as_tensor(cond)
    entry = _compiled(plan, model_fn, x_T.shape, x_T.dtype, x_T.device,
                      cond, trajectory=trajectory)
    run = entry.run_for(plan)
    run.load_plan(plan)
    entry.x.copy_(x_T)
    _load_noise(run, noise, generator, x_T.device)
    if cond is not None:
        entry.cond.copy_(cond)
    _load_scale(entry, guidance_scale)
    return _solve(entry, run)


def _load_lane_noise(run: _Run, noise, generators) -> None:
    """Fill a batched run's [M, K, *shape] noise buffer from ``noise``
    (float32 [K, M, *shape], the reference's lane-first layout), or lane k
    from one [M, *shape] draw of ``generators[k]``."""
    buf = run.noise
    K = buf.shape[1]
    if noise is not None:
        want = (K, buf.shape[0]) + tuple(buf.shape[2:])
        if tuple(noise.shape) != want:
            raise ValueError(
                f"noise of shape {tuple(noise.shape)}; the solve takes "
                f"[K, M, *shape] = {want}")
        buf.copy_(noise.transpose(0, 1))
        return
    if generators is None or len(generators) != K:
        raise ValueError(
            f"sample_batched needs noise= or one generator per lane ({K})")
    for k, g in enumerate(generators):
        buf[:, k].copy_(torch.randn(buf[:, k].shape, generator=g,
                                    device=buf.device))


@torch.no_grad()
def sample_batched(plan: SamplerPlan, model_fn, x_T: torch.Tensor,
                   generators=None, *, noise: torch.Tensor | None = None,
                   cond=None, guidance_scale=1.0, trajectory: bool = False):
    """Solve K requests at once: ``x_T`` [K, *shape], one request per
    lane, each with its own noise (``noise`` float32 [K, M, *shape], or a
    sequence of K generators, lane k drawing its [M, *shape] steps from
    ``generators[k]``), ``cond`` (leading axis K) and guidance scale (a
    number or K of them).

    The reference vmaps its executor over the request axis. Here it is
    ONE solve over the stacked lanes, which is the same computation: every
    lane is at the same step with the same tables, so the combines take
    one coefficient vector, and the model is called lane-batched (``x``
    [K, *shape], ``t`` [K]). The lane count joins the cache key. Returns
    ``x0`` [K, *shape], with ``trajectory=True`` ``(x0, traj)`` whose
    leaves are [K, M, *shape] (the reference's vmapped layout). Under the
    residual feature-cache policy each lane refreshes on its own residual
    (a [K] device mask; the deep segment runs when any lane refreshes).
    """
    _check_model(plan, model_fn, cond, guidance_scale)
    if cond is not None:
        cond = torch.as_tensor(cond)
    _check_lanes(plan, model_fn, cond, int(x_T.shape[0]))
    return _lane_solve(plan, model_fn, x_T, generators, noise, cond,
                       guidance_scale, trajectory)


def _lane_solve(plan: SamplerPlan, model_fn, x_T, generators, noise, cond,
                guidance_scale, trajectory: bool, mesh=None, cfg_group=None):
    """One solve over the stacked lanes of ``x_T`` through the lane-batched
    entry (of ``mesh``'s placement, for a rank's share of a sharded
    batch)."""
    entry = _compiled(plan, model_fn, x_T.shape[1:], x_T.dtype, x_T.device,
                      cond, trajectory=trajectory, batch=int(x_T.shape[0]),
                      mesh=mesh)
    run = entry.run_for(plan)
    run.load_plan(plan)
    entry.x.copy_(x_T)
    _load_lane_noise(run, noise, generators)
    if cond is not None:
        entry.cond.copy_(cond)
    _load_scale(entry, guidance_scale)
    out = _solve(entry, run, cfg_group)
    if not trajectory:
        return out
    x0, traj = out
    return x0, {k: v.transpose(0, 1).contiguous() for k, v in traj.items()}


def stack_plans(plans, lane_group: int = 1) -> SamplerPlan:
    """One plan for a solve whose lane l runs under ``plans[l]``: every
    table gains a lane axis after its step axis (a 0-d table becomes
    [L]), so step i's rows of every lane are one contiguous [L, ...]
    block; host values (the flags the executor's loop branches on) stay
    as they are, with ``stacked`` set and ``lane_group``: the lanes come
    in groups of that many under one plan object (a candidate repeated
    over its seeds), which the einsum combine contracts as that plan's
    solo solve does. Refuses plans whose family,
    statics, step count, grid, table shapes or host flags differ: one
    loop and one graph serve every lane."""
    first = plans[0]
    sig = _signature(first)
    for p in plans[1:]:
        if (p.spec.name, p.statics) != (first.spec.name, first.statics):
            raise ValueError(
                f"stacked plans must share family and statics: "
                f"{first.spec.name} {first.statics} vs {p.spec.name} "
                f"{p.statics}")
        if p.spec.n_steps != first.spec.n_steps:
            raise ValueError(
                f"stacked plans must share the step count: "
                f"{first.spec.n_steps} vs {p.spec.n_steps}")
        if not np.array_equal(p.ts, first.ts):
            raise ValueError("stacked plans must share the solve grid ts")
        if _signature(p) != sig:
            raise ValueError(
                "stacked plans must share table shapes and host flags: "
                f"{sig} vs {_signature(p)}")
    arrays = {k: torch.stack([p.arrays[k] for p in plans],
                             dim=min(1, v.dim()))
              if isinstance(v, torch.Tensor) else v
              for k, v in first.arrays.items()}
    G = int(lane_group)
    if G < 1 or len(plans) % G or any(
            p is not plans[l - l % G] for l, p in enumerate(plans)):
        raise ValueError(
            f"lane_group={lane_group}: the {len(plans)} lanes must come in "
            "groups of that many lanes under one plan object")
    arrays["stacked"] = True
    arrays["lane_group"] = G
    return SamplerPlan(spec=first.spec, arrays=arrays, host=first.host,
                       statics=first.statics)


@torch.no_grad()
def stacked_solve(plans, model_fn, x_T: torch.Tensor, noise: torch.Tensor,
                  lane_group: int = 1) -> torch.Tensor:
    """Solve lane l of ``x_T`` [L, *shape] under ``plans[l]``, with its
    step noise ``noise[l]`` (float32 [L, M, *shape]), as ONE solve: the
    autotuner's chunk of candidates (each candidate's plan repeated over
    its evaluation seeds), the counterpart of the reference's ``vmap``
    over stacked ``plan.arrays``. The plans are stacked by
    :func:`stack_plans` (which refuses plans that differ in more than
    table values); the executor reads each lane's row of every table, and
    the combines go through the lane entries of the combine kernels
    (``ops.sa_update_lanes``, ``ops.sa_fused_update_lanes``);
    ``lane_group`` (the evaluation seeds of one candidate) lets the
    einsum combine round each group as ``sample_batched`` of its plan
    alone does, and keys the graph like the lane count. Under the
    residual feature cache each lane has its own threshold (table data)
    and its own refresh flag.

    The solve runs through the compile cache's lane-batched entry keyed
    with the lane count and the stacked flag: on a CUDA device its first
    call captures a CUDA graph (a failed capture raises), later calls of
    any plans of the same signature replay it. The model is bound as on
    every other lane-batched path (``t`` [L]). Returns ``x0`` [L, *shape],
    a new tensor."""
    L = int(x_T.shape[0])
    if len(plans) != L:
        raise ValueError(f"{len(plans)} plans for {L} lanes")
    plan = stack_plans(plans, lane_group)
    _check_model(plan, model_fn, None, 1.0)
    entry = _compiled(plan, model_fn, x_T.shape[1:], x_T.dtype, x_T.device,
                      batch=L, stacked=True)
    run = entry.run_for(plan)
    run.load_plan(plan)
    entry.x.copy_(x_T)
    _load_lane_noise(run, noise, None)
    _load_scale(entry, 1.0)
    return _solve(entry, run)


class _Placement(NamedTuple):
    """One rank's part of a sharded batch: its lanes ``[lo, hi)``, the
    data axis's process group (the result's gather), the cfg axis's (or
    None) and the mesh identity of the cache key."""

    lo: int
    hi: int
    data_group: Any
    cfg_group: Any
    ident: _MeshIdent


def _placement(mesh, batch: int, model_fn, device, data_axis: str,
               cfg_axis: str | None) -> _Placement:
    """Check a sharded call's mesh against its batch and model, with the
    reference's messages, and place this rank: its lanes are the
    ``rank``-th of the data axis's equal shares, ``rank`` its rank in the
    data axis's group (the gather's order, so the gathered shares are the
    batch in order)."""
    names = tuple(mesh.mesh_dim_names or ())
    if data_axis not in names:
        raise ValueError(f"mesh has no axis {data_axis!r}; axes: {names}")
    sizes = dict(zip(names, tuple(mesh.mesh.shape)))
    n_data = sizes[data_axis]
    if batch % n_data:
        raise ValueError(
            f"request batch {batch} is not divisible by mesh axis "
            f"{data_axis!r} (size {n_data}); pad the bucket first "
            "(repro_torch.serve.sharding.align_bucket_sizes)")
    if cfg_axis is not None:
        if cfg_axis not in names:
            raise ValueError(
                f"cfg_axis={cfg_axis!r} needs a mesh with that axis "
                "(see repro_torch.serve.sharding.auto_cfg_mesh)")
        if sizes[cfg_axis] != 2:
            raise ValueError(
                f"cfg_axis {cfg_axis!r} has size {sizes[cfg_axis]}; "
                "sharded CFG splits exactly the cond/uncond pair (size 2)")
        if not (isinstance(model_fn, Denoiser) and model_fn.guidance):
            raise ValueError(
                "cfg_axis only applies to a guidance-enabled Denoiser")
    if mesh.device_type != torch.device(device).type:
        raise ValueError(
            f"a {mesh.device_type!r} mesh cannot place a batch on {device}")
    if mesh.get_coordinate() is None:
        raise ValueError(
            f"rank {dist.get_rank()} is not in the mesh (ranks "
            f"{mesh.mesh.flatten().tolist()})")
    cfg_group = None if cfg_axis is None else mesh.get_group(cfg_axis)
    data_group = mesh.get_group(data_axis)
    share = batch // n_data
    lo = dist.get_rank(data_group) * share
    return _Placement(lo, lo + share, data_group, cfg_group,
                      _mesh_ident(mesh, data_axis, cfg_axis))


def _rows(v, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a per-lane value (None stays None)."""
    return None if v is None else v[lo:hi]


@torch.no_grad()
def sample_sharded(plan: SamplerPlan, model_fn, x_T: torch.Tensor,
                   generators=None, *, mesh, data_axis: str = "data",
                   cfg_axis: str | None = None,
                   noise: torch.Tensor | None = None, cond=None,
                   guidance_scale=1.0, trajectory: bool = False,
                   donate: bool | None = None):
    """``sample_batched`` with the leading request axis placed on the
    ``data`` axis of ``mesh`` (a named
    :class:`~torch.distributed.device_mesh.DeviceMesh`, e.g. from
    ``repro_torch.launch.mesh``). Every rank of the mesh makes the same
    call with the global batch: ``x_T`` [K, *shape], its noise (``noise``
    [K, M, *shape], or K generators), ``cond`` [K, ...] and the guidance
    scale (a number or K of them). A rank solves the lanes of its data
    coordinate, with their noise, cond and scales, as ONE solve through
    the same lane-batched entry as ``sample_batched`` (on the card its
    CUDA graph), then gathers the results over the data axis (after the
    replay, outside the graph): every rank returns the global ``x0``
    [K, *shape] (with ``trajectory=True``, ``(x0, traj)``, traj leaves
    [K, M, *shape]). Ranks that share a data coordinate along another axis
    (``model``) solve the same lanes: the axis is replicated, as in the
    reference; the backbone's tensor parallelism over it is not ported.

    ``cfg_axis`` names a size-2 mesh axis that carries the guided pair
    (sharded classifier-free guidance): the rank at its coordinate 0
    evaluates the cond branch and the other the uncond branch, each at
    the local batch, and one ``all_gather`` over the axis gives both
    halves to both ranks inside every evaluation; the combine is
    unchanged. It needs a guidance-enabled Denoiser and a cfg-factored
    mesh (``repro_torch.serve.sharding.auto_cfg_mesh``). Such an entry
    runs eager on every device (``compile_cache_stats()["eager_entries"]``).

    ``donate`` is accepted for the reference's signature and ignored: the
    entry's own carry buffer already holds the copy of ``x_T``, so there
    is nothing to donate, and it does not key the entry.

    The mesh's identity (axes, ranks, data and cfg axes) joins the cache
    key: sharded and unsharded entries never collide.
    """
    K = int(x_T.shape[0])
    if noise is not None or generators is not None:
        n = int(noise.shape[0]) if noise is not None else len(generators)
        if n != K:
            raise ValueError(
                f"leading axes must match: x_T {K} vs "
                f"{'noise' if noise is not None else 'generators'} {n}")
    place = _placement(mesh, K, model_fn, x_T.device, data_axis, cfg_axis)
    _check_model(plan, model_fn, cond, guidance_scale)
    if cond is not None:
        cond = torch.as_tensor(cond)
    _check_lanes(plan, model_fn, cond, K)
    lo, hi = place.lo, place.hi
    scale = torch.as_tensor(guidance_scale, dtype=torch.float32)
    if scale.numel() != 1:
        scale = scale.reshape(K)[lo:hi]
    out = _lane_solve(plan, model_fn, x_T[lo:hi], _rows(generators, lo, hi),
                      _rows(noise, lo, hi), _rows(cond, lo, hi), scale,
                      trajectory, mesh=place.ident,
                      cfg_group=place.cfg_group)
    if not trajectory:
        return torch.cat(all_gather(out, place.data_group))
    x0, traj = out
    return (torch.cat(all_gather(x0, place.data_group)),
            {k: torch.cat(all_gather(v, place.data_group))
             for k, v in traj.items()})


@torch.no_grad()
def warmup(plan: SamplerPlan, model_fn, shape, dtype=torch.float32, *,
           cond=None, guidance_scale=None, device="cuda",
           batch: int | None = None, trajectory: bool = False, mesh=None,
           data_axis: str = "data", cfg_axis: str | None = None,
           donate: bool | None = None) -> None:
    """Build the entry that :func:`sample` (or, with ``batch``,
    :func:`sample_batched` of that many lanes; with ``mesh`` too,
    :func:`sample_sharded` of that global batch over ``mesh``'s
    ``data_axis``, with ``cfg_axis`` as there; ``donate`` is ignored) of
    this plan, model, per-request latent ``shape``/``dtype``, ``cond``
    structure and ``trajectory`` flag on ``device`` will use and, on a
    CUDA device, capture its graph for the plan's signature (not for a
    cfg-sharded entry, which runs eager). ``cond`` is a prototype of one
    call's (with ``batch``: one request's) conditioning; its shape and
    dtype key the entry, its values feed the warm-up solve. Idempotent: a
    later warmup or sample of the same key is a hit, and adds no graph.
    A sharded warmup checks the mesh as :func:`sample_sharded` does,
    with the reference's messages."""
    scale = 1.0 if guidance_scale is None else guidance_scale
    device = resolve_device(device)
    ident = None
    if mesh is not None:
        if batch is None:
            raise ValueError(
                "warmup(mesh=...) warms a sample_sharded bucket; pass its "
                "global lane count as batch=")
        place = _placement(mesh, batch, model_fn, device, data_axis,
                           cfg_axis)
        batch, ident = place.hi - place.lo, place.ident
    _check_model(plan, model_fn, cond, scale)
    if cond is not None:
        cond = torch.as_tensor(cond)
        if batch is not None:
            cond = cond.expand((batch,) + tuple(cond.shape))
    if batch is not None:
        _check_lanes(plan, model_fn, cond, batch)
    entry = _compiled(plan, model_fn, shape, dtype, device, cond,
                      trajectory=trajectory, batch=batch, mesh=ident)
    run = entry.run_for(plan)
    if run.graph is not None or entry.x.device.type != "cuda" or \
            entry.eager_only or _EAGER_DEPTH:
        return
    run.load_plan(plan)
    if cond is not None:
        entry.cond.copy_(cond)
    _load_scale(entry, scale)
    entry.capture(run)


# ------------------------------------------------------------ bound sampler
class Sampler:
    """A spec bound to its plan: ``make_sampler("sa", nfe=20, tau=0.4)``
    plans once, then ``.sample`` / ``.sample_batched`` /
    ``.sample_sharded`` run solves."""

    def __init__(self, spec: SamplerSpec):
        self.spec = spec
        self.plan = build_plan(spec)
        self.schedule = spec.resolve_schedule()

    @property
    def nfe(self) -> int:
        return self.spec.nfe

    def sample(self, model_fn, x_T: torch.Tensor,
               generator: torch.Generator | None = None, *,
               noise: Noise = None, cond=None, guidance_scale=1.0,
               trajectory: bool = False):
        return sample(self.plan, model_fn, x_T, generator, noise=noise,
                      cond=cond, guidance_scale=guidance_scale,
                      trajectory=trajectory)

    def sample_batched(self, model_fn, x_T: torch.Tensor, generators=None,
                       *, noise: torch.Tensor | None = None, cond=None,
                       guidance_scale=1.0, trajectory: bool = False):
        return sample_batched(self.plan, model_fn, x_T, generators,
                              noise=noise, cond=cond,
                              guidance_scale=guidance_scale,
                              trajectory=trajectory)

    def sample_sharded(self, model_fn, x_T: torch.Tensor, generators=None,
                       *, mesh, data_axis: str = "data",
                       cfg_axis: str | None = None,
                       noise: torch.Tensor | None = None, cond=None,
                       guidance_scale=1.0, trajectory: bool = False,
                       donate: bool | None = None):
        return sample_sharded(self.plan, model_fn, x_T, generators,
                              mesh=mesh, data_axis=data_axis,
                              cfg_axis=cfg_axis, noise=noise, cond=cond,
                              guidance_scale=guidance_scale,
                              trajectory=trajectory, donate=donate)

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
