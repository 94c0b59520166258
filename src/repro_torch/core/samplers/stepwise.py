"""Step-granular sampler execution: the solver step as the scheduling unit.

The whole-solve executors run all M steps of a solve in one call: the
fastest shape when a batch runs start to finish, and the serving engine
keeps it as its ``scheduler="solve"`` path. Continuous batching needs the
opposite factoring: ONE step function (a *tick*) over a carry the engine
owns, so requests can join a running batch at any step boundary, freed
lanes can be recycled mid-flight, and every lane sits at its own step
index, kept in the carry and not in the loop.

The carry (a dict of tensors on one device, leading axis = lanes):

- ``inner``   the family's own state (multistep: ``{x, buf}``, the ring
  history at [L, P, *shape]),
- ``i``       per-lane step index (int64). The multistep families start at
  ``-1``: the init evaluation runs in-band as a lane's first tick, so a
  join is pure data writes and every tick costs a fixed number of
  lane-batched model evaluations,
- ``noise``   the lane's per-step Gaussian draws [L, M, *shape] (float32),
  drawn at join from the request's own generator or given by the caller
  (the reference's draws, in parity tests). It moves with the lane under
  ``copy``, as the reference's per-lane keys do, so migration cannot
  change a request's stream,
- ``active``  the lane mask: free and finished lanes still compute (the
  shape is fixed) but every carry write is masked,
- ``x_final`` the finished sample, captured on the tick a lane completes,
- ``err``     the predictor-vs-corrector residual (free under a
  corrector), which drives the masked early exit,
- ``tol`` / ``min_i`` per-lane early-exit tolerance (<= 0 disables it, and
  the disabled path is the whole solve's) and the steps a lane completes
  before it may exit,
- ``guard``   per-lane numerical-guard interval (0 disables). Every
  ``guard`` steps, and on a lane's finishing tick, the lane's state and
  would-be result are checked for non-finite values; a tripped lane is
  deactivated without capturing ``x_final`` and flagged in
  ``aux["failed"]``. The interval is carry data: toggling it adds no cache
  entry, and at 0 every masked write selects the unguarded bytes,
- ``scale`` (and ``cond`` when the requests are conditioned) the per-lane
  guidance scale and conditioning, bound into the lane-batched model,
- ``feats`` (feature-cached specs) each lane's cached mid-stack features
  [L, G, *f]: G = 2 under guidance (the lane's conditional and null rows
  of the doubled call), else 1. A tick's first model call refreshes the
  lanes whose ``init | fc_refresh[i] | (isfinite(err) & err >=
  fc_thresh)`` holds (active lanes only), decided on the device: the deep
  segment runs when any lane refreshes (a conditional node of the tick's
  graph); a PECE re-evaluation in the same tick reuses them. ``join``
  zeroes a lane's features and ``copy`` moves them.

A :class:`StepFns` entry holds the three operations of one step key:

- ``step(arrays, carry) -> (carry, aux)``: one tick of every lane. ``aux``
  has the per-lane ``finished``/``stepped``/``failed`` flags, step indices,
  residuals and (stream mode) the tick's denoised previews ``x0``.
- ``join(arrays, carry, lane, x_T, noise, tol, min_i, scale[, guard]
  [, cond])``: admit one request into one lane (eager masked writes).
- ``copy(dst, src, dst_lane, src_lane)``: lane migration: the lane's whole
  carry slice (state, history, step index, noise) moves between batches of
  one key, so merging half-empty batches is bitwise invisible to the
  moved request.

On a CUDA device ``warm()`` captures the tick as a CUDA graph (the
counterpart of the reference's AOT ``lower().compile()``), on the side
stream and into the memory pool the compile cache's graphs share. The
graph runs over the entry's own carry and table buffers: several running
batches share one entry, so a tick copies the batch's carry and tables in,
replays, and copies the carry back. A tick reads nothing back to the host;
the caller reads ``aux`` once. On the CPU, and inside
:func:`repro_torch.core.samplers.eager`, a tick runs eager on the batch's
carry.

The cache is keyed by the step function, not the serve bucket: (family,
stepwise statics, step count, table widths, latent shape/dtype, lane
count, model token, adapter statics, cond structure, stream, device).
Specs that differ only in tau, per-interval program orders or coefficient
values share one entry, so a bucket is strictly finer than its step
function and warmup survives any bucket churn; ``stepwise_cache_stats()``
counts as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ...device import resolve_device
from ...kernels import ops
from ..denoiser import lane_view
from . import base
from .base import (SamplerPlan, _adapter_statics, _bind_model, _check_lanes,
                   _check_model, _deref_model, _ModelCache, capture_graph,
                   carry_dtype, check_feature_cache_family, cond_struct,
                   get_family)

__all__ = [
    "StepAdapter",
    "StepFns",
    "stepwise_adapter",
    "stepwise_supported",
    "make_stepfns",
    "fresh_carry",
    "carry_leaves",
    "stepwise_cache_stats",
    "clear_stepwise_cache",
]


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass(frozen=True)
class StepAdapter:
    """A family's lane-batched step view, built by ``family.stepwise(spec)``.

    ``step(dev, model_fn, inner, ic, init, xi)`` advances every lane one
    solver step and returns ``(inner', final, x0, err)``: the family state,
    the would-be final sample of each lane if it stopped after this tick,
    the denoised preview, and the step's residual [L] (``inf`` where the
    family has none: early exit never fires). ``ic`` [L] is each lane's
    clamped step index, ``init`` [L] the in-band init predicate and ``xi``
    [L, *shape] each lane's float32 noise row at ``ic`` (the adapter rounds
    it to its carry dtype where its family does). ``statics`` is the
    trace-relevant identity (part of the cache key).
    """

    statics: tuple
    #: first per-lane index; -1: the family runs an in-band init tick
    i0: int
    #: model evaluations a tick spends per lane
    evals_per_tick: int
    #: device arrays -> M (the step count)
    n_steps_of: Callable[[dict], int]
    #: (dev, x_T) -> one lane's inner state (data only, no evaluation)
    init_inner: Callable
    #: (dev, model_fn, inner, ic, init, xi) -> (inner', final, x0, err)
    step: Callable
    #: (plan, device) -> the tables this adapter's step reads, on device
    arrays: Callable[[SamplerPlan, torch.device], dict]
    #: plan -> what changes the tables' shapes without changing the
    #: statics (table width, optional tables), for the cache key
    shape_key: Callable[[SamplerPlan], tuple] = lambda plan: ()


def stepwise_supported(spec) -> bool:
    return get_family(spec.name).stepwise is not None


def stepwise_adapter(spec) -> StepAdapter:
    family = get_family(spec.name)
    if family.stepwise is None:
        raise ValueError(
            f"sampler family {spec.name!r} has no step-granular adapter; "
            "step-scheduled (continuous-batching) serving needs one: "
            "register the family with a `stepwise=` builder or serve it "
            "through the whole-solve scheduler")
    adapter = family.stepwise(spec)
    if not isinstance(adapter, StepAdapter):
        raise TypeError(
            f"{spec.name}.stepwise must return a StepAdapter, got "
            f"{type(adapter).__name__}")
    return adapter


def _lane_feats_shape(model_fn, batch: int, shape, dtype) -> tuple:
    """The per-lane features' shape ``(G, *f)`` of a feature-cached
    Denoiser over ``batch`` lanes of ``shape``: its ``init_feats`` of the
    lane-batched input has G * batch rows (G = 2 under guidance), taken
    on the meta device (nothing is allocated)."""
    if model_fn is None or not hasattr(model_fn, "init_feats"):
        raise ValueError(
            "spec.feature_cache needs the feats shape: pass the Denoiser "
            "(built with cached=) as fresh_carry(..., model_fn=)")
    f = model_fn.init_feats(torch.zeros((int(batch),) + tuple(shape),
                                        dtype=dtype, device="meta"))
    return (f.shape[0] // int(batch),) + tuple(f.shape[1:]), f.dtype


# -------------------------------------------------------------- build carry
@torch.no_grad()
def fresh_carry(plan: SamplerPlan, batch: int, shape, dtype, *, cond=None,
                model_fn=None, guard_every: int = 0, device="cuda") -> dict:
    """An all-lanes-free carry for one running batch on ``device`` (the
    card unless the caller asks for the CPU).

    ``cond`` is a per-request conditioning prototype (its shape and dtype
    matter); lanes are zeroed and inactive until ``join`` writes them.
    When the spec sets ``feature_cache`` the carry grows the per-lane
    ``feats`` leaf, shaped from the Denoiser's ``init_feats`` (pass it as
    ``model_fn``). ``guard_every`` seeds every lane's numerical-guard
    interval (data: ``join`` overwrites it per request; 0 disables the
    guard).
    """
    check_feature_cache_family(plan.spec)
    device = resolve_device(device)
    adapter = stepwise_adapter(plan.spec)
    arrays = adapter.arrays(plan, device)
    M = adapter.n_steps_of(arrays)
    proto = adapter.init_inner(
        arrays, torch.zeros(tuple(shape), dtype=dtype, device=device))
    lanes = (int(batch),)
    carry = {
        "inner": {k: torch.zeros(lanes + tuple(v.shape), dtype=v.dtype,
                                 device=device) for k, v in proto.items()},
        "i": torch.full(lanes, adapter.i0, dtype=torch.long, device=device),
        "noise": torch.zeros(lanes + (M,) + tuple(shape), device=device),
        "active": torch.zeros(lanes, dtype=torch.bool, device=device),
        "x_final": torch.zeros(lanes + tuple(shape),
                               dtype=carry_dtype(plan.spec.precision),
                               device=device),
        "err": torch.full(lanes, math.inf, device=device),
        "tol": torch.zeros(lanes, device=device),
        "min_i": torch.zeros(lanes, dtype=torch.long, device=device),
        "scale": torch.ones(lanes, device=device),
        "guard": torch.full(lanes, int(guard_every), dtype=torch.long,
                            device=device),
    }
    if cond is not None:
        cond = torch.as_tensor(cond)
        carry["cond"] = torch.zeros(lanes + tuple(cond.shape),
                                    dtype=cond.dtype, device=device)
    if plan.spec.feature_cache is not None:
        fshape, fdtype = _lane_feats_shape(model_fn, batch, shape, dtype)
        carry["feats"] = torch.zeros(lanes + fshape, dtype=fdtype,
                                     device=device)
    return carry


def carry_leaves(carry: dict):
    """(path, tensor) of every carry tensor, ``inner``'s flattened."""
    for k, v in carry.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                yield (k, k2), v2
        else:
            yield (k,), v


def _at(carry: dict, path):
    v = carry[path[0]]
    return v[path[1]] if len(path) > 1 else v


#: the carry fields a tick writes (the rest is join data it only reads)
_TICK_WRITES = ("inner", "i", "active", "x_final", "err", "feats")


def _cached_tick_model(model, carry: dict, arrays: dict, active, init, ic):
    """The tick's model over the lanes' cached features: ``(model_fn,
    write_back)``. The tick's first call refreshes the active lanes whose
    ``init | fc_refresh[ic] | (isfinite(err) & err >= fc_thresh)`` holds
    (the reference's per-lane predicate), as one device mask; later calls
    in the tick (the PECE re-evaluation) reuse the features. The features
    go to the network as its [G * L, *f] rows (G-major: the doubled call's
    row order) and come back into the carry in ``write_back()``, masked by
    ``active`` as in the reference."""
    err = carry["err"]
    refresh = active & (init | arrays["fc_refresh"][ic]
                        | (torch.isfinite(err) & (err >= arrays["fc_thresh"])))
    lane_feats = carry["feats"]
    L, G = lane_feats.shape[:2]
    rows = lane_feats.transpose(0, 1).reshape((G * L,)
                                              + tuple(lane_feats.shape[2:]))
    state = {"first": True, "feats": rows}

    def model_fn(x, t):
        r = refresh if state["first"] else False
        state["first"] = False
        e, state["feats"] = model.cached_call(x, t, state["feats"], r)
        return e

    def write_back():
        new = state["feats"]
        if new is rows and G == 1:
            return  # refreshed in place in the carry, on active lanes only
        new = new.reshape((G, L) + tuple(new.shape[1:])).transpose(0, 1)
        lane_feats.copy_(torch.where(lane_view(active, new), new,
                                     lane_feats))

    return model_fn, write_back


# ------------------------------------------------------------ compile cache
_STEP_CACHE_MAX = 64
_STEP_STATS = {"hits": 0, "misses": 0, "evictions": 0, "graphs": 0}
#: the step cache (the model token is the key's eighth field)
_STEPS = _ModelCache(_STEP_STATS, token_idx=7, count_lru=True)


def stepwise_cache_stats() -> dict:
    """``hits``/``misses``/``evictions`` as the reference counts them;
    ``graphs``: ticks captured as CUDA graphs; ``size``: live entries."""
    return dict(_STEP_STATS, size=len(_STEPS.entries))


def clear_stepwise_cache() -> None:
    _STEPS.clear()


class StepFns:
    """One step key's tick, join and copy, and on a CUDA device the tick's
    CUDA graph over the entry's own carry and table buffers. ``warm()``
    captures it, so the serving hot path (every later join, leave and
    migration included) replays and never builds anything."""

    __slots__ = ("adapter", "model", "key", "shape", "dtype", "has_cond",
                 "lanes", "dadapter", "stream", "device", "M", "_graph",
                 "_carry", "_arrays", "_aux", "_loaded", "_launches",
                 "_warmed")

    def __init__(self, adapter, model, key, shape, dtype, has_cond, lanes,
                 dadapter, stream, device, M):
        self.adapter = adapter
        self.model = model
        self.key = key
        self.shape = tuple(shape)
        self.dtype = dtype
        self.has_cond = has_cond
        self.lanes = lanes
        self.dadapter = dadapter
        self.stream = stream
        self.device = device
        self.M = M
        self._graph = self._carry = self._arrays = self._aux = None
        self._loaded = None
        self._launches: dict = {}
        self._warmed = False

    # ------------------------------------------------------------ the tick
    def _tick(self, arrays, carry) -> dict:
        """One tick over ``carry``, written in place; returns ``aux``.
        Reads no value back to the host."""
        adapter, M = self.adapter, self.M
        i, active, inner = carry["i"], carry["active"], carry["inner"]
        model = _bind_model(_deref_model(self.model), self.dadapter,
                            carry.get("cond"), carry["scale"])
        init = i < 0
        ic = i.clamp(0, M - 1)
        write_back = None
        if "feats" in carry:
            model, write_back = _cached_tick_model(model, carry, arrays,
                                                   active, init, ic)
        lanes = torch.arange(i.shape[0], device=i.device)
        xi = carry["noise"][lanes, ic]
        inner2, final, x0, err = adapter.step(arrays, model, inner, ic, init,
                                              xi)
        if write_back is not None:
            write_back()
        i_new = torch.where(init, 0, ic + 1)
        err = torch.where(init, math.inf, err)
        # masked early exit: the residual strictly below the lane's
        # tolerance (tol <= 0 never fires: err >= 0) after min_i steps;
        # i_new == M is the whole solve's end
        fin = active & ((i_new >= M) | ((err < carry["tol"])
                                        & (i_new >= carry["min_i"])))
        # the numerical guard: every `guard` steps and on the finishing
        # tick, one finiteness bit per lane over its state and result
        guard = carry["guard"]
        due = (guard > 0) & ((torch.remainder(i_new, guard.clamp(min=1))
                              == 0) | fin)
        finite = torch.ones_like(active)
        for t in list(inner2.values()) + [final]:
            finite = finite & torch.isfinite(t.float()).flatten(1).all(1)
        bad = active & due & ~finite
        fin = fin & ~bad
        stepped = active & ~init
        i_out = torch.where(active, i_new, i)
        err_out = torch.where(active, err, carry["err"])
        for k, v in inner2.items():
            inner[k].copy_(torch.where(lane_view(active, v), v, inner[k]))
        carry["x_final"].copy_(torch.where(lane_view(fin, final), final,
                                           carry["x_final"]))
        carry["i"].copy_(i_out)
        carry["err"].copy_(err_out)
        carry["active"].copy_(active & ~fin & ~bad)
        aux = {"finished": fin, "stepped": stepped, "failed": bad,
               "i": i_out, "err": err_out}
        if self.stream:
            aux["x0"] = x0
        return aux

    @torch.no_grad()
    def step(self, arrays, carry):
        """One tick of every lane of ``carry`` (in place); returns
        ``(carry, aux)``. Replays the captured graph once warmed on a CUDA
        device, else runs eager."""
        if self._graph is None or base._EAGER_DEPTH:
            return carry, self._tick(arrays, carry)
        if self._loaded is not arrays:
            for k, v in self._arrays.items():
                v.copy_(arrays[k])
            self._loaded = arrays
        for path, v in carry_leaves(carry):
            _at(self._carry, path).copy_(v)
        self._graph.replay()
        ops.add_launches(self._launches)
        for path, v in carry_leaves(carry):
            if path[0] in _TICK_WRITES:
                v.copy_(_at(self._carry, path))
        return carry, {k: v.clone() for k, v in self._aux.items()}

    # ---------------------------------------------------- join and copy
    @torch.no_grad()
    def join(self, arrays, carry, lane: int, x_T, noise, tol, min_i, scale,
             guard: int = 0, cond=None):
        """Admit one request into ``lane`` of ``carry`` (masked writes, in
        place): its initial state from ``x_T``, its [M, *shape] step noise
        (a tensor, or a :class:`torch.Generator` to draw it from), its
        early-exit knobs, guidance scale, guard interval and cond."""
        lane = int(lane)
        x_T = torch.as_tensor(x_T).to(self.device)
        inner = self.adapter.init_inner(arrays, x_T)
        for k, v in inner.items():
            carry["inner"][k][lane].copy_(v)
        row = carry["noise"][lane]
        if isinstance(noise, torch.Generator):
            row.copy_(torch.randn(row.shape, generator=noise,
                                  device=noise.device))
        else:
            if tuple(noise.shape) != tuple(row.shape):
                raise ValueError(
                    f"noise of shape {tuple(noise.shape)}; a lane takes "
                    f"[M, *shape] = {tuple(row.shape)}")
            row.copy_(noise)
        carry["i"][lane] = self.adapter.i0
        carry["active"][lane] = True
        carry["x_final"][lane].zero_()
        carry["err"][lane] = math.inf
        carry["tol"][lane] = float(tol)
        carry["min_i"][lane] = int(min_i)
        carry["scale"][lane] = float(scale)
        carry["guard"][lane] = int(guard)
        if "feats" in carry:
            # a fresh lane starts from zero features; its init tick's
            # forced refresh overwrites them before any reuse
            carry["feats"][lane].zero_()
        if self.has_cond:
            if cond is None:
                raise ValueError("this step function was built with "
                                 "conditioning; join(..., cond=) is required")
            carry["cond"][lane].copy_(torch.as_tensor(cond))
        return carry

    @staticmethod
    @torch.no_grad()
    def copy(dst_carry, src_carry, dst_lane: int, src_lane: int):
        """Move lane ``src_lane`` of ``src_carry`` (state, history, step
        index, noise, knobs, cached features) into lane ``dst_lane`` of
        ``dst_carry``."""
        for path, v in carry_leaves(dst_carry):
            v[int(dst_lane)].copy_(_at(src_carry, path)[int(src_lane)])
        return dst_carry

    # ------------------------------------------------------------ warm-up
    @property
    def warmed(self) -> bool:
        return self._warmed

    @torch.no_grad()
    def warm(self, arrays, carry, *, cond=None) -> None:
        """Make the tick ready to serve: on a CUDA device, one eager tick
        on the side stream over the entry's own copy of ``carry`` and
        ``arrays`` (it builds the kernels and sets up cuBLAS, none of which
        may run in a capture), then the capture of a tick into a CUDA
        graph in the shared pool. A failed capture raises. ``cond`` is the
        per-request conditioning prototype, required when the carry has
        one. Idempotent; inside ``eager()`` nothing is captured."""
        if self.has_cond and cond is None:
            raise ValueError(
                "this step function was built with conditioning; "
                "warm(..., cond=per_request_prototype) is required")
        if self._warmed or base._EAGER_DEPTH:
            return
        if self.device.type != "cuda":
            self._warmed = True
            return
        self._carry = {k: ({k2: v2.clone() for k2, v2 in v.items()}
                           if isinstance(v, dict) else v.clone())
                       for k, v in carry.items()}
        self._arrays = {k: v.clone() for k, v in arrays.items()}
        _, self._graph, self._aux, self._launches = capture_graph(
            lambda: self._tick(self._arrays, self._carry), self.device,
            f"the {self.key[0]!r} tick (statics {self.adapter.statics}, "
            f"{self.lanes} lanes)")
        self._loaded = None
        self._warmed = True
        _STEP_STATS["graphs"] += 1


@torch.no_grad()
def make_stepfns(plan: SamplerPlan, model_fn, shape, dtype, batch: int, *,
                 cond=None, guidance_scale=1.0, stream: bool = False,
                 device="cuda") -> StepFns:
    """The (LRU-cached) tick/join/copy entry of one step key on
    ``device`` (the card unless the caller asks for the CPU).

    ``model_fn`` is lane-batched: ``(x [L, *shape], t [L])`` (or a
    :class:`~repro_torch.core.denoiser.Denoiser` over such a network);
    ``cond`` a per-request conditioning prototype. Conditioning values and
    guidance scales are per-lane carry data: only cond's shape and dtype
    key the entry. Two plans whose specs differ only in tau, program
    orders or coefficient values resolve to the SAME entry. A
    feature-cached spec's entry is also keyed on its per-lane features'
    shape.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    adapter = stepwise_adapter(plan.spec)
    if cond is not None:
        cond = torch.as_tensor(cond)
    _check_model(plan, model_fn, cond, guidance_scale)
    _check_lanes(plan, model_fn, None if cond is None else
                 cond.expand((int(batch),) + tuple(cond.shape)), int(batch))
    dadapter = _adapter_statics(plan, model_fn)
    M = int(plan.spec.n_steps)
    feats = None if plan.spec.feature_cache is None else \
        _lane_feats_shape(model_fn, batch, shape, dtype)
    key = (plan.spec.name, adapter.statics, M, adapter.shape_key(plan),
           tuple(shape), str(dtype), int(batch),
           _STEPS.lookup_token(model_fn), dadapter, cond_struct(cond),
           bool(stream), device, feats)
    entry = _STEPS.get(key)
    if entry is not None:
        return entry
    return _STEPS.put(key, model_fn, lambda model: StepFns(
        adapter, model, key, shape, dtype, cond is not None, int(batch),
        dadapter, bool(stream), device, M), _STEP_CACHE_MAX)
