"""Family-agnostic multistep-integrator core.

SA-Solver, SEEDS and DPM-Solver++ multistep are exponential Adams
integrators: per interval, the next state is
``decay_i * x + sum_j b_j * eval_j + noise_i * xi`` over a short
newest-first history of model evaluations, with an optional corrector row
that also weights the predicted-point eval. The family-specific part is
the *values* in those rows, produced on the host in float64 by a
:class:`repro_torch.core.coefficients.TableBuilder`; this module owns the
rest: the plan (tables shipped as f32 tensors), the executor, the NFE
accounting and the statics.

History layouts (``spec.history``):

- ``"ring"`` (default): the [P, *latent] history lives in a fixed ring,
  age j in slot ``(i - j) mod P`` at step i, and the new evaluation is
  written into one row in place. The einsum/kernel combines gather the P
  rows newest-first before the combine; ``combine="fused"`` instead
  rotates the [P] coefficient *columns* by the ring head (``_rotated``),
  so the [P, N] data is never gathered or rotated.
- ``"concat"``: the seed layout that re-stacks the buffer every step.

Combines (``spec.combine``): ``"einsum"`` (one ``torch.einsum``
contraction), ``"kernel"`` (the ``sa_update`` kernel: one launch for the
predictor and one for the corrector per step), ``"fused"`` (the
dual-output ``sa_fused_update`` kernel: predictor and corrector partial
sums in one pass, so the post-eval corrector touches only the new eval).
Kernel calls go through ``kernels.ops``: the Hopper kernel on a CUDA
tensor, the plain version on a CPU tensor.

Precision policy (``spec.precision``): ``"f32"`` or ``"bf16"`` (state,
history and model input carried in bfloat16, every combine accumulating
in f32, tables f32, the same f32 noise stream rounded to bfloat16).

Step programs (``spec.program``, a
:class:`repro_torch.core.programs.StepProgram`): per-interval orders and
taus land in the zero-padded coefficient tables (data), while the mode
pattern is structure and goes into the statics as contiguous
``(use_corrector, pece, length)`` segments, which the executor's one loop
over the global step index follows (so the ring head runs on across
segment boundaries). A single-segment program collapses to exactly the
fixed-spec statics, so constant programs are bitwise the fixed path.
Patterns that fragment into more than :data:`MAX_SCAN_SEGMENTS` segments
fall back to the statics ``("cond",)``: every step runs the corrector
combine (predictor-only steps get ``corr := pred`` rows, folded before
the kernel coefficients are packed) and the PECE re-evaluation follows a
per-step flag kept on the host, so every such pattern at one step count
shares one statics tuple.

Feature caching (``spec.feature_cache``, ring history, no program):
every evaluation goes through the Denoiser's cached companion, and step
i refreshes the cached mid-stack features when ``fc_refresh[i]`` (a host
tuple of the plan) says so or, under the ``residual`` policy
(``fc_gated``, a host flag), when the previous step's
predictor-vs-corrector residual reached ``fc_thresh`` (a float32 table,
so a threshold sweep is data). That decision stays on the device: the
residual and the threshold meet in a device flag that gates the deep
segment (:func:`repro_torch.kernels.graph_gate.run_if`, a conditional
node of the solve's CUDA graph), one flag per lane in a lane-batched
solve. The interval policy builds no gate. The init evaluation always
refreshes; a PECE re-evaluation reuses its step's features.

Trajectories: with per-step buffers ``traj = {"x", "x0"}`` the executor
writes the state after each step and the step's denoised preview (the
data-convention eval, or x0 rebuilt from the state the eval saw) into row
i, on the device.

The step-granular adapter (:func:`multistep_stepwise`) is the same step
refactored from "a loop over steps, one solve" to "one tick over lanes,
each at its own step index": the lane index lives on the device, the
coefficients come by a gather at each lane's step, and the init
evaluation runs in-band as a lane's first tick.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...kernels import ops
from ..coefficients import SolverTables, TableBuilder, build_tables
from ..denoiser import lane_view
from ..programs import StepProgram
from .base import SamplerFamily, SamplerSpec, carry_dtype, register_sampler
from .stepwise import StepAdapter

__all__ = ["MAX_SCAN_SEGMENTS", "execute_multistep", "fc_policy",
           "make_multistep_family", "multistep_nfe", "multistep_statics",
           "multistep_steps_from_nfe", "multistep_stepwise",
           "multistep_stepwise_arrays", "plan_from_tables", "plan_multistep",
           "tables_to_arrays"]

_COMBINES = ("einsum", "kernel", "fused")
_HISTORIES = ("ring", "concat")

#: a program whose mode pattern fragments into more contiguous segments
#: than this runs under the statics ``("cond",)``: the mode pattern moves
#: into plan data (folded corrector rows and per-step PECE flags), so every
#: such pattern at one step count shares one statics tuple
MAX_SCAN_SEGMENTS = 4


def _use_cond_fallback(program: StepProgram | None, n_steps: int) -> bool:
    return (program is not None
            and len(program.segments(n_steps)) > MAX_SCAN_SEGMENTS)


def check_program(spec: SamplerSpec) -> StepProgram | None:
    if spec.program is None:
        return None
    if not isinstance(spec.program, StepProgram):
        raise TypeError(
            f"spec.program must be a StepProgram, got "
            f"{type(spec.program).__name__} (build one with "
            "repro_torch.core.programs.StepProgram / program_preset / "
            "parse_program)")
    L = spec.program.length()
    if L is not None and L != spec.n_steps:
        raise ValueError(
            f"program covers {L} intervals but the spec solves "
            f"{spec.n_steps} steps")
    return spec.program


def fc_policy(spec: SamplerSpec):
    """Normalize ``spec.feature_cache`` to ``None``, ``("interval", k)``
    or ``("residual", thresh)``; raises on anything else. The policy's
    parameters are plan data; only on/off reaches the statics."""
    fc = spec.feature_cache
    if fc is None:
        return None
    if isinstance(fc, int) and not isinstance(fc, bool):
        if fc < 1:
            raise ValueError(f"feature_cache interval must be >= 1, got {fc}")
        return ("interval", int(fc))
    if isinstance(fc, tuple) and len(fc) == 2 and fc[0] == "residual":
        return ("residual", float(fc[1]))
    raise ValueError(
        f"feature_cache={fc!r}; expected None, an int refresh interval, "
        "or ('residual', threshold)")


def _fc_plan(spec: SamplerSpec) -> dict:
    """The feature cache's plan data: ``fc_refresh``, one host flag per
    step (the interval policy refreshes every k-th step; the init
    evaluation always refreshes, so step 0 may reuse fresh features; the
    residual policy plans step 0 only), ``fc_gated``, a host flag (the
    residual policy: steps not planned refresh on the device's decision),
    and ``fc_thresh``, the residual trigger as a 0-d float32 table (as the
    reference's; +inf for the interval policy: it never fires)."""
    fc = fc_policy(spec)
    if fc is None:
        return {}
    M = spec.n_steps
    if fc[0] == "interval":
        refresh = (np.arange(M) + 1) % fc[1] == 0
        thresh = math.inf
    else:
        refresh = np.arange(M) == 0
        thresh = float(np.float32(fc[1]))
    return {"fc_refresh": tuple(bool(r) for r in refresh),
            "fc_gated": fc[0] == "residual",
            "fc_thresh": torch.tensor(thresh, dtype=torch.float32)}


def _rotated(a: dict, i: int, P: int, *rows) -> torch.Tensor:
    """[len(rows), P+2] packed-coefficient matrix with the b-columns
    rotated to ring positions (age j sits in slot (i - j) mod P), so the
    ring data never moves."""
    pos = torch.tensor([(i - j) % P for j in range(P)])
    c = torch.zeros((len(rows), P + 2), dtype=torch.float32)
    c[:, 0] = a["decay"][i]
    c[:, 1] = a["noise"][i]
    c[:, 2 + pos] = torch.stack(rows)
    return c


def tables_to_arrays(tables: SolverTables, corr=None) -> dict:
    """f32 view of the host-f64 coefficient tables, plus the packed
    coefficient rows the kernel combines take (the same f32 values, laid
    out once per plan instead of once per step). ``corr`` replaces
    ``tables.corr`` (the cond fallback's folded rows) before any packing:

    - ``pred_packed`` [M, P+2]: (decay, noise, pred row), newest-first;
    - ``corr_packed`` [M, P+3]: (decay, noise, corr_new, corr row);
    - ``fused_packed`` [M, 2, P+2]: predictor and corrector rows rotated
      to the ring head (row 0 alone is the predictor-only combine).
    """
    f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
    a = dict(ts=f32(tables.ts), decay=f32(tables.decay),
             noise=f32(tables.noise), pred=f32(tables.pred),
             corr_new=f32(tables.corr_new),
             corr=f32(tables.corr if corr is None else corr))
    if tables.alphas is not None:
        a["alphas"] = f32(tables.alphas)
        a["sigmas"] = f32(tables.sigmas)
    M, P = a["pred"].shape
    head = torch.stack([a["decay"], a["noise"]], dim=1)
    a["pred_packed"] = torch.cat([head, a["pred"]], dim=1)
    a["corr_packed"] = torch.cat([head, a["corr_new"][:, None], a["corr"]],
                                 dim=1)
    a["fused_packed"] = torch.stack(
        [_rotated(a, i, P, a["pred"][i], a["corr"][i]) for i in range(M)])
    return a


def plan_multistep(spec: SamplerSpec, builder: TableBuilder):
    """Build the family's coefficient tables and ship them as plan data
    (:func:`plan_from_tables`)."""
    tables = build_tables(
        spec.resolve_schedule(), spec.grid_ts(),
        tau=spec.tau,
        predictor_order=spec.predictor_order,
        corrector_order=spec.corrector_order,
        parameterization=spec.parameterization,
        program=check_program(spec),
        builder=builder,
    )
    return plan_from_tables(spec, tables)


def plan_from_tables(spec: SamplerSpec, tables: SolverTables):
    """Ship built coefficient tables as the plan's ``(arrays, host)``, as
    they are (the legacy surface hands in prebuilt tables).

    Under the cond fallback the predictor-only steps' corrector rows are
    folded to their predictor rows (``corr_new`` is already 0 there, so
    the unconditional corrector combine reproduces ``x_pred``) BEFORE the
    kernel coefficients are packed from them, and the per-step PECE flags
    ride the plan as a host tuple. The host ``tables`` keep the true
    rows."""
    program = check_program(spec)
    if not _use_cond_fallback(program, spec.n_steps):
        return (tables_to_arrays(tables) | _fc_plan(spec),
                {"ts": tables.ts, "tables": tables})
    corr = np.array(tables.corr)
    p_only = tables.c_orders == 0
    corr[p_only] = tables.pred[p_only]
    arrays = tables_to_arrays(tables, corr=corr)
    arrays["pece"] = tuple(bool(p) for _, p in
                           program.mode_flags(spec.n_steps))
    return arrays, {"ts": tables.ts, "tables": tables}


def multistep_statics(spec: SamplerSpec, convention: str) -> tuple:
    """The spec fields the executor branches on (validated here, before
    any planning). ``convention`` is the prediction convention of the
    family's tables. The mode structure is ``(use_corrector, pece)`` for
    a fixed spec or a mode-uniform program, ``("segments", segs)`` for a
    program of 2..MAX_SCAN_SEGMENTS segments, ``("cond",)`` beyond. The
    last field says whether feature caching is on; its policy and
    threshold are plan data."""
    if spec.combine not in _COMBINES:
        raise ValueError(
            f"combine={spec.combine!r}; expected one of {_COMBINES}")
    if spec.history not in _HISTORIES:
        raise ValueError(
            f"history={spec.history!r}; expected one of {_HISTORIES}")
    carry_dtype(spec.precision)  # validates the policy value
    if spec.combine == "fused" and spec.history != "ring":
        raise ValueError(
            "combine='fused' takes the ring-buffer layout (its rotated "
            "coefficient columns encode the ring head); use "
            "history='ring' or a non-fused combine")
    program = check_program(spec)
    fc = fc_policy(spec)
    if fc is not None:
        if program is not None:
            raise ValueError(
                "feature_cache does not compose with step programs (the "
                "per-step modes and the cached-eval dispatch would nest); "
                "drop one of the two")
        if spec.history != "ring":
            raise ValueError("feature_cache requires history='ring'")
        if fc[0] == "residual" and spec.corrector_order <= 0:
            raise ValueError(
                "the 'residual' feature-cache policy rides the free "
                "predictor-vs-corrector residual: it needs "
                "corrector_order > 0 (use an int interval otherwise)")
    if program is not None:
        segs = program.segments(spec.n_steps)
        if len(segs) == 1:
            # mode-uniform: exactly the fixed-spec statics
            modes = (segs[0][0], segs[0][1])
        elif len(segs) > MAX_SCAN_SEGMENTS:
            modes = ("cond",)
        else:
            modes = ("segments", segs)
    else:
        use_corrector = spec.corrector_order > 0
        modes = (use_corrector, spec.mode == "PECE" and use_corrector)
    return (convention, modes, spec.combine,
            spec.denoise_final and convention == "data",
            spec.history == "ring", spec.precision, fc is not None)


def _step_modes(modes: tuple, dev: dict, M: int) -> list:
    """Per-step ``(use_corrector, pece)`` host flags of the statics' mode
    structure."""
    if modes[0] == "segments":
        flags = [(uc, pece) for uc, pece, n in modes[1] for _ in range(n)]
    elif modes[0] == "cond":
        # every step runs the corrector combine (predictor-only steps
        # were folded into the tables); the re-eval follows the host flags
        flags = [(True, pece) for pece in dev["pece"]]
    else:
        flags = [(modes[0], modes[1])] * M
    if len(flags) != M:
        raise ValueError(
            f"mode segments cover {len(flags)} steps but the tables have {M}")
    return flags


def _combine_rows(combine, cdt, decay_i, x_prev, packed, buf, noise_i, xi):
    """The combine over an age-ordered (newest-first) row stack. ``packed``
    is (decay, noise, b_0..): the kernel takes it whole, the einsum reads
    the b columns."""
    if combine == "kernel":
        return ops.sa_update(x_prev, buf, xi, packed)
    f32 = torch.float32
    acc = torch.einsum("p,p...->...", packed[2:], buf.to(f32))
    return (decay_i * x_prev.to(f32) + acc + noise_i * xi.to(f32)).to(cdt)


def _combine_groups(cdt, x, packed, rows, xi, G: int):
    """The einsum combine of a candidate-stacked solve: lanes come in
    groups of ``G`` under one plan (a candidate's seeds), and each group
    runs the solo contraction of :func:`_combine_rows` over its [R, G,
    *shape] rows, so its lanes round exactly as ``sample_batched`` of that
    plan alone does (torch's contraction over [L, R] rows rounds
    otherwise)."""
    out = [_combine_rows("einsum", cdt, packed[g, 0], x[g:g + G], packed[g],
                         rows[g:g + G].transpose(0, 1).contiguous(),
                         packed[g, 1], xi[g:g + G])
           for g in range(0, x.shape[0], G)]
    return torch.cat(out)


def _pc_residual(x_next, x_pred, lanes: bool = False) -> torch.Tensor:
    """Relative-RMS predictor-vs-corrector gap, the free step-change
    signal a step with a corrector already computes both states for: it
    drives the ``residual`` feature-cache refresh and the step protocol's
    early exit. ``lanes``: one gap per lane of [L, *shape] states, [L]."""
    f32 = torch.float32
    dims = tuple(range(1, x_next.dim())) if lanes else None
    mean = (lambda v: torch.mean(v, dim=dims)) if lanes else torch.mean
    diff = x_next.to(f32) - x_pred.to(f32)
    return torch.sqrt(mean(diff * diff)) / (
        torch.sqrt(mean(x_next.to(f32) ** 2)) + 1e-8)


def _x0_preview(dev, parameterization, cdt, x_eval, e_new, i):
    """The step's denoised preview: the eval itself in the data
    convention; else x0 rebuilt at t_{i+1} from the state the eval saw.
    ``i`` is a step index, or one per lane ([L] on the device)."""
    if parameterization == "data":
        return e_new
    f32 = torch.float32
    sig = lane_view(dev["sigmas"][i + 1], x_eval)
    alp = lane_view(dev["alphas"][i + 1], x_eval)
    return ((x_eval.to(f32) - sig * e_new.to(f32)) / alp).to(cdt)


def execute_multistep(statics, dev, model_fn, x_T, noise, traj=None):
    """The multistep solve as a Python loop over the M steps on the device
    of ``x_T``, each step in the mode its segment (or host flag) gives it.
    ``noise`` is the float32 [M, *x_T.shape] buffer of the steps' Gaussian
    draws (row i is step i's), read on the device: the loop reads no host
    value but the plan's host flags, so it can be captured as a CUDA
    graph. ``traj``: None, or the ``{"x", "x0"}`` [M, *x_T.shape] buffers
    whose row i gets the state after step i and its denoised preview.

    Feature caching (``statics[-1]``): every evaluation goes through
    ``model_fn.cached_call`` with the features carried from the last
    refresh; step i refreshes when ``fc_refresh[i]`` or, under the
    residual policy (``fc_gated``), on the device flag ``prev_err >=
    fc_thresh`` of the previous step's float32 residual: 0-d, or one per
    lane where ``model_fn.lanes`` (a lane-batched solve, whose lanes
    refresh each on its own residual, as the reference's vmapped solve
    does).

    Per-lane tables (``dev["stacked"]``, the candidate-stacked solve of
    :func:`repro_torch.core.samplers.base.stacked_solve`): every table
    has a lane axis after its step axis, so step i's row of every lane is
    one [L, ...] block (``fc_thresh`` is [L]): the scalars are read per
    lane (``lane_view``), the combines take one coefficient row per lane
    (the lane entries ``ops.sa_update_lanes`` / ``sa_fused_update_lanes``;
    the einsum once per group of lanes that share a plan,
    ``dev["lane_group"]``), and the history is laid out [L, P, *shape],
    the lane entries' layout (the step tick's too), so no kernel call
    transposes it. Every lane has its own residual and refresh flag
    under the feature cache."""
    parameterization, modes, combine, denoise, ring, precision, fc = statics
    stacked = dev.get("stacked", False)
    P = dev["pred"].shape[-1]  # buffer rows = max(pred order, corr order)
    M = dev["decay"].shape[0]
    flags = _step_modes(modes, dev, M)
    cdt = carry_dtype(precision)
    f32 = torch.float32

    x = x_T.to(cdt)
    lanes = getattr(model_fn, "lanes", False)
    at = lambda v: lane_view(v, x)  # noqa: E731  (0-d: as it is)
    if fc:
        gated = dev["fc_gated"]
        feats = model_fn.init_feats(x)
        prev_err = torch.zeros(x.shape[:1] if lanes else (), dtype=f32,
                               device=x.device)

        def eval_model(x_in, t_in, refresh):
            nonlocal feats
            e, feats = model_fn.cached_call(x_in, t_in, feats, refresh)
            return e.to(cdt)
    else:
        def eval_model(x_in, t_in, refresh):
            return model_fn(x_in, t_in).to(cdt)

    # the history axis: [P, *x.shape], or [L, P, *shape] when stacked
    ax = int(stacked)
    buf = torch.zeros(x.shape[:ax] + (P,) + x.shape[ax:], dtype=cdt,
                      device=x.device)
    slot = lambda s: (slice(None),) * ax + (s,)  # noqa: E731

    def push(e, rows):  # e as the newest row
        return torch.cat([e.unsqueeze(ax), rows], dim=ax)

    buf[slot(0)] = eval_model(x, dev["ts"][0], True)

    def combine_rows(x_prev, packed, rows, xi, i):
        """The einsum/kernel combine of newest-first ``rows`` (the lanes'
        [L, R, *shape] when stacked)."""
        if not stacked:
            return _combine_rows(combine, cdt, dev["decay"][i], x_prev,
                                 packed, rows, dev["noise"][i], xi)
        if combine == "einsum":
            return _combine_groups(cdt, x_prev, packed, rows, xi,
                                   dev["lane_group"])
        return _combine_lanes(combine, cdt, x_prev, packed, rows, xi)

    for i, (use_corrector, pece) in enumerate(flags):
        xi = noise[i].to(cdt)
        t_next = dev["ts"][i + 1]
        if not ring:
            x_pred = combine_rows(x, dev["pred_packed"][i], buf, xi, i)
            e_new = eval_model(x_pred, t_next, True)
            x_next = x_eval = x_pred
            if use_corrector:
                x_next = combine_rows(x, dev["corr_packed"][i],
                                      push(e_new, buf), xi, i)
                if pece:
                    e_new = eval_model(x_next, t_next, True)
                    x_eval = x_next
            buf = push(e_new, buf.narrow(ax, 0, P - 1))
            x = x_next
            if traj is not None:
                traj["x"][i].copy_(x)
                traj["x0"][i].copy_(_x0_preview(dev, parameterization, cdt,
                                                x_eval, e_new, i))
            continue
        # refresh when the plan says so OR (a device flag) the last step
        # moved enough
        refresh = fc and (dev["fc_refresh"][i]
                          or (gated and prev_err >= dev["fc_thresh"]))
        if combine == "fused":
            packed = dev["fused_packed"][i]
            if stacked:
                if use_corrector:
                    x_pred, corr_base = ops.sa_fused_update_lanes(
                        x, buf, xi, packed)
                else:
                    x_pred = ops.sa_update_lanes(x, buf, xi,
                                                 packed[:, 0].contiguous())
            elif use_corrector:
                x_pred, corr_base = ops.sa_fused_update(x, buf, xi, packed)
            else:
                x_pred = ops.sa_update(x, buf, xi, packed[0])
            e_new = eval_model(x_pred, t_next, refresh)
            x_next = x_pred
            if use_corrector:
                # post-eval corrector: only e_new is touched; the history
                # is already folded into corr_base
                x_next = (corr_base.to(f32) + at(dev["corr_new"][i])
                          * e_new.to(f32)).to(cdt)
        else:
            ages = [(i - j) % P for j in range(P)]
            rows = torch.stack([buf[slot(a)] for a in ages], dim=ax)
            x_pred = combine_rows(x, dev["pred_packed"][i], rows, xi, i)
            e_new = eval_model(x_pred, t_next, refresh)
            x_next = x_pred
            if use_corrector:
                x_next = combine_rows(x, dev["corr_packed"][i],
                                      push(e_new, rows), xi, i)
        if fc and gated and use_corrector:
            prev_err = _pc_residual(x_next, x_pred, lanes=lanes)
        x_eval = x_pred  # the state e_new was evaluated at
        if use_corrector and pece:
            # under feature caching the re-eval reuses this step's features
            e_new = eval_model(x_next, t_next, False)
            x_eval = x_next
        # the one history write, in place: e_new becomes age 0 of step
        # i+1 in slot (i+1) mod P, overwriting age P-1, which no combine
        # needs again
        buf[slot((i + 1) % P)] = e_new
        x = x_next
        if traj is not None:
            traj["x"][i].copy_(x)
            traj["x0"][i].copy_(_x0_preview(dev, parameterization, cdt,
                                            x_eval, e_new, i))

    if denoise:
        # the newest eval: ring slot M mod P, concat row 0
        return buf[slot(M % P if ring else 0)]
    return x


def multistep_nfe(spec: SamplerSpec) -> int:
    program = check_program(spec)
    if program is not None:
        # 1 init eval + 1 per step + 1 more per PECE step
        return program.nfe(spec.n_steps)
    per_step = 2 if (spec.mode == "PECE" and spec.corrector_order > 0) else 1
    return spec.n_steps * per_step + 1


def multistep_steps_from_nfe(nfe: int, kw: dict) -> int:
    program = kw.get("program")
    if isinstance(program, StepProgram):
        L = program.length()
        if L is not None:
            # explicit per-interval tracks dictate the step count; an
            # overdraw of the budget raises instead of truncating
            if program.nfe(L) > nfe:
                raise ValueError(
                    f"program spends {program.nfe(L)} evaluations over "
                    f"its {L} intervals but the budget is nfe={nfe}")
            return L
        # all-scalar program: invert its uniform per-step cost
        _, pece = program.mode_flags(1)[0]
        return max(1, (nfe - 1) // (2 if pece else 1))
    pece = kw.get("mode", "PEC") == "PECE" and kw.get("corrector_order", 3) > 0
    return max(1, (nfe - 1) // (2 if pece else 1))


# --------------------------------------------------- step-granular adapter
def _stepwise_modes(spec: SamplerSpec) -> tuple:
    """Mode statics of the lane-batched tick. Each lane sits at its own
    step, so segment boundaries cannot be structure: ANY multi-segment
    program runs the per-step ``("cond",)`` path (every step the corrector
    combine, the PECE re-eval selected by a per-lane flag)."""
    program = check_program(spec)
    if program is not None:
        segs = program.segments(spec.n_steps)
        if len(segs) > 1:
            return ("cond",)
        return (segs[0][0], segs[0][1])
    use_corrector = spec.corrector_order > 0
    return (use_corrector, spec.mode == "PECE" and use_corrector)


def multistep_stepwise_arrays(plan, device) -> dict:
    """The tick's tables on ``device``: the plan's tensors, the feature
    cache's per-step refresh flags as a device tensor, and, under the
    ``("cond",)`` modes, the per-step PECE flags ``pece`` and the
    early-exit gate ``ee_ok`` as device tensors (the tick indexes them by
    each lane's step). A program of up to :data:`MAX_SCAN_SEGMENTS`
    segments kept its segment tables in the plan, so its P-only steps are
    folded here (``corr := pred``) and the kernel coefficients repacked
    from the folded rows, as the cond fallback's plan does."""
    spec = plan.spec
    dev = {k: v for k, v in plan.arrays_on(device).items()
           if isinstance(v, torch.Tensor)}
    if "fc_refresh" in plan.arrays:
        # each lane reads its own step's flag
        dev["fc_refresh"] = torch.tensor(plan.arrays["fc_refresh"],
                                         dtype=torch.bool, device=device)
    if _stepwise_modes(spec)[0] != "cond":
        return dev
    tables = plan.host["tables"]
    p_only = tables.c_orders == 0
    flags = plan.arrays.get("pece")
    if flags is None:
        corr = np.array(tables.corr)
        corr[p_only] = tables.pred[p_only]
        dev = {k: v.to(device) for k, v in
               tables_to_arrays(tables, corr=corr).items()}
        flags = [p for _, p in spec.program.mode_flags(spec.n_steps)]
    dev["pece"] = torch.tensor(flags, dtype=torch.bool, device=device)
    # folded P-only steps report a residual of zero (their corrector
    # combine IS the predictor): they never let a lane exit early
    dev["ee_ok"] = torch.tensor(~p_only, dtype=torch.bool, device=device)
    return dev


def _age_rows_lanes(buf, ic, P):
    """[L, P, *shape] newest-first history rows of each lane: age j sits
    in ring slot (ic - j) mod P of its lane."""
    L = buf.shape[0]
    ages = torch.arange(P, device=buf.device)
    slots = torch.remainder(ic[:, None] - ages[None, :], P)
    return buf[torch.arange(L, device=buf.device)[:, None], slots]


def _combine_lanes(combine, cdt, x, packed, rows, xi):
    """:func:`_combine_rows` with one coefficient row per lane: ``packed``
    [L, R+2] (decay, noise, b_0..) over ``rows`` [L, R, *shape]."""
    if combine == "kernel":
        return ops.sa_update_lanes(x, rows, xi, packed)
    f32 = torch.float32
    acc = torch.einsum("lp,lp...->l...", packed[:, 2:], rows.to(f32))
    return (lane_view(packed[:, 0], x) * x.to(f32) + acc
            + lane_view(packed[:, 1], x) * xi.to(f32)).to(cdt)


def multistep_stepwise(spec: SamplerSpec,
                       convention: str | None = None) -> StepAdapter:
    """The lane-batched tick of the multistep executor: every lane of a
    running batch advances one step at its own step index ``ic`` [L] (on
    the device), in one pass of the same op sequence as
    :func:`execute_multistep`'s ring step. The coefficients are gathered
    per lane from the plan: ``fused_packed[ic]`` [L, 2, P+2] is already
    rotated to each lane's ring head (``_rotated`` packs it per step on
    the host, once per plan), so no host value enters a tick and a tick
    can be captured as a CUDA graph. The init evaluation (seed row e0)
    runs in-band: a lane at ``i = -1`` evaluates the model at
    ``(x_T, ts[0])`` through selects that are bit-transparent on real
    steps."""
    base = multistep_statics(spec, convention)
    (parameterization, _, combine, denoise, ring, precision, fc) = base
    if not ring:
        raise ValueError(
            "step-granular multistep needs history='ring' (the concat "
            "layout re-stacks the buffer every step and exists only as the "
            "seed regression baseline)")
    modes = _stepwise_modes(spec)
    use_corrector = True if modes[0] == "cond" else modes[0]
    pece = "cond" if modes[0] == "cond" else modes[1]
    cdt = carry_dtype(precision)
    f32 = torch.float32

    def init_inner(dev, x_T):
        P = dev["pred"].shape[1]
        x = x_T.to(cdt)
        return {"x": x, "buf": torch.zeros((P,) + tuple(x.shape), dtype=cdt,
                                           device=x.device)}

    def step(dev, model_fn, inner, ic, init, xi):
        x, buf = inner["x"], inner["buf"]
        xi = xi.to(cdt)
        L, P = buf.shape[0], buf.shape[1]
        lanes = lambda v: lane_view(v, x)  # noqa: E731
        t_next = dev["ts"][ic + 1]
        rows = None
        if combine == "fused":
            packed = dev["fused_packed"][ic]
            if use_corrector:
                x_pred, corr_base = ops.sa_fused_update_lanes(x, buf, xi,
                                                              packed)
            else:
                x_pred = ops.sa_update_lanes(x, buf, xi,
                                             packed[:, 0].contiguous())
        else:
            # einsum/kernel gather the rows newest-first, as the whole
            # solve does (the reference's ring layout): the same rows in
            # the same order keep a lane bitwise its sample_batched solve.
            # The row-free combine is "fused".
            rows = _age_rows_lanes(buf, ic, P)
            x_pred = _combine_lanes(combine, cdt, x, dev["pred_packed"][ic],
                                    rows, xi)
        # init tick: evaluate at (x_T, ts[0]) instead; on real steps both
        # selects pick the step's operand bit for bit
        x_in = torch.where(lanes(init), x, x_pred)
        t_in = torch.where(init, dev["ts"][0], t_next)
        e_new = model_fn(x_in, t_in).to(cdt)
        x_eval = x_in
        if use_corrector:
            if combine == "fused":
                x_next = (corr_base.to(f32) + lanes(dev["corr_new"][ic])
                          * e_new.to(f32)).to(cdt)
            else:
                x_next = _combine_lanes(
                    combine, cdt, x, dev["corr_packed"][ic],
                    torch.cat([e_new[:, None], rows], dim=1), xi)
            # the predictor-vs-corrector residual, before any re-eval
            err = _pc_residual(x_next, x_pred, lanes=True)
            if pece == "cond":
                # a per-lane predicate: both evaluations, then a select
                # (two evaluations a tick, in evals_per_tick)
                e2 = model_fn(x_next, t_next).to(cdt)
                hit = dev["pece"][ic] & ~init
                e_new = torch.where(lanes(hit), e2, e_new)
                x_eval = torch.where(lanes(hit), x_next, x_eval)
                err = torch.where(dev["ee_ok"][ic], err, math.inf)
            elif pece:
                e2 = model_fn(x_next, t_next).to(cdt)
                e_new = torch.where(lanes(init), e_new, e2)
                x_eval = torch.where(lanes(init), x_eval, x_next)
        else:
            x_next = x_pred
            err = torch.full((L,), math.inf, device=x.device)
        # the ONE history write; the init eval is the seed row in slot 0
        slot = torch.where(init, 0, torch.remainder(ic + 1, P))
        buf = buf.clone()
        buf[torch.arange(L, device=buf.device), slot] = e_new
        x_out = torch.where(lanes(init), x, x_next)
        # denoise-final: the newest eval is this tick's e_new, so a lane
        # that exits early has its result in hand
        final = e_new if denoise else x_out
        x0 = _x0_preview(dev, parameterization, cdt, x_eval, e_new, ic)
        return {"x": x_out, "buf": buf}, final, x0, err

    return StepAdapter(
        statics=(parameterization, modes, combine, denoise, precision, fc),
        i0=-1,
        evals_per_tick=2 if pece else 1,
        n_steps_of=lambda dev: int(dev["decay"].shape[0]),
        init_inner=init_inner,
        step=step,
        arrays=multistep_stepwise_arrays,
        shape_key=lambda plan: (int(plan.arrays["pred"].shape[1]),
                                "alphas" in plan.arrays),
    )


def make_multistep_family(name: str, builder_of, *,
                          tau_inert: bool = False) -> SamplerFamily:
    """Register a solver family that is only a coefficient-table rule:
    ``builder_of(spec) -> TableBuilder``. It takes full step programs and
    the step protocol (``stepwise``); ``tau_inert`` marks a family whose
    rule maps every tau to 0."""
    def plan(spec):
        return plan_multistep(spec, builder_of(spec))

    def statics(spec):
        return multistep_statics(spec, builder_of(spec).parameterization)

    def convention(spec):
        return builder_of(spec).parameterization

    def stepwise(spec):
        return multistep_stepwise(spec, builder_of(spec).parameterization)

    family = SamplerFamily(
        name=name, plan=plan, execute=execute_multistep, statics=statics,
        nfe_of=multistep_nfe, steps_from_nfe=multistep_steps_from_nfe,
        model_convention=convention, stepwise=stepwise,
        supports_feature_cache=True, full_programs=True,
        tau_inert=tau_inert)
    return register_sampler(family)
