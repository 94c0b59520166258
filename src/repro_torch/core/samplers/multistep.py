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
tuple of the plan) says so or, under the ``residual`` policy, when the
previous step's predictor-vs-corrector residual reached ``fc_thresh``.
The interval policy reads host data only; the residual policy reads the
residual back to the host once per step (one device sync). The init
evaluation always refreshes; a PECE re-evaluation reuses its step's
features.

The step-granular adapter comes with a later slice of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...kernels import ops
from ...kernels.sa_update import MAX_ROWS
from ..coefficients import SolverTables, TableBuilder, build_tables
from ..programs import StepProgram
from .base import SamplerFamily, SamplerSpec, carry_dtype, register_sampler

__all__ = ["MAX_SCAN_SEGMENTS", "execute_multistep", "fc_policy",
           "make_multistep_family", "multistep_nfe", "multistep_statics",
           "multistep_steps_from_nfe", "plan_multistep", "tables_to_arrays"]

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


def _check_kernel_rows(spec: SamplerSpec, tables: SolverTables) -> None:
    """Refuse a kernel combine whose calls would stack more history rows
    than the kernels are instantiated for, before any evaluation: the
    plain versions take any P, so the CPU would solve what the card
    cannot."""
    if spec.combine not in ("kernel", "fused"):
        return
    R = tables.pred.shape[1]
    # a program's c_orders are 0 exactly on its predictor-only steps (the
    # cond fallback runs the corrector combine only if some step has one)
    corrector = (spec.corrector_order > 0 if tables.c_orders is None
                 else bool((tables.c_orders > 0).any()))
    # the kernel combine's corrector call stacks the predicted-point
    # eval on top of the R history rows
    rows = R + 1 if spec.combine == "kernel" and corrector else R
    if rows > MAX_ROWS:
        raise ValueError(
            f"combine={spec.combine!r} needs {rows} history rows in one "
            f"kernel call (table width {R}"
            + (", plus the predicted-point evaluation" if rows > R else "")
            + f"); the sa_update/sa_fused kernels take 1..{MAX_ROWS} rows. "
            "Use combine='einsum', or lower the orders or program width")


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
    """The feature cache's plan data, kept on the host: ``fc_refresh``,
    one flag per step (the interval policy refreshes every k-th step; the
    init evaluation always refreshes, so step 0 may reuse fresh features;
    the residual policy plans step 0 only), and ``fc_thresh``, the
    residual trigger (float32, as the reference's table; +inf for the
    interval policy: it never fires)."""
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
            "fc_thresh": thresh}


def _reads_residual(arrays: dict) -> bool:
    """Whether the plan's feature cache is the residual policy, whose
    steps read the residual back to the host (a finite threshold)."""
    return arrays.get("fc_thresh", math.inf) < math.inf


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
    """Build the family's coefficient tables and ship them as plan data.

    Under the cond fallback the predictor-only steps' corrector rows are
    folded to their predictor rows (``corr_new`` is already 0 there, so
    the unconditional corrector combine reproduces ``x_pred``) BEFORE the
    kernel coefficients are packed from them, and the per-step PECE flags
    ride the plan as a host tuple. The host ``tables`` keep the true
    rows."""
    schedule = spec.resolve_schedule()
    ts = spec.grid_ts()
    program = check_program(spec)
    tables = build_tables(
        schedule, ts,
        tau=spec.tau,
        predictor_order=spec.predictor_order,
        corrector_order=spec.corrector_order,
        parameterization=spec.parameterization,
        program=program,
        builder=builder,
    )
    _check_kernel_rows(spec, tables)
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


def _pc_residual(x_next, x_pred) -> torch.Tensor:
    """Relative-RMS predictor-vs-corrector gap, the free step-change
    signal a step with a corrector already computes both states for: it
    drives the ``residual`` feature-cache refresh."""
    f32 = torch.float32
    diff = x_next.to(f32) - x_pred.to(f32)
    return torch.sqrt(torch.mean(diff * diff)) / (
        torch.sqrt(torch.mean(x_next.to(f32) ** 2)) + 1e-8)


def execute_multistep(statics, dev, model_fn, x_T, noise):
    """The multistep solve as a Python loop over the M steps on the device
    of ``x_T``, each step in the mode its segment (or host flag) gives it.
    ``noise`` is the float32 [M, *x_T.shape] buffer of the steps' Gaussian
    draws (row i is step i's), read on the device: the loop reads no host
    value but the plan's host flags, so it can be captured as a CUDA graph
    (all but the residual policy's per-step read).

    Feature caching (``statics[-1]``): every evaluation goes through
    ``model_fn.cached_call`` with the features carried from the last
    refresh; step i refreshes when ``fc_refresh[i]`` or the previous
    step's residual reached ``fc_thresh`` (read back only when the
    threshold is finite, the residual policy)."""
    _, modes, combine, denoise, ring, precision, fc = statics
    P = dev["pred"].shape[1]  # buffer rows = max(pred order, corr order)
    M = dev["decay"].shape[0]
    flags = _step_modes(modes, dev, M)
    cdt = carry_dtype(precision)
    f32 = torch.float32

    x = x_T.to(cdt)
    if fc:
        gated = dev["fc_thresh"] < math.inf
        feats = model_fn.init_feats(x)

        def eval_model(x_in, t_in, refresh):
            nonlocal feats
            e, feats = model_fn.cached_call(x_in, t_in, feats, refresh)
            return e.to(cdt)
    else:
        def eval_model(x_in, t_in, refresh):
            return model_fn(x_in, t_in).to(cdt)

    buf = torch.zeros((P,) + tuple(x.shape), dtype=cdt, device=x.device)
    buf[0] = eval_model(x, dev["ts"][0], True)
    prev_err = 0.0

    for i, (use_corrector, pece) in enumerate(flags):
        xi = noise[i].to(cdt)
        decay_i = dev["decay"][i]
        noise_i = dev["noise"][i]
        t_next = dev["ts"][i + 1]
        if not ring:
            x_pred = _combine_rows(combine, cdt, decay_i, x,
                                   dev["pred_packed"][i], buf, noise_i, xi)
            e_new = eval_model(x_pred, t_next, True)
            x_next = x_pred
            if use_corrector:
                rows = torch.cat([e_new[None], buf], dim=0)
                x_next = _combine_rows(combine, cdt, decay_i, x,
                                       dev["corr_packed"][i], rows,
                                       noise_i, xi)
                if pece:
                    e_new = eval_model(x_next, t_next, True)
            buf = torch.cat([e_new[None], buf[:-1]], dim=0)
            x = x_next
            continue
        # refresh when the plan says so OR the last step moved enough
        refresh = fc and (dev["fc_refresh"][i]
                          or (gated and prev_err >= dev["fc_thresh"]))
        if combine == "fused":
            if use_corrector:
                x_pred, corr_base = ops.sa_fused_update(
                    x, buf, xi, dev["fused_packed"][i])
            else:
                x_pred = ops.sa_update(x, buf, xi, dev["fused_packed"][i, 0])
            e_new = eval_model(x_pred, t_next, refresh)
            x_next = x_pred
            if use_corrector:
                # post-eval corrector: only e_new is touched; the history
                # is already folded into corr_base
                x_next = (corr_base.to(f32) + dev["corr_new"][i]
                          * e_new.to(f32)).to(cdt)
        else:
            rows = [buf[(i - j) % P] for j in range(P)]
            x_pred = _combine_rows(combine, cdt, decay_i, x,
                                   dev["pred_packed"][i], torch.stack(rows),
                                   noise_i, xi)
            e_new = eval_model(x_pred, t_next, refresh)
            x_next = x_pred
            if use_corrector:
                x_next = _combine_rows(combine, cdt, decay_i, x,
                                       dev["corr_packed"][i],
                                       torch.stack([e_new] + rows),
                                       noise_i, xi)
        if fc and gated and use_corrector:
            # the one device-to-host read of the residual policy
            prev_err = float(_pc_residual(x_next, x_pred))
        if use_corrector and pece:
            # under feature caching the re-eval reuses this step's features
            e_new = eval_model(x_next, t_next, False)
        # the one history write, in place: e_new becomes age 0 of step
        # i+1 in slot (i+1) mod P, overwriting age P-1, which no combine
        # needs again
        buf[(i + 1) % P] = e_new
        x = x_next

    if denoise:
        # the newest eval: ring slot M mod P, concat row 0
        return buf[M % P] if ring else buf[0]
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


def make_multistep_family(name: str, builder_of, *,
                          tau_inert: bool = False) -> SamplerFamily:
    """Register a solver family that is only a coefficient-table rule:
    ``builder_of(spec) -> TableBuilder``. It takes full step programs;
    ``tau_inert`` marks a family whose rule maps every tau to 0."""
    def plan(spec):
        return plan_multistep(spec, builder_of(spec))

    def statics(spec):
        return multistep_statics(spec, builder_of(spec).parameterization)

    def convention(spec):
        return builder_of(spec).parameterization

    family = SamplerFamily(
        name=name, plan=plan, execute=execute_multistep, statics=statics,
        nfe_of=multistep_nfe, steps_from_nfe=multistep_steps_from_nfe,
        model_convention=convention, full_programs=True, tau_inert=tau_inert,
        reads_back=_reads_residual)
    return register_sampler(family)
