"""Family-agnostic multistep-integrator core.

SA-Solver (and, in later slices, SEEDS and DPM-Solver++ multistep) are
exponential Adams integrators: per interval, the next state is
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

Step programs, feature caching, the cond fallback and the step-granular
adapter come with later slices of the port; a spec that asks for them
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ...kernels import ops
from ..coefficients import SolverTables, TableBuilder, build_tables
from .base import SamplerFamily, SamplerSpec, carry_dtype, register_sampler

__all__ = ["execute_multistep", "make_multistep_family", "multistep_nfe",
           "multistep_statics", "multistep_steps_from_nfe", "plan_multistep",
           "tables_to_arrays"]

_COMBINES = ("einsum", "kernel", "fused")
_HISTORIES = ("ring", "concat")


def _unported(spec: SamplerSpec) -> None:
    if spec.program is not None:
        raise NotImplementedError(
            "step programs (spec.program) come with the step-program slice "
            "of the PyTorch port; use a fixed spec")
    if spec.feature_cache is not None:
        raise NotImplementedError(
            "feature caching (spec.feature_cache) comes with the "
            "feature-cache slice of the PyTorch port")


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


def tables_to_arrays(tables: SolverTables) -> dict:
    """f32 view of the host-f64 coefficient tables, plus the packed
    coefficient rows the kernel combines take (the same f32 values, laid
    out once per plan instead of once per step):

    - ``pred_packed`` [M, P+2]: (decay, noise, pred row), newest-first;
    - ``corr_packed`` [M, P+3]: (decay, noise, corr_new, corr row);
    - ``fused_packed`` [M, 2, P+2]: predictor and corrector rows rotated
      to the ring head (row 0 alone is the predictor-only combine).
    """
    f32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
    a = dict(ts=f32(tables.ts), decay=f32(tables.decay),
             noise=f32(tables.noise), pred=f32(tables.pred),
             corr_new=f32(tables.corr_new), corr=f32(tables.corr))
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
    """Build the family's coefficient tables and ship them as plan data."""
    tables = build_tables(
        spec.resolve_schedule(), spec.grid_ts(),
        tau=spec.tau,
        predictor_order=spec.predictor_order,
        corrector_order=spec.corrector_order,
        parameterization=spec.parameterization,
        builder=builder,
    )
    return tables_to_arrays(tables), {"ts": tables.ts, "tables": tables}


def multistep_statics(spec: SamplerSpec, convention: str) -> tuple:
    """The spec fields the executor branches on (validated here, before
    any planning). ``convention`` is the prediction convention of the
    family's tables."""
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
    _unported(spec)
    use_corrector = spec.corrector_order > 0
    modes = (use_corrector, spec.mode == "PECE" and use_corrector)
    return (convention, modes, spec.combine,
            spec.denoise_final and convention == "data",
            spec.history == "ring", spec.precision)


def _combine_rows(combine, cdt, decay_i, x_prev, packed, buf, noise_i, xi):
    """The combine over an age-ordered (newest-first) row stack. ``packed``
    is (decay, noise, b_0..): the kernel takes it whole, the einsum reads
    the b columns."""
    if combine == "kernel":
        return ops.sa_update(x_prev, buf, xi, packed)
    f32 = torch.float32
    acc = torch.einsum("p,p...->...", packed[2:], buf.to(f32))
    return (decay_i * x_prev.to(f32) + acc + noise_i * xi.to(f32)).to(cdt)


def execute_multistep(statics, dev, model_fn, x_T, noise):
    """The multistep solve as a Python loop over the M steps on the device
    of ``x_T``. ``noise(i)`` returns step i's float32 Gaussian draw."""
    _, (use_corrector, pece), combine, denoise, ring, precision = statics
    P = dev["pred"].shape[1]  # buffer rows = max(pred order, corr order)
    M = dev["decay"].shape[0]
    cdt = carry_dtype(precision)
    f32 = torch.float32

    def eval_model(x_in, t_in):
        return model_fn(x_in, t_in).to(cdt)

    x = x_T.to(cdt)
    buf = torch.zeros((P,) + tuple(x.shape), dtype=cdt, device=x.device)
    buf[0] = eval_model(x, dev["ts"][0])

    for i in range(M):
        xi = noise(i).to(cdt)
        decay_i = dev["decay"][i]
        noise_i = dev["noise"][i]
        t_next = dev["ts"][i + 1]
        if not ring:
            x_pred = _combine_rows(combine, cdt, decay_i, x,
                                   dev["pred_packed"][i], buf, noise_i, xi)
            e_new = eval_model(x_pred, t_next)
            x_next = x_pred
            if use_corrector:
                rows = torch.cat([e_new[None], buf], dim=0)
                x_next = _combine_rows(combine, cdt, decay_i, x,
                                       dev["corr_packed"][i], rows,
                                       noise_i, xi)
                if pece:
                    e_new = eval_model(x_next, t_next)
            buf = torch.cat([e_new[None], buf[:-1]], dim=0)
            x = x_next
            continue
        if combine == "fused":
            if use_corrector:
                x_pred, corr_base = ops.sa_fused_update(
                    x, buf, xi, dev["fused_packed"][i])
            else:
                x_pred = ops.sa_update(x, buf, xi, dev["fused_packed"][i, 0])
            e_new = eval_model(x_pred, t_next)
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
            e_new = eval_model(x_pred, t_next)
            x_next = x_pred
            if use_corrector:
                x_next = _combine_rows(combine, cdt, decay_i, x,
                                       dev["corr_packed"][i],
                                       torch.stack([e_new] + rows),
                                       noise_i, xi)
        if use_corrector and pece:
            e_new = eval_model(x_next, t_next)
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
    _unported(spec)
    per_step = 2 if (spec.mode == "PECE" and spec.corrector_order > 0) else 1
    return spec.n_steps * per_step + 1


def multistep_steps_from_nfe(nfe: int, kw: dict) -> int:
    if kw.get("program") is not None:
        raise NotImplementedError(
            "step programs (program=) come with the step-program slice of "
            "the PyTorch port")
    pece = kw.get("mode", "PEC") == "PECE" and kw.get("corrector_order", 3) > 0
    return max(1, (nfe - 1) // (2 if pece else 1))


def make_multistep_family(name: str, builder_of) -> SamplerFamily:
    """Register a solver family that is only a coefficient-table rule:
    ``builder_of(spec) -> TableBuilder``."""
    def plan(spec):
        return plan_multistep(spec, builder_of(spec))

    def statics(spec):
        return multistep_statics(spec, builder_of(spec).parameterization)

    def convention(spec):
        return builder_of(spec).parameterization

    family = SamplerFamily(
        name=name, plan=plan, execute=execute_multistep, statics=statics,
        nfe_of=multistep_nfe, steps_from_nfe=multistep_steps_from_nfe,
        model_convention=convention)
    return register_sampler(family)
