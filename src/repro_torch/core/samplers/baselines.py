"""The paper's baseline samplers (§6.4) on the plan/execute protocol.

Each family is a host-float64 plan (per-interval constants, shipped as f32
tensors) and a whole-solve executor, a Python loop over the steps on the
latent's device, so the compile cache captures it as one CUDA graph on the
card. The numeric knobs (eta, tau, churn and a program's tau track) are
baked into the planned tensors, never into the executor, so sweeping them
at a fixed step count reuses one cache entry and one graph.

Every executor consumes a data-prediction ``model_fn(x, t) -> x0_hat``:
the registry's model convention. The base layer's
:class:`~repro_torch.core.denoiser.Denoiser` converts a wrapped eps-, x0-
or v-prediction network (guided or not) to it before the executor sees it.

The per-step noise is row i of the solve's float32 ``[M, *x_T.shape]``
buffer (the reference draws ``split(key, M)[i]``); the deterministic
families (``dpm_solver_pp_2m``, ``edm_heun``) never read it.

Step programs: the families with a per-step stochasticity knob read only
the program's tau track (:func:`repro_torch.core.programs.program_tau_track`):
for ``ddim`` and ``ddpm_ancestral`` tau is the per-interval eta (0 = ODE
step, 1 = ancestral), for ``edm_stochastic`` it scales the per-step churn,
and for ``euler_maruyama`` it is the SDE's tau(t) made per-interval. The
deterministic families reject a program.

Precision (``spec.precision``): the carried state and the model input are
``carry_dtype``; the step arithmetic is f32 (at f32 the casts are
identities).

Branches: DPM-Solver++(2M)'s first step depends on the loop index, so it
is a host branch. EDM's final-sigma guard (Heun where ``sig[i+1] > 1e-8``,
else the Euler step, whose second evaluation is then never made) depends
on the grid only: the plan decides it on the host from the f32 ``sig``
(the value the reference's device test reads) and carries the flags as a
host tuple, which is part of the graph signature.

Each family also registers its lane-batched step adapter
(:class:`~repro_torch.core.samplers.stepwise.StepAdapter`), the same
arithmetic as one tick over lanes at their own step indices. The two
branches become ``torch.where`` selects there, as in the reference, so an
EDM tick makes both evaluations. The baselines have no free residual:
``err`` is ``inf`` and early exit never fires.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..denoiser import lane_view
from ..programs import StepProgram, program_tau_track
from .base import (SamplerFamily, SamplerSpec, build_plan, carry_dtype,
                   register_sampler, sample)
from .stepwise import StepAdapter

__all__ = ["plan_ddim", "execute_ddim", "plan_dpmpp2m", "execute_dpmpp2m",
           "plan_euler_maruyama", "execute_euler_maruyama",
           "plan_edm_heun", "execute_edm_heun",
           "plan_edm_stochastic", "execute_edm_stochastic",
           # legacy free-function surface (repro_torch.core.baselines)
           "ddim", "dpm_solver_pp_2m", "euler_maruyama", "ddpm_ancestral",
           "edm_heun", "edm_stochastic"]

F32 = torch.float32


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=F32)


def _base_consts(schedule, ts: np.ndarray) -> dict:
    return dict(ts=_f32(ts), alphas=_f32(schedule.alpha(ts)),
                sigmas=_f32(schedule.sigma(ts)))


def _program_steps(nfe: int, kw: dict, per_step: int) -> int | None:
    """Step count dictated by an explicit-length program, or None. An
    overdraw of the budget raises instead of truncating the track."""
    program = kw.get("program")
    if isinstance(program, StepProgram):
        L = program.length()
        if L is not None:
            if per_step * L > nfe:
                raise ValueError(
                    f"program covers {L} intervals ({per_step * L} "
                    f"evaluations at {per_step}/step) but the budget is "
                    f"nfe={nfe}")
            return L
    return None


def _steps_identity(nfe: int, kw: dict) -> int:
    L = _program_steps(nfe, kw, 1)
    return max(1, nfe) if L is None else L


def _steps_heun(nfe: int, kw: dict) -> int:
    L = _program_steps(nfe, kw, 2)
    return max(1, nfe // 2) if L is None else L


def _tau_track_or_none(spec: SamplerSpec, schedule, ts) -> np.ndarray | None:
    if spec.program is None:
        return None
    return program_tau_track(spec.program, schedule, ts, spec.name)


def _reject_program(spec: SamplerSpec) -> None:
    if spec.program is not None:
        raise ValueError(
            f"{spec.name!r} has no per-step stochasticity knob, so a step "
            f"program has nothing to control there; program-capable "
            f"families are 'sa', 'ddim', 'ddpm_ancestral', "
            f"'euler_maruyama', and 'edm_stochastic'")


def _record(traj, i: int, x, x0) -> None:
    if traj is not None:
        traj["x"][i].copy_(x)
        traj["x0"][i].copy_(x0)


# --------------------------------------------------------------------- DDIM
def plan_ddim(spec: SamplerSpec):
    """DDIM-eta (Eq. 19), generalized (alpha, sigma) form."""
    schedule = spec.resolve_schedule()
    ts = spec.grid_ts()
    c = _base_consts(schedule, ts)
    a64, s64 = schedule.alpha(ts), schedule.sigma(ts)
    # per-interval eta: a program's tau track IS the eta track
    track = _tau_track_or_none(spec, schedule, ts)
    etas = np.full(len(ts) - 1, float(spec.eta)) if track is None else track
    # ancestral std: eta * sqrt(sig_next^2/sig_i^2 * (1 - a_i^2/a_next^2))
    with np.errstate(invalid="ignore"):
        var = (etas**2) * (s64[1:] ** 2 / s64[:-1] ** 2) \
            * (1.0 - a64[:-1] ** 2 / a64[1:] ** 2)
    c["sig_hat"] = _f32(np.sqrt(np.clip(var, 0.0, None)))
    # deterministic direction scale: sqrt(sig_next^2 - sig_hat^2)
    c["dir_scale"] = _f32(
        np.sqrt(np.clip(s64[1:] ** 2 - np.clip(var, 0.0, None), 0.0, None)))
    return c, {"ts": ts}


def _reader(dev, x_T):
    """``at(k, i)``: table ``k`` at step ``i``, broadcast over the latent.
    A plan's tables give 0-d scalars (as they are); the candidate-stacked
    solve's per-lane tables (:func:`repro_torch.core.samplers.base.
    stacked_solve`: a lane axis after the step axis) give [L], viewed
    [L, 1, ...] against the lanes' [L, *shape] states."""
    return lambda k, i: lane_view(dev[k][i], x_T)


def execute_ddim(statics, dev, model_fn, x_T, noise, traj=None):
    cdt = carry_dtype(statics[0])
    at = _reader(dev, x_T)
    x = x_T.to(cdt)
    for i in range(dev["sig_hat"].shape[0]):
        a_i, s_i = at("alphas", i), at("sigmas", i)
        x0 = model_fn(x, dev["ts"][i]).to(F32)
        eps = (x.to(F32) - a_i * x0) / s_i
        x = (at("alphas", i + 1) * x0 + at("dir_scale", i) * eps
             + at("sig_hat", i) * noise[i]).to(cdt)
        _record(traj, i, x, x0.to(cdt))
    return x


def _plan_ancestral(spec: SamplerSpec):
    """Ancestral (posterior) sampling == DDIM with eta = 1."""
    return plan_ddim(spec.replace(eta=1.0))


# -------------------------------------------------------- DPM-Solver++(2M)
def plan_dpmpp2m(spec: SamplerSpec):
    """DPM-Solver++(2M), data prediction, deterministic (the official
    multistep second-order update; the first step is DDIM). ``h_prev[0]``
    is NaN by construction: the first step never reads it."""
    _reject_program(spec)
    schedule = spec.resolve_schedule()
    ts = spec.grid_ts()
    c = _base_consts(schedule, ts)
    lam64 = schedule.lam(ts)
    c["h"] = _f32(lam64[1:] - lam64[:-1])
    c["h_prev"] = _f32(np.concatenate([[np.nan], lam64[1:-1] - lam64[:-2]]))
    return c, {"ts": ts}


def execute_dpmpp2m(statics, dev, model_fn, x_T, noise, traj=None):
    del noise  # deterministic
    cdt = carry_dtype(statics[0])
    at = _reader(dev, x_T)
    x = x_T.to(cdt)
    x0_prev = None  # the one previous evaluation: a history of one
    for i in range(dev["h"].shape[0]):
        x0 = model_fn(x, dev["ts"][i]).to(F32)
        a_n, s_n, s_i = (at("alphas", i + 1), at("sigmas", i + 1),
                         at("sigmas", i))
        phi = 1.0 - torch.exp(-at("h", i))
        if i == 0:
            upd = a_n * phi * x0
        else:
            r = at("h_prev", i) / at("h", i)
            upd = a_n * phi * (x0 + (x0 - x0_prev.to(F32)) / (2.0 * r))
        x = ((s_n / s_i) * x.to(F32) + upd).to(cdt)
        x0_prev = x0.to(cdt)
        _record(traj, i, x, x0_prev)
    return x


# ------------------------------------------------------------ Euler-Maruyama
def plan_euler_maruyama(spec: SamplerSpec):
    """Euler-Maruyama on the variance-controlled SDE (Eq. 9) in lambda-time:

    x_{i+1} = x_i + [ (dlog a/dlam)_i x_i - (1+tau^2)(x_i - a_i x0_i) ] dlam
              + tau sigma_i sqrt(2 dlam) xi

    with the per-interval exact slope dlog a / dlam from the grid; tau is
    baked into the drift and noise coefficients."""
    tau = spec.tau
    if not isinstance(tau, (int, float)):
        raise ValueError("euler_maruyama needs a constant (float) tau")
    schedule = spec.resolve_schedule()
    ts = spec.grid_ts()
    c = _base_consts(schedule, ts)
    track = _tau_track_or_none(spec, schedule, ts)
    taus = np.full(len(ts) - 1, float(tau)) if track is None else track
    lam64 = schedule.lam(ts)
    la64 = np.log(schedule.alpha(ts))
    dlam = lam64[1:] - lam64[:-1]
    slope = (la64[1:] - la64[:-1]) / dlam
    c["drift_x"] = _f32(slope * dlam)
    c["drift_gain"] = _f32((1.0 + taus * taus) * dlam)
    c["noise_amp"] = _f32(taus * schedule.sigma(ts)[:-1] * np.sqrt(2.0 * dlam))
    return c, {"ts": ts}


def execute_euler_maruyama(statics, dev, model_fn, x_T, noise, traj=None):
    cdt = carry_dtype(statics[0])
    at = _reader(dev, x_T)
    x = x_T.to(cdt)
    for i in range(dev["drift_x"].shape[0]):
        x0 = model_fn(x, dev["ts"][i]).to(F32)
        xf = x.to(F32)
        x = (xf + at("drift_x", i) * xf
             - at("drift_gain", i) * (xf - at("alphas", i) * x0)
             + at("noise_amp", i) * noise[i]).to(cdt)
        _record(traj, i, x, x0.to(cdt))
    return x


# ---------------------------------------------------------------- EDM family
def _edm_consts(spec: SamplerSpec) -> tuple:
    """EDM change of variables: x~ = x / alpha, time = sigma_EDM. The
    ``heun`` host flags say which steps take the Heun correction."""
    schedule = spec.resolve_schedule()
    ts = spec.grid_ts()
    sig = np.exp(-schedule.lam(ts))
    c = dict(ts=_f32(ts), sig=_f32(sig), alph=_f32(schedule.alpha(ts)))
    c["heun"] = tuple(bool(h) for h in
                      np.float32(sig[1:]) > np.float32(1e-8))
    return c, ts, sig


def plan_edm_heun(spec: SamplerSpec):
    """EDM deterministic Heun (2nd order) in the scaled space:
    d x~/d sig = (x~ - x0_hat) / sig, x~ = x / alpha_t."""
    _reject_program(spec)
    c, ts, _ = _edm_consts(spec)
    return c, {"ts": ts}


def _to_scaled(at, x_T, cdt):
    return (x_T.to(F32) / at("alph", 0)).to(cdt)


def execute_edm_heun(statics, dev, model_fn, x_T, noise, traj=None):
    del noise  # deterministic
    cdt = carry_dtype(statics[0])
    at = _reader(dev, x_T)
    ts = dev["ts"]

    def d(x_t, i):
        x0 = model_fn((x_t * at("alph", i)).to(cdt), ts[i]).to(F32)
        return (x_t - x0) / at("sig", i)

    x_t = _to_scaled(at, x_T, cdt)
    for i, heun in enumerate(dev["heun"]):
        xf = x_t.to(F32)
        di = d(xf, i)
        dt = at("sig", i + 1) - at("sig", i)
        x_next = xf + dt * di
        if heun:
            x_next = xf + dt * 0.5 * (di + d(x_next, i + 1))
        x_t = x_next.to(cdt)
        # x0: the preview from the first slope evaluation
        _record(traj, i, (x_next * at("alph", i + 1)).to(cdt),
                (xf - at("sig", i) * di).to(cdt))
    return (x_t.to(F32) * at("alph", len(dev["heun"]))).to(cdt)


def plan_edm_stochastic(spec: SamplerSpec):
    """EDM stochastic sampler (Karras Alg. 2) adapted to the scaled space.
    A program's tau track scales the per-step churn (tau_i = 0 makes step
    i the deterministic Heun step)."""
    c, ts, sig = _edm_consts(spec)
    M = len(ts) - 1
    gamma_max = math.sqrt(2.0) - 1.0
    gammas = np.where(
        (sig[:-1] >= spec.s_tmin) & (sig[:-1] <= spec.s_tmax),
        np.minimum(spec.s_churn / M, gamma_max), 0.0)
    track = _tau_track_or_none(spec, spec.resolve_schedule(), ts)
    if track is not None:
        gammas = gammas * np.clip(track, 0.0, None)
    s_hat = sig[:-1] * (1.0 + gammas)
    c["s_hat"] = _f32(s_hat)
    # churn amplitude: s_noise * sqrt(max(s_hat^2 - s_i^2, 0))
    c["churn_amp"] = _f32(
        spec.s_noise * np.sqrt(np.clip(s_hat**2 - sig[:-1] ** 2, 0.0, None)))
    return c, {"ts": ts}


def _precision_statics(spec: SamplerSpec) -> tuple:
    carry_dtype(spec.precision)  # validates the policy value
    return (spec.precision,)


def _edm_stochastic_statics(spec: SamplerSpec) -> tuple:
    """alpha as a function of sigma_EDM: 1 for VE, 1/sqrt(1+sig^2) for VP;
    decided from the schedule's alpha values on the solve grid."""
    schedule = spec.resolve_schedule()
    ve = bool(np.allclose(schedule.alpha(spec.grid_ts()), 1.0))
    return _precision_statics(spec) + (ve,)


def _edm_slope(model_fn, cdt, ve):
    """``d(x~, sig, t) = (x~ - x0_hat) / sig`` of the stochastic sampler,
    the model fed ``x~ alpha(sig)`` at grid time t."""
    def d(x_t, s_val, t_val):
        x_in = x_t if ve else x_t * (1.0 / torch.sqrt(1.0 + s_val**2))
        x0 = model_fn(x_in.to(cdt), t_val).to(F32)
        return (x_t - x0) / s_val
    return d


def execute_edm_stochastic(statics, dev, model_fn, x_T, noise, traj=None):
    precision, ve = statics
    cdt = carry_dtype(precision)
    at = _reader(dev, x_T)
    ts = dev["ts"]
    d = _edm_slope(model_fn, cdt, ve)
    x_t = _to_scaled(at, x_T, cdt)
    for i, heun in enumerate(dev["heun"]):
        s_hat = at("s_hat", i)
        x_hat = x_t.to(F32) + at("churn_amp", i) * noise[i]
        # Heun from s_hat to sig[i+1]; the model conditioned at grid t
        # (the churn offset in t is second-order)
        di = d(x_hat, s_hat, ts[i])
        dt = at("sig", i + 1) - s_hat
        x_next = x_hat + dt * di
        if heun:
            x_next = x_hat + dt * 0.5 * (di + d(x_next, at("sig", i + 1),
                                                ts[i + 1]))
        x_t = x_next.to(cdt)
        _record(traj, i, (x_next * at("alph", i + 1)).to(cdt),
                (x_hat - s_hat * di).to(cdt))
    return (x_t.to(F32) * at("alph", len(dev["heun"]))).to(cdt)


# -------------------------------------------------- step-granular adapters
# The executors' arithmetic as one tick of every lane at its own step ``ic``
# [L]: each table is gathered at ``ic`` and broadcast over the lane's
# latent. DPM-Solver++(2M)'s first step and EDM's final-sigma guard are
# selects whose discarded branch never lands (h_prev[0]'s NaN included).

def _tensors(plan, device) -> dict:
    """The plan's tables on ``device`` (host flags left out: a tick reads
    no host value)."""
    return {k: v for k, v in plan.arrays_on(device).items()
            if isinstance(v, torch.Tensor)}


def _no_err(x) -> torch.Tensor:
    return torch.full((x.shape[0],), math.inf, device=x.device)


def _adapter(spec, step, init_inner, n_steps_of, statics=None,
             evals_per_tick=1) -> StepAdapter:
    return StepAdapter(
        statics=_precision_statics(spec) if statics is None else statics,
        i0=0, evals_per_tick=evals_per_tick, n_steps_of=n_steps_of,
        init_inner=init_inner, step=step, arrays=_tensors)


def _inner_x(cdt):
    def init_inner(dev, x_T):
        return {"x": x_T.to(cdt)}
    return init_inner


def _stepwise_ddim(spec: SamplerSpec) -> StepAdapter:
    cdt = carry_dtype(spec.precision)

    def step(dev, model_fn, inner, ic, init, xi):
        x = inner["x"]
        at = lambda k, j=ic: lane_view(dev[k][j], x)  # noqa: E731
        x0 = model_fn(x, dev["ts"][ic]).to(F32)
        eps = (x.to(F32) - at("alphas") * x0) / at("sigmas")
        x_next = (at("alphas", ic + 1) * x0 + at("dir_scale") * eps
                  + at("sig_hat") * xi).to(cdt)
        return {"x": x_next}, x_next, x0.to(cdt), _no_err(x)

    return _adapter(spec, step, _inner_x(cdt),
                    lambda dev: int(dev["sig_hat"].shape[0]))


def _stepwise_dpmpp2m(spec: SamplerSpec) -> StepAdapter:
    cdt = carry_dtype(spec.precision)

    def init_inner(dev, x_T):
        x = x_T.to(cdt)
        return {"x": x, "x0": torch.zeros_like(x)}

    def step(dev, model_fn, inner, ic, init, xi):
        x, x0_prev = inner["x"], inner["x0"]
        at = lambda k, j=ic: lane_view(dev[k][j], x)  # noqa: E731
        x0 = model_fn(x, dev["ts"][ic]).to(F32)
        phi = 1.0 - torch.exp(-at("h"))
        # h_prev[0] is NaN by construction; the ic == 0 select drops it
        r = at("h_prev") / at("h")
        D = x0 + (x0 - x0_prev.to(F32)) / (2.0 * r)
        upd = at("alphas", ic + 1) * phi * torch.where(
            lane_view(ic == 0, x), x0, D)
        x_next = ((at("sigmas", ic + 1) / at("sigmas")) * x.to(F32)
                  + upd).to(cdt)
        return ({"x": x_next, "x0": x0.to(cdt)}, x_next, x0.to(cdt),
                _no_err(x))

    return _adapter(spec, step, init_inner,
                    lambda dev: int(dev["h"].shape[0]))


def _stepwise_euler_maruyama(spec: SamplerSpec) -> StepAdapter:
    cdt = carry_dtype(spec.precision)

    def step(dev, model_fn, inner, ic, init, xi):
        x = inner["x"]
        at = lambda k: lane_view(dev[k][ic], x)  # noqa: E731
        x0 = model_fn(x, dev["ts"][ic]).to(F32)
        xf = x.to(F32)
        x_next = (xf + at("drift_x") * xf
                  - at("drift_gain") * (xf - at("alphas") * x0)
                  + at("noise_amp") * xi).to(cdt)
        return {"x": x_next}, x_next, x0.to(cdt), _no_err(x)

    return _adapter(spec, step, _inner_x(cdt),
                    lambda dev: int(dev["drift_x"].shape[0]))


def _edm_inner(cdt):
    def init_inner(dev, x_T):
        # the carry lives in the scaled space x~ = x / alpha_t
        return {"x": _to_scaled(_reader(dev, x_T), x_T, cdt)}
    return init_inner


def _edm_out(dev, x_t, ic, heun, euler, cdt):
    """The tick's new state (the Heun state where ``sig[ic + 1] > 1e-8``,
    else the Euler state: the reference's select) and its would-be final
    sample (the state back in data space through alpha at the step's
    end)."""
    x_out = torch.where(lane_view(dev["sig"][ic + 1] > 1e-8, x_t), heun,
                        euler).to(cdt)
    alph = lane_view(dev["alph"][ic + 1], x_t)
    return x_out, (x_out.to(F32) * alph).to(cdt)


def _edm_n_steps(dev) -> int:
    return int(dev["sig"].shape[0]) - 1


def _stepwise_edm_heun(spec: SamplerSpec) -> StepAdapter:
    cdt = carry_dtype(spec.precision)

    def step(dev, model_fn, inner, ic, init, xi):
        x_t = inner["x"].to(F32)
        at = lambda k, j=ic: lane_view(dev[k][j], x_t)  # noqa: E731

        def d(x, j):
            x0 = model_fn((x * at("alph", j)).to(cdt), dev["ts"][j]).to(F32)
            return (x - x0) / at("sig", j)

        di = d(x_t, ic)
        dt = at("sig", ic + 1) - at("sig")
        x_e = x_t + dt * di
        heun = x_t + dt * 0.5 * (di + d(x_e, ic + 1))
        x_out, final = _edm_out(dev, x_t, ic, heun, x_e, cdt)
        x0 = (x_t - at("sig") * di).to(cdt)
        return {"x": x_out}, final, x0, _no_err(x_t)

    return _adapter(spec, step, _edm_inner(cdt), _edm_n_steps,
                    evals_per_tick=2)


def _stepwise_edm_stochastic(spec: SamplerSpec) -> StepAdapter:
    statics = _edm_stochastic_statics(spec)
    precision, ve = statics
    cdt = carry_dtype(precision)

    def step(dev, model_fn, inner, ic, init, xi):
        x_t = inner["x"].to(F32)
        at = lambda k, j=ic: lane_view(dev[k][j], x_t)  # noqa: E731
        d = _edm_slope(model_fn, cdt, ve)
        s_hat = at("s_hat")
        x_hat = x_t + at("churn_amp") * xi
        di = d(x_hat, s_hat, dev["ts"][ic])
        dt = at("sig", ic + 1) - s_hat
        x_e = x_hat + dt * di
        heun = x_hat + dt * 0.5 * (di + d(x_e, at("sig", ic + 1),
                                          dev["ts"][ic + 1]))
        x_out, final = _edm_out(dev, x_t, ic, heun, x_e, cdt)
        x0 = (x_hat - s_hat * di).to(cdt)
        return {"x": x_out}, final, x0, _no_err(x_t)

    return _adapter(spec, step, _edm_inner(cdt), _edm_n_steps,
                    statics=statics, evals_per_tick=2)


# ------------------------------------------------------------- registration
def _register_simple(name, plan, execute, stepwise,
                     steps_from_nfe=_steps_identity, nfe_per_step=1,
                     statics=_precision_statics):
    register_sampler(SamplerFamily(
        name=name, plan=plan, execute=execute, statics=statics,
        nfe_of=lambda spec, _k=nfe_per_step: _k * spec.n_steps,
        steps_from_nfe=steps_from_nfe, stepwise=stepwise))


_register_simple("ddim", plan_ddim, execute_ddim, _stepwise_ddim)
_register_simple("ddpm_ancestral", _plan_ancestral, execute_ddim,
                 _stepwise_ddim)
_register_simple("dpm_solver_pp_2m", plan_dpmpp2m, execute_dpmpp2m,
                 _stepwise_dpmpp2m)
_register_simple("euler_maruyama", plan_euler_maruyama,
                 execute_euler_maruyama, _stepwise_euler_maruyama)
_register_simple("edm_heun", plan_edm_heun, execute_edm_heun,
                 _stepwise_edm_heun, steps_from_nfe=_steps_heun,
                 nfe_per_step=2)
_register_simple("edm_stochastic", plan_edm_stochastic,
                 execute_edm_stochastic, _stepwise_edm_stochastic,
                 steps_from_nfe=_steps_heun, nfe_per_step=2,
                 statics=_edm_stochastic_statics)


# ------------------------------------------- legacy free-function surface
# The paper-comparison functions of the reference's ``core.baselines``
# (re-exported by ``repro_torch.core.baselines``). Each plans its family
# over the explicit grid and runs it through ``sample`` and the compile
# cache, so it is bit for bit the family's solve. ``generator`` draws the
# noise where the reference takes a key; ``noise=`` gives it instead.

def _run_legacy(name: str, model_fn, x_T, generator, schedule, ts, noise,
                **spec_kw):
    ts = np.asarray(ts, dtype=np.float64)
    spec = SamplerSpec(
        name=name, schedule=schedule, n_steps=len(ts) - 1,
        ts=tuple(float(t) for t in ts), **spec_kw)
    return sample(build_plan(spec), model_fn, x_T, generator, noise=noise)


def ddim(model_fn, x_T, generator, schedule, ts, eta: float = 0.0, *,
         noise=None):
    """DDIM-eta (Eq. 19), generalized (alpha, sigma) form."""
    return _run_legacy("ddim", model_fn, x_T, generator, schedule, ts, noise,
                       eta=eta)


def dpm_solver_pp_2m(model_fn, x_T, generator, schedule, ts, *, noise=None):
    """DPM-Solver++(2M), data prediction, deterministic (the official
    multistep second-order update; the first step is DDIM)."""
    return _run_legacy("dpm_solver_pp_2m", model_fn, x_T, generator,
                       schedule, ts, noise)


def euler_maruyama(model_fn, x_T, generator, schedule, ts, tau: float = 1.0,
                   *, noise=None):
    """Euler-Maruyama on the variance-controlled SDE (Eq. 9) in
    lambda-time."""
    return _run_legacy("euler_maruyama", model_fn, x_T, generator, schedule,
                       ts, noise, tau=tau)


def ddpm_ancestral(model_fn, x_T, generator, schedule, ts, *, noise=None):
    """Ancestral (posterior) sampling == DDIM with eta = 1."""
    return _run_legacy("ddpm_ancestral", model_fn, x_T, generator, schedule,
                       ts, noise)


def edm_heun(model_fn, x_T, generator, schedule, ts, *, noise=None):
    """EDM deterministic Heun (2nd order) in the scaled space."""
    return _run_legacy("edm_heun", model_fn, x_T, generator, schedule, ts,
                       noise)


def edm_stochastic(model_fn, x_T, generator, schedule, ts,
                   s_churn: float = 40.0, s_tmin: float = 0.05,
                   s_tmax: float = 50.0, s_noise: float = 1.003, *,
                   noise=None):
    """EDM stochastic sampler (Karras Alg. 2) adapted to the scaled space."""
    return _run_legacy("edm_stochastic", model_fn, x_T, generator, schedule,
                       ts, noise, s_churn=s_churn, s_tmin=s_tmin,
                       s_tmax=s_tmax, s_noise=s_noise)
