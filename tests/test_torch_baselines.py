"""The paper's six baseline samplers and the legacy ``SASolver`` /
``baselines`` surface of the PyTorch port against the JAX reference.

Mirrors the reference's baseline tests: ``tests/test_samplers.py`` (the
registry, the GMM round trip of all nine families, NFE accounting with a
counting model, legacy ``SASolver`` bitwise ``make_sampler("sa")``),
``tests/test_families.py`` (capability flags, the feature-cache gate, the
pure re-export), ``tests/test_step_programs.py`` (tau tracks, the
rejection of programs by the deterministic families),
``tests/test_hotpath.py`` (bf16 tracks f32) and
``tests/test_equivalences.py`` (DDIM-0 is the one-step predictor at tau
0). Beyond those, each family's planned tables, whole solve and trajectory
are held against the reference's on the same inputs: the reference's
``x_T`` and its per-step draws (``split(key, M)``, one f32 normal each)
injected into the port.

Tolerances: tables within 1e-12 relative (the f32 tensors come out equal);
f32 solves and trajectories within 1e-5 relative in norm; bf16 within
1e-2 (the reference's bf16 bar). The port's own contracts (legacy surface
against the registry, constant programs against the scalar knob, f32
policy casts) are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GMM as JGMM
from repro.core import StepProgram as JStepProgram
from repro.core import get_schedule as j_get_schedule
from repro.core import perturb_model as j_perturb_model
from repro.core import samplers as jsamplers
from repro.core import timestep_grid as j_timestep_grid
from repro.core.baselines import ddim as j_ddim
from repro_torch.core import GMM, SASolver, SASolverConfig, StepProgram
from repro_torch.core import get_schedule, perturb_model, timestep_grid
from repro_torch.core import samplers
from repro_torch.core.coefficients import build_tables
from repro_torch.core.metrics import sliced_w2
from repro_torch.core.programs import program_preset, program_tau_track
from repro_torch.core.samplers import (Sampler, SamplerSpec, build_plan,
                                       get_family, list_samplers,
                                       make_sampler)

SCHED = get_schedule("vp_linear")
GMM2 = GMM.default_2d()
MODEL = GMM2.model_fn(SCHED, "data")
SHAPE = (96, 2)
BASELINES = ("ddim", "ddpm_ancestral", "dpm_solver_pp_2m", "euler_maruyama",
             "edm_heun", "edm_stochastic")
ALL = ["ddim", "ddpm_ancestral", "dpm_solver_pp_2m", "dpmpp_multistep",
       "edm_heun", "edm_stochastic", "euler_maruyama", "sa", "seeds"]
#: each family's knobs in the parity tests (every plan array they bake)
KNOBS = {"ddim": dict(eta=0.4), "ddpm_ancestral": {},
         "dpm_solver_pp_2m": {}, "euler_maruyama": dict(tau=0.6),
         "edm_heun": {}, "edm_stochastic": dict(s_churn=10.0)}


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def x_T(seed=9, shape=SHAPE) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def ref_noise(key, M, shape=SHAPE) -> torch.Tensor:
    """The reference's per-step draws: ``split(key, M)``, one f32 normal
    each, as the port's [M, *shape] noise buffer."""
    draw = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))
    return torch.from_numpy(np.array(draw(jax.random.split(key, M))))


def both(name, **kw):
    """(reference sampler, port sampler) of one spec."""
    kw.setdefault("schedule", "vp_linear")
    js = jsamplers.make_sampler(name, **kw)
    ts = make_sampler(name, **kw)
    assert js.spec.n_steps == ts.spec.n_steps and js.nfe == ts.nfe
    return js, ts


def solve_both(name, precision="f32", seed=0, trajectory=False, **kw):
    """(reference, port) outputs of one spec on the GMM oracle, the
    reference's x_T and noise injected."""
    js, ts = both(name, precision=precision, **kw)
    sched = kw.get("schedule", "vp_linear")
    jm = JGMM.default_2d().model_fn(j_get_schedule(sched), "data")
    tm = GMM.default_2d().model_fn(get_schedule(sched), "data")
    x = x_T(seed)
    key = jax.random.PRNGKey(seed + 1)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if precision == "bf16"
                else (jnp.float32, torch.float32))
    ref = js.sample(jm, jnp.asarray(x).astype(jdt), key,
                    trajectory=trajectory)
    got = ts.sample(tm, torch.from_numpy(x).to(tdt),
                    noise=ref_noise(key, ts.spec.n_steps),
                    trajectory=trajectory)
    return ref, got


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# ------------------------------------------------------------- registry
def test_registry_lists_the_reference_families():
    assert list_samplers() == jsamplers.list_samplers() == ALL


@pytest.mark.parametrize("name", ALL)
def test_family_capability_flags(name):
    """supports_feature_cache, full_programs and tau_inert as the
    reference registers them: the multistep core has all three of its
    own, the baselines none."""
    fam, jfam = get_family(name), jsamplers.get_family(name)
    for flag in ("supports_feature_cache", "full_programs", "tau_inert"):
        assert getattr(fam, flag) == getattr(jfam, flag), flag
    assert fam.supports_feature_cache == (name not in BASELINES)
    assert fam.stepwise is not None and jfam.stepwise is not None


def test_legacy_baselines_module_is_pure_reexport():
    import repro_torch.core.baselines as legacy
    import repro_torch.core.samplers.baselines as canonical
    import repro.core.baselines as j_legacy
    assert legacy.__all__ == j_legacy.__all__
    assert set(legacy.__all__) <= set(canonical.__all__)
    for name in legacy.__all__:
        assert getattr(legacy, name) is getattr(canonical, name), name


# --------------------------------------------------- tables and solves
@pytest.mark.parametrize("schedule", ["vp_linear", "vp_cosine", "ve"])
@pytest.mark.parametrize("name", BASELINES)
def test_tables_match_reference(name, schedule):
    """The planned f32 tensors equal the reference's (the same f64 host
    constants, rounded once); DPM-Solver++(2M)'s NaN ``h_prev[0]``
    included."""
    js, ts = both(name, schedule=schedule, n_steps=9, **KNOBS[name])
    ref = js.plan.arrays
    got = {k: v for k, v in ts.plan.arrays.items()
           if isinstance(v, torch.Tensor)}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v),
                                   rtol=1e-12, atol=0, err_msg=k)
    assert ts.plan.statics == js.plan.statics
    np.testing.assert_array_equal(ts.plan.ts, js.plan.ts)


@pytest.mark.parametrize("name", ["ddim", "ddpm_ancestral",
                                  "euler_maruyama", "edm_stochastic"])
def test_program_tau_track_tables_match_reference(name):
    """A program's tau track lands in the same planned tensors as in the
    reference (per-step eta, SDE tau or churn scale)."""
    track = (1.0, 0.8, 0.6, 0.3, 0.0, 0.5, 1.0)
    js = jsamplers.make_sampler(name, schedule="vp_linear", n_steps=7,
                                program=JStepProgram(tau=track))
    ts = make_sampler(name, schedule="vp_linear", n_steps=7,
                      program=StepProgram(tau=track))
    for k, v in js.plan.arrays.items():
        np.testing.assert_allclose(ts.plan.arrays[k].numpy(), np.asarray(v),
                                   rtol=1e-12, atol=0, err_msg=k)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", BASELINES)
def test_whole_solve_and_trajectory_match_reference(name, precision):
    """Each family's solve and its per-step ``{x, x0}`` trajectory on the
    GMM oracle, the reference's x_T and draws injected."""
    (ref, rtraj), (got, gtraj) = solve_both(
        name, precision, n_steps=8, trajectory=True, **KNOBS[name])
    tol = 1e-2 if precision == "bf16" else 1e-5
    want = torch.bfloat16 if precision == "bf16" else torch.float32
    assert got.dtype == want and gtraj["x"].dtype == want
    assert tuple(gtraj["x"].shape) == tuple(gtraj["x0"].shape) == \
        (8,) + SHAPE
    assert rel(f32(got), f32(ref)) <= tol
    for k in ("x", "x0"):
        assert rel(f32(gtraj[k]), f32(rtraj[k])) <= tol, k
    # without a trajectory: the same solve, through its own cache entry
    _, plain = solve_both(name, precision, n_steps=8, **KNOBS[name])
    assert torch.equal(plain, got)


@pytest.mark.parametrize("name", BASELINES)
def test_whole_solve_matches_reference_on_the_karras_grid(name):
    solve = solve_both(name, n_steps=10, grid="karras", schedule="ve",
                       **KNOBS[name])
    assert rel(f32(solve[1]), f32(solve[0])) <= 1e-5


def test_edm_final_euler_step_matches_reference_and_skips_an_eval():
    """A grid ending at t = 0 (sigma 0): EDM's final step is the Euler
    step. The plan's host flags say so, the solve matches the reference's
    ``lax.cond``, and it makes one evaluation fewer than its spec counts
    (the reference evaluates the taken branch only)."""
    ts = np.concatenate([timestep_grid(SCHED, 5, kind="logsnr")[:-1], [0.0]])
    calls = []

    def counting(x, t):
        calls.append(1)
        return MODEL(x, t)

    for name in ("edm_heun", "edm_stochastic"):
        kw = dict(schedule="vp_linear", n_steps=5,
                  ts=tuple(float(t) for t in ts))
        js, tsm = both(name, **kw)
        assert tsm.plan.arrays["heun"] == (True,) * 4 + (False,)
        key = jax.random.PRNGKey(3)
        x = x_T()
        ref = js.sample(JGMM.default_2d().model_fn(
            j_get_schedule("vp_linear"), "data"), jnp.asarray(x), key)
        calls.clear()
        got = tsm.sample(counting, torch.from_numpy(x),
                         noise=ref_noise(key, 5))
        assert len(calls) == tsm.nfe - 1 == 9
        assert rel(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("name", BASELINES)
def test_legacy_functions_are_their_families_and_match_reference(name):
    """Each legacy free function is bit for bit its family's solve over
    the explicit grid, and matches the reference's legacy function."""
    import repro.core.baselines as j_legacy
    import repro_torch.core.baselines as legacy
    kw = {"ddim": dict(eta=0.5), "euler_maruyama": dict(tau=0.7),
          "edm_stochastic": dict(s_churn=20.0)}.get(name, {})
    grid = timestep_grid(SCHED, 7, kind="logsnr")
    key = jax.random.PRNGKey(4)
    x = x_T()
    noise = ref_noise(key, 7)
    got = getattr(legacy, name)(MODEL, torch.from_numpy(x), None, SCHED,
                                grid, noise=noise, **kw)
    fam = make_sampler(name, schedule=SCHED, n_steps=7,
                       ts=tuple(float(t) for t in grid), **kw)
    assert torch.equal(got, fam.sample(MODEL, torch.from_numpy(x),
                                       noise=noise))
    jsched = j_get_schedule("vp_linear")
    ref = getattr(j_legacy, name)(
        JGMM.default_2d().model_fn(jsched, "data"), jnp.asarray(x), key,
        jsched, j_timestep_grid(jsched, 7, kind="logsnr"), **kw)
    assert rel(got.numpy(), np.asarray(ref)) <= 1e-5


def test_legacy_function_draws_from_its_generator():
    """Without ``noise=`` a legacy call draws its steps from the
    generator: the same seed gives the same sample, another seed
    another."""
    grid = timestep_grid(SCHED, 6, kind="logsnr")
    x = torch.from_numpy(x_T())
    run = lambda s: samplers.baselines.ddpm_ancestral(  # noqa: E731
        MODEL, x, torch.Generator().manual_seed(s), SCHED, grid)
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))


# ---------------------------------------------------------- round trip
@pytest.mark.parametrize("name", ALL)
def test_round_trip_every_sampler_on_gmm_oracle(name):
    """list_samplers -> make_sampler -> sample: every family reaches the
    GMM target (sliced-W2 below half the prior's) through the same call
    path, as in the reference."""
    kw = {"seeds": dict(corrector_order=0)}.get(name, {})
    s = make_sampler(name, schedule=SCHED, nfe=32, tau=1.0, **kw)
    conv = get_family(name).model_convention(s.spec)
    g = torch.Generator().manual_seed(9)
    xT = torch.randn((256, 2), generator=g)
    x0 = s.sample(GMM2.model_fn(SCHED, conv), xT, g)
    assert x0.shape == xT.shape and bool(torch.isfinite(x0).all())
    target = GMM2.sample(torch.Generator().manual_seed(5), 256)
    w = lambda a: sliced_w2(a, target,  # noqa: E731
                            torch.Generator().manual_seed(6))
    assert w(x0) < 0.5 * w(xT)


# ------------------------------------------------------- NFE accounting
@pytest.mark.parametrize("name,kw,per_step,offset", [
    ("sa", dict(mode="PEC"), 1, 1),
    ("sa", dict(mode="PECE", corrector_order=3), 2, 1),
    ("sa", dict(mode="PECE", corrector_order=0), 1, 1),
    ("ddim", {}, 1, 0),
    ("ddpm_ancestral", {}, 1, 0),
    ("dpm_solver_pp_2m", {}, 1, 0),
    ("euler_maruyama", {}, 1, 0),
    ("edm_heun", {}, 2, 0),
    ("edm_stochastic", {}, 2, 0),
])
def test_nfe_accounting_from_nfe(name, kw, per_step, offset):
    """NFE = per_step * n_steps + offset, from_nfe never overspends, and
    the step counts are the reference's."""
    for nfe in (7, 12, 21):
        spec = SamplerSpec.from_nfe(name, nfe, **kw)
        jspec = jsamplers.SamplerSpec.from_nfe(name, nfe, **kw)
        assert spec.n_steps == jspec.n_steps and spec.nfe == jspec.nfe
        assert spec.nfe == per_step * spec.n_steps + offset
        assert nfe - 2 * per_step < spec.nfe <= nfe


@pytest.mark.parametrize("name,kw,want_nfe", [
    ("sa", dict(mode="PEC", corrector_order=3), 9),
    ("sa", dict(mode="PECE", corrector_order=3), 17),
    ("ddim", {}, 8),
    ("ddpm_ancestral", {}, 8),
    ("dpm_solver_pp_2m", {}, 8),
    ("euler_maruyama", {}, 8),
    ("edm_heun", {}, 16),
    ("edm_stochastic", {}, 16),
])
def test_nfe_accounting_matches_runtime_eval_count(name, kw, want_nfe):
    """The spec's claimed NFE equals the model evaluations one solve
    makes (counted in the model: the port's executor is a Python loop)."""
    calls = []

    def counting(x, t):
        calls.append(1)
        return MODEL(x, t)

    s = make_sampler(name, schedule=SCHED, n_steps=8, tau=0.5, **kw)
    assert s.nfe == want_nfe
    x0 = s.sample(counting, torch.from_numpy(x_T()[:64]),
                  torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(x0).all())
    assert len(calls) == want_nfe


# --------------------------------------------------- the legacy SASolver
@pytest.mark.parametrize("p,c,tau,mode", [
    (3, 3, 1.0, "PEC"),
    (2, 2, 0.6, "PECE"),
    (3, 0, 0.0, "PEC"),
])
def test_sa_bitwise_identical_to_legacy_solver(p, c, tau, mode):
    """``SASolver.sample`` and ``make_sampler("sa")`` give the same bits
    for the same generator, through one compile-cache entry; and the
    legacy solve matches the reference's legacy solve on its draws."""
    cfg = SASolverConfig(n_steps=10, predictor_order=p, corrector_order=c,
                         tau=tau, mode=mode)
    legacy = SASolver(SCHED, cfg)
    x = torch.from_numpy(x_T())
    samplers.clear_compile_cache()
    a = legacy.sample(MODEL, x, torch.Generator().manual_seed(3))
    s = make_sampler("sa", schedule=SCHED, n_steps=10, predictor_order=p,
                     corrector_order=c, tau=tau, mode=mode)
    b = s.sample(MODEL, x, torch.Generator().manual_seed(3))
    assert a.dtype == b.dtype and torch.equal(a, b)
    assert samplers.compile_cache_stats()["misses"] == 1
    assert cfg.nfe == s.nfe

    from repro.core import SASolver as JSASolver
    from repro.core import SASolverConfig as JSASolverConfig
    jcfg = JSASolverConfig(n_steps=10, predictor_order=p, corrector_order=c,
                           tau=tau, mode=mode)
    key = jax.random.PRNGKey(2)
    ref = JSASolver(j_get_schedule("vp_linear"), jcfg).sample(
        JGMM.default_2d().model_fn(j_get_schedule("vp_linear"), "data"),
        jnp.asarray(x.numpy()), key)
    got = legacy.sample(MODEL, x, noise=ref_noise(key, 10))
    assert rel(got.numpy(), np.asarray(ref)) <= 1e-5


@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
def test_legacy_explicit_tables_route_is_bitwise_too(combine):
    """``core.solver.sample`` with prebuilt tables (no recompute) is bit for
    bit the spec-planned solve, under each combine."""
    from repro_torch.core.solver import sample as legacy_sample
    grid = timestep_grid(SCHED, 12, kind="logsnr")
    tb = build_tables(SCHED, grid, tau=0.8, predictor_order=3,
                      corrector_order=2)
    cfg = SASolverConfig(n_steps=12, predictor_order=3, corrector_order=2,
                         tau=0.8, denoise_final=False, combine=combine)
    x = torch.from_numpy(x_T())
    noise = torch.randn((12,) + SHAPE, generator=torch.Generator()
                        .manual_seed(1))
    a = legacy_sample(MODEL, x, None, tb, cfg, noise=noise)
    b = make_sampler("sa", schedule=SCHED, n_steps=12, predictor_order=3,
                     corrector_order=2, tau=0.8, denoise_final=False,
                     combine=combine).sample(MODEL, x, noise=noise)
    assert torch.equal(a, b)


def test_legacy_init_noise_uses_the_prior_scale():
    solver = SASolver(get_schedule("ve"), SASolverConfig(n_steps=4))
    x = solver.init_noise(torch.Generator().manual_seed(0), (4096, 2))
    scale = get_schedule("ve").prior_scale(float(solver.tables.ts[0]))
    assert abs(float(x.std()) / scale - 1.0) < 0.05


# ------------------------------------------------- feature-cache gate
@pytest.mark.parametrize("entry", ["sample", "sample_batched",
                                   "make_stepfns", "fresh_carry"])
def test_feature_cache_gate_names_capability(entry):
    """A family without supports_feature_cache refuses the knob with the
    reference's error, at every entry point (before the Denoiser check
    and before the step scheduler's own refusal)."""
    plan = Sampler(SamplerSpec.from_nfe("ddim", 8, schedule=SCHED,
                                        feature_cache=2)).plan
    x = torch.zeros((2,) + SHAPE)
    calls = {
        "sample": lambda: samplers.sample(plan, MODEL, x[0]),
        "sample_batched": lambda: samplers.sample_batched(
            plan, MODEL, x, noise=torch.zeros((2, 8) + SHAPE)),
        "make_stepfns": lambda: samplers.make_stepfns(
            plan, MODEL, SHAPE, torch.float32, 2, device="cpu"),
        "fresh_carry": lambda: samplers.fresh_carry(
            plan, 2, SHAPE, torch.float32, device="cpu"),
    }
    with pytest.raises(ValueError, match="not supported by the 'ddim'"):
        calls[entry]()


# ------------------------------------------------------- tau tracks
@pytest.mark.parametrize("name,knob", [("ddim", "eta"),
                                       ("euler_maruyama", "tau")])
def test_baseline_constant_program_bitwise_scalar_knob(name, knob):
    """A constant-tau program is bit for bit the scalar knob it
    generalizes: the track lands in the same planned tensors."""
    fixed = make_sampler(name, schedule=SCHED, n_steps=8, **{knob: 0.3})
    prog = make_sampler(name, schedule=SCHED, n_steps=8,
                        program=StepProgram(tau=0.3))
    assert fixed.plan.statics == prog.plan.statics
    x = torch.from_numpy(x_T())
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    assert torch.equal(fixed.sample(MODEL, x, g()),
                       prog.sample(MODEL, x, g()))


def test_ddim_eta_track_interpolates_ancestral_to_ode():
    """An all-zero track IS the ODE (eta 0) sampler bit for bit and an
    all-one track the ancestral one; an annealed track differs from
    both."""
    n = 8
    x = torch.from_numpy(x_T())

    def run(name, **kw):
        return make_sampler(name, schedule=SCHED, n_steps=n, **kw).sample(
            MODEL, x, torch.Generator().manual_seed(0))

    anneal = run("ddim", program=program_preset("tau-anneal", n))
    ode = run("ddim", eta=0.0)
    anc = run("ddpm_ancestral")
    assert torch.equal(run("ddim", program=StepProgram(tau=(0.0,) * n)), ode)
    assert torch.equal(run("ddpm_ancestral",
                           program=StepProgram(tau=(1.0,) * n)), anc)
    assert not torch.equal(anneal, ode) and not torch.equal(anneal, anc)


def test_edm_stochastic_zero_track_is_churnless():
    x = torch.from_numpy(x_T())

    def run(**kw):
        return make_sampler("edm_stochastic", schedule=SCHED, n_steps=6,
                            **kw).sample(MODEL, x,
                                         torch.Generator().manual_seed(0))

    churnless = run(s_churn=0.0)
    assert torch.equal(run(s_churn=10.0, program=StepProgram(
        tau=(0.0,) * 6)), churnless)
    assert not torch.equal(run(s_churn=10.0, program=StepProgram(
        tau=(1.0,) * 6)), churnless)


@pytest.mark.parametrize("name,sweep", [
    ("ddim", [dict(eta=e) for e in (0.0, 0.3, 1.0)]),
    ("ddim", [dict(program=StepProgram(tau=(t,) * 8))
              for t in (0.0, 0.3, 0.7, 1.0)]),
    ("euler_maruyama", [dict(tau=t) for t in (0.2, 0.5, 1.0)]),
    ("edm_stochastic", [dict(s_churn=c) for c in (0.0, 10.0, 40.0)]
     + [dict(program=StepProgram(tau=(0.5,) * 8))]),
])
def test_knob_sweep_reuses_one_executor(name, sweep):
    """eta, tau, churn and tau-track sweeps at one step count are plan
    data: one compile-cache miss, one graph signature, and each solve is
    its own plan's (a fresh cache gives the same bits)."""
    samplers.clear_compile_cache()
    x = torch.from_numpy(x_T())
    noise = torch.randn((8,) + SHAPE, generator=torch.Generator()
                        .manual_seed(2))
    outs = []
    for kw in sweep:
        s = make_sampler(name, schedule=SCHED, n_steps=8, **kw)
        outs.append(s.sample(MODEL, x, noise=noise))
    stats = samplers.compile_cache_stats()
    assert stats["misses"] == 1 and stats["hits"] == len(sweep) - 1
    entry, = samplers.base._COMPILE_CACHE.values()
    assert len(entry.runs) == 1
    samplers.clear_compile_cache()
    last = make_sampler(name, schedule=SCHED, n_steps=8, **sweep[-1])
    assert torch.equal(outs[-1], last.sample(MODEL, x, noise=noise))
    assert not torch.equal(outs[0], outs[-1])


def test_explicit_program_dictates_baseline_step_count():
    for pkg in (samplers, jsamplers):
        prog = StepProgram if pkg is samplers else JStepProgram
        assert pkg.SamplerSpec.from_nfe(
            "ddim", 10, program=prog(tau=(0.5,) * 6)).n_steps == 6
        assert pkg.SamplerSpec.from_nfe(
            "edm_stochastic", 12, program=prog(tau=(0.5,) * 5)).n_steps == 5
        with pytest.raises(ValueError, match="budget"):
            pkg.SamplerSpec.from_nfe("edm_stochastic", 8,
                                     program=prog(tau=(0.5,) * 5))


@pytest.mark.parametrize("name", ["dpm_solver_pp_2m", "edm_heun"])
def test_deterministic_families_reject_programs(name):
    with pytest.raises(ValueError, match="program-capable"):
        build_plan(SamplerSpec(name=name, schedule=SCHED, n_steps=6,
                               program=StepProgram(tau=0.5)))


def test_program_tau_track_validation():
    """The baselines read only the tau track: order tracks and non-PEC
    modes are rejected, not ignored."""
    ts = timestep_grid(SCHED, 6, kind="logsnr")
    with pytest.raises(TypeError):
        program_tau_track("nope", SCHED, ts, "ddim")
    with pytest.raises(ValueError, match="order"):
        program_tau_track(StepProgram(predictor_order=(1, 2, 3, 3, 3, 3)),
                          SCHED, ts, "ddim")
    with pytest.raises(ValueError, match="mode"):
        program_tau_track(StepProgram(mode="PECE"), SCHED, ts, "ddim")
    track = program_tau_track(program_preset("tau-anneal", 6), SCHED, ts,
                              "ddim")
    assert track.shape == (6,) and track[0] == 1.0 and track[-1] == 0.0


def test_euler_maruyama_needs_a_constant_tau():
    from repro_torch.core import ConstantTau
    with pytest.raises(ValueError, match="constant"):
        build_plan(SamplerSpec(name="euler_maruyama", schedule=SCHED,
                               n_steps=4, tau=ConstantTau(0.5)))


# -------------------------------------------------------- precision
@pytest.mark.parametrize("name", BASELINES)
def test_bf16_baselines_track_f32(name):
    """Every baseline honors spec.precision: bf16 carry, f32 math."""
    x = torch.from_numpy(x_T())
    noise = torch.randn((6,) + SHAPE, generator=torch.Generator()
                        .manual_seed(4))
    linear = lambda x, t: 0.8 * x  # noqa: E731
    a = make_sampler(name, schedule=SCHED, n_steps=6).sample(
        linear, x, noise=noise)
    b = make_sampler(name, schedule=SCHED, n_steps=6,
                     precision="bf16").sample(linear, x.bfloat16(),
                                              noise=noise)
    assert b.dtype == torch.bfloat16
    dev = float((a - b.float()).abs().max())
    assert dev < 0.1 * (float(a.std()) + 1.0), dev


@pytest.mark.parametrize("name", ["ddim", "dpm_solver_pp_2m",
                                  "edm_stochastic"])
def test_baseline_precision_f32_stays_bitwise(name):
    x = torch.from_numpy(x_T())
    a = make_sampler(name, schedule=SCHED, n_steps=6).sample(
        MODEL, x, torch.Generator().manual_seed(0))
    b = make_sampler(name, schedule=SCHED, n_steps=6,
                     precision="f32").sample(
        MODEL, x, torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


# ------------------------------------------------------- equivalences
def test_ddim0_equals_1step_predictor_tau0():
    """DDIM(eta=0) == the one-step SA-Predictor at tau 0 (Cor. 5.3), in
    the port as in the reference; and the port's DDIM matches the
    reference's legacy function."""
    from repro_torch.core import sample as sa_sample
    from repro_torch.core.baselines import ddim
    grid = timestep_grid(SCHED, 12, kind="logsnr")
    tb = build_tables(SCHED, grid, tau=0.0, predictor_order=1,
                      corrector_order=0)
    cfg = SASolverConfig(n_steps=12, predictor_order=1, corrector_order=0,
                         tau=0.0, denoise_final=False)
    x = torch.from_numpy(x_T())
    zeros = torch.zeros((12,) + SHAPE)
    ours = sa_sample(MODEL, x, None, tb, cfg, noise=zeros)
    theirs = ddim(MODEL, x, None, SCHED, grid, eta=0.0, noise=zeros)
    assert float((ours - theirs).abs().max()) < 1e-5
    jsched = j_get_schedule("vp_linear")
    ref = j_ddim(JGMM.default_2d().model_fn(jsched, "data"),
                 jnp.asarray(x.numpy()), jax.random.PRNGKey(0), jsched,
                 j_timestep_grid(jsched, 12, kind="logsnr"), eta=0.0)
    assert rel(theirs.numpy(), np.asarray(ref)) <= 1e-5


# ---------------------------------------------------- perturb_model
@pytest.mark.parametrize("dim,delta,seed", [(2, 0.3, 0), (8, 1.0, 5)])
def test_perturb_model_field_matches_reference(dim, delta, seed):
    """The §6.5 inaccurate model adds the reference's random-feature
    field (the same numpy draws) to within 1e-6 relative in norm (the f32
    rounding of ``x @ W`` at |x| up to ~10 alone moves the cosines by
    ~1e-6 element-wise)."""
    rng = np.random.default_rng(11)
    x = (3.0 * rng.standard_normal((64, dim))).astype(np.float32)
    zero = lambda x, t: 0.0 * x  # noqa: E731
    got = perturb_model(zero, dim, delta, seed=seed)(torch.from_numpy(x),
                                                     torch.tensor(0.5))
    ref = j_perturb_model(lambda x, t: 0.0 * x, dim, delta, seed=seed)(
        jnp.asarray(x), 0.5)
    assert rel(got.numpy(), np.asarray(ref)) <= 1e-6


@pytest.mark.parametrize("name,printed", [
    ("ddim", "eta=0.0 "), ("ddpm_ancestral", ""), ("dpm_solver_pp_2m", ""),
    ("euler_maruyama", "tau=0.5 "), ("edm_heun", ""),
    ("edm_stochastic", "s_churn=40.0 s_tmin=0.05 s_tmax=50.0 s_noise=1.003 ")])
def test_launch_sample_prints_a_baselines_own_knobs(capsys, name, printed):
    """The sampling driver's record of a baseline run names the knobs its
    plan reads, and none of the multistep core's (tau/P/C/mode, combine,
    history)."""
    from repro_torch.launch import sample as launch_sample
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", "16", "--nfe", "8", "--device", "cpu",
                        "--sampler", name, "--tau", "0.5"])
    out = capsys.readouterr().out
    steps = 4 if name.startswith("edm") else 8
    assert (f"sampler={name} NFE=8 (network NFE=8) (requested 8) "
            f"steps={steps} {printed}prediction=data guidance=off "
            "precision=f32 ") in out
    assert " P3C3 " not in out and "combine=" not in out
    assert "history=" not in out and "finite=True" in out
