"""The SEEDS and DPM-Solver++ multistep families of the PyTorch port
against the JAX reference, and the relations between the three families
on the port's multistep core.

- Tables: each family's host f64 tables against the reference's at 1e-12
  relative, and against SA's (SEEDS is SA in the noise parameterization,
  DPM-Solver++ is SA in the data parameterization at tau 0; Newton vs
  Lagrange reductions of the same integrals) at the reference's own
  1e-12.
- Closed forms: SEEDS stage 1 and the exact exponential-Adams
  DPM-Solver++ order 2.
- Whole solves on the GMM oracle, with the reference's noise draws
  injected: f32 within 1e-5 relative, bf16 within 1e-2, for each combine
  (the port's kernel combines run their plain versions on the CPU).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GMM as JGMM
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.core.coefficients import build_tables as j_build_tables
from repro.core.samplers.dpmpp import DPMppTableBuilder as JDPMpp
from repro.core.samplers.seeds import SEEDSTableBuilder as JSEEDS
from repro_torch.core import GMM as TGMM
from repro_torch.core import get_schedule as t_get_schedule
from repro_torch.core.coefficients import build_tables
from repro_torch.core.samplers import (Sampler, SamplerSpec, get_family,
                                       list_samplers)
from repro_torch.core.samplers.dpmpp import DPMppTableBuilder
from repro_torch.core.samplers.seeds import SEEDSTableBuilder

SCHED = t_get_schedule("vp_linear")
GMM2 = TGMM.default_2d()
TABLE_FIELDS = ("decay", "noise", "pred", "corr_new", "corr")
BUILDERS = {"seeds": (SEEDSTableBuilder, JSEEDS),
            "dpmpp_multistep": (DPMppTableBuilder, JDPMpp)}
SHAPE = (96, 2)


def _ts(n_steps, schedule=SCHED):
    return SamplerSpec(name="sa", schedule=schedule,
                       n_steps=n_steps).grid_ts()


def _tables(builder=None, *, n_steps=8, tau=0.0, order=3, corr=None,
            parameterization="data", schedule=SCHED):
    return build_tables(schedule, _ts(n_steps, schedule), tau=tau,
                        predictor_order=order,
                        corrector_order=order if corr is None else corr,
                        parameterization=parameterization, builder=builder)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ------------------------------------------------- tables vs the reference
@pytest.mark.parametrize("schedule", ["vp_linear", "vp_cosine"])
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("tau", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("family", sorted(BUILDERS))
def test_family_tables_match_reference(family, tau, order, schedule):
    tb, jb = BUILDERS[family]
    ts = _ts(10, t_get_schedule(schedule))
    kw = dict(tau=tau, predictor_order=order, corrector_order=order)
    got = build_tables(t_get_schedule(schedule), ts, builder=tb(), **kw)
    ref = j_build_tables(j_get_schedule(schedule), ts, builder=jb(), **kw)
    for f in TABLE_FIELDS + ("taus",):
        assert _rel(getattr(got, f), getattr(ref, f)) <= 1e-12, f
    assert got.parameterization == ref.parameterization


# ------------------------------------------ table-level family relations
@pytest.mark.parametrize("order", [1, 2, 3])
def test_dpmpp_tables_equal_sa_data_tau0(order):
    sa = _tables(None, tau=0.0, order=order, parameterization="data")
    dp = _tables(DPMppTableBuilder(), tau=1.0, order=order)  # tau inert
    for f in TABLE_FIELDS:
        np.testing.assert_allclose(getattr(dp, f), getattr(sa, f),
                                   rtol=1e-12, atol=1e-14, err_msg=f)
    assert np.all(dp.noise == 0.0) and np.all(dp.taus == 0.0)


@pytest.mark.parametrize("tau", [0.0, 0.7, 1.0])
def test_seeds_tables_equal_sa_noise(tau):
    sa = _tables(None, tau=tau, parameterization="noise")
    se = _tables(SEEDSTableBuilder(), tau=tau)
    for f in TABLE_FIELDS:
        np.testing.assert_allclose(getattr(se, f), getattr(sa, f),
                                   rtol=1e-12, atol=1e-14, err_msg=f)


# ---------------------------------------------------------- closed forms
@pytest.mark.parametrize("tau", [0.0, 0.5, 1.0])
def test_seeds_stage1_closed_form(tau):
    """decay = alpha'/alpha, b_0 = -sigma' (1+tau^2)(e^h - 1), noise =
    sigma' tau sqrt(e^{2h} - 1); tau=0 is DPM-Solver-1."""
    t = _tables(SEEDSTableBuilder(), tau=tau, order=1, corr=0)
    for i in range(len(t.decay)):
        h = t.lams[i + 1] - t.lams[i]
        a1, s1 = t.alphas[i + 1], t.sigmas[i + 1]
        assert t.decay[i] == pytest.approx(a1 / t.alphas[i], rel=1e-13)
        assert t.pred[i, 0] == pytest.approx(
            -s1 * (1.0 + tau * tau) * math.expm1(h), rel=1e-12)
        assert t.noise[i] == pytest.approx(
            s1 * tau * math.sqrt(math.expm1(2.0 * h)), rel=1e-12, abs=0.0)


def test_dpmpp_order2_closed_form():
    """b_1 = -alpha'(h - 1 + e^{-h})/h_prev and b_0 + b_1 =
    alpha'(1 - e^{-h})."""
    t = _tables(DPMppTableBuilder(), order=2, corr=0)
    for i in range(1, len(t.decay)):
        h = t.lams[i + 1] - t.lams[i]
        h_prev = t.lams[i] - t.lams[i - 1]
        a1 = t.alphas[i + 1]
        assert t.decay[i] == pytest.approx(
            t.sigmas[i + 1] / t.sigmas[i], rel=1e-13)
        assert t.pred[i, 1] == pytest.approx(
            -a1 * (h - 1.0 + math.exp(-h)) / h_prev, rel=1e-10)
        assert t.pred[i, 0] + t.pred[i, 1] == pytest.approx(
            a1 * -math.expm1(-h), rel=1e-12)


def _f64_predictor_solve(tables, model):
    """Predictor-only recursion in float64 numpy from the host tables."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 2)) * float(
        SCHED.prior_scale(float(tables.ts[0])))
    hist = []
    width = tables.pred.shape[1]
    for i in range(len(tables.ts) - 1):
        hist.insert(0, model(x, float(tables.ts[i])))
        del hist[width:]
        x = tables.decay[i] * x + sum(
            tables.pred[i, j] * hist[j] for j in range(len(hist)))
    return x


def test_sa_tau0_solve_matches_dpmpp_2m_f64():
    def model(x, t):
        return 0.3 * x * math.cos(t)

    sa = _tables(None, tau=0.0, order=2, corr=0, n_steps=10)
    dp = _tables(DPMppTableBuilder(), order=2, corr=0, n_steps=10)
    np.testing.assert_allclose(_f64_predictor_solve(sa, model),
                               _f64_predictor_solve(dp, model),
                               rtol=1e-13, atol=1e-14)


def test_seeds_stage1_deterministic_limit_on_gmm_oracle():
    """SEEDS stage 1 at tau=0 is DPM-Solver-1, update by update on the
    port's GMM-oracle eps evaluations, float64."""
    eps_fn = GMM2.model_fn(SCHED, "noise")
    t = _tables(SEEDSTableBuilder(), tau=0.0, order=1, corr=0, n_steps=8)
    x = np.random.default_rng(1).standard_normal((32, 2)) * float(
        SCHED.prior_scale(float(t.ts[0])))
    for i in range(len(t.ts) - 1):
        eps = eps_fn(torch.from_numpy(x).float(),
                     torch.tensor(float(t.ts[i]))).double().numpy()
        h = t.lams[i + 1] - t.lams[i]
        ref = (t.alphas[i + 1] / t.alphas[i]) * x \
            - t.sigmas[i + 1] * math.expm1(h) * eps
        x = t.decay[i] * x + t.pred[i, 0] * eps
        np.testing.assert_allclose(x, ref, rtol=1e-12, atol=1e-13)


# -------------------------------------------- solve-level family relations
def _noise(n):
    return [torch.from_numpy(np.random.default_rng(50 + i).standard_normal(
        SHAPE).astype(np.float32)) for i in range(n)]


@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
def test_seeds_solve_bitwise_equals_sa_noise(combine):
    """seeds and SA in the noise parameterization are byte-equal f32
    solves: one executor, tables agreeing to f64 round-off round to the
    same f32 values."""
    model = GMM2.model_fn(SCHED, "noise")
    se = Sampler(SamplerSpec.from_nfe("seeds", 12, schedule=SCHED, tau=1.0,
                                      combine=combine))
    sa = Sampler(SamplerSpec.from_nfe("sa", 12, schedule=SCHED, tau=1.0,
                                      parameterization="noise",
                                      combine=combine))
    xT = sa.init_noise(torch.Generator().manual_seed(0), SHAPE)
    xis = _noise(se.spec.n_steps)
    for k in ("decay", "noise", "pred", "corr_new", "corr"):
        assert torch.equal(se.plan.arrays[k], sa.plan.arrays[k]), k
    assert torch.equal(se.sample(model, xT, noise=lambda i: xis[i]),
                       sa.sample(model, xT, noise=lambda i: xis[i]))


@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
def test_dpmpp_solve_matches_sa_tau0_and_is_tau_inert(combine):
    model = GMM2.model_fn(SCHED, "data")
    xT = torch.from_numpy(np.random.default_rng(2).standard_normal(
        SHAPE).astype(np.float32))

    def solve(name, tau):
        s = Sampler(SamplerSpec.from_nfe(name, 12, schedule=SCHED, tau=tau,
                                         combine=combine))
        return s.sample(model, xT, torch.Generator().manual_seed(3))

    dp = solve("dpmpp_multistep", 1.0)
    np.testing.assert_allclose(dp.numpy(), solve("sa", 0.0).numpy(),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(dp, solve("dpmpp_multistep", 0.3))


# --------------------------------------------- whole solves vs reference
def solve_both(name, precision, combine, *, nfe=10, seed=0, **kw):
    """(reference output, port output) of one family's solve on the same
    x_T and the reference's noise. The reference runs its fused combine
    against the port's fused one and its einsum combine otherwise (its
    Pallas kernel combine runs in interpret mode on the CPU)."""
    jkw = dict(kw, combine="fused" if combine == "fused" else "einsum")
    js = jsamplers.make_sampler(name, nfe=nfe, precision=precision, **jkw)
    ts = Sampler(SamplerSpec.from_nfe(name, nfe, precision=precision,
                                      combine=combine, **kw))
    assert js.spec.n_steps == ts.spec.n_steps and js.nfe == ts.nfe
    conv = get_family(name).model_convention(ts.spec)
    x_T = np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)
    key = jax.random.PRNGKey(seed + 1)
    keys = jax.random.split(key, ts.spec.n_steps)
    xis = [torch.from_numpy(np.array(jax.random.normal(k, SHAPE,
                                                       jnp.float32)))
           for k in keys]
    ref = np.asarray(js.sample(
        JGMM.default_2d().model_fn(j_get_schedule("vp_linear"), conv),
        jnp.asarray(x_T), key), np.float32)
    got = ts.sample(GMM2.model_fn(SCHED, conv), torch.from_numpy(x_T),
                    noise=lambda i: xis[i])
    return ref, got


def _rel_norm(got, ref):
    return float(np.linalg.norm(got.float().numpy() - ref)
                 / np.linalg.norm(ref))


@pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 1e-2)])
@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
@pytest.mark.parametrize("name,kw", [
    ("seeds", dict(tau=1.0, corrector_order=0)),
    ("seeds", dict(tau=0.4, mode="PECE")),
    ("dpmpp_multistep", dict(tau=1.0, corrector_order=0)),
    ("dpmpp_multistep", dict(corrector_order=2)),
], ids=["seeds-P3", "seeds-P3C3-PECE", "dpmpp-P3", "dpmpp-P3C2"])
def test_family_solve_matches_reference(name, kw, combine, precision, tol):
    ref, got = solve_both(name, precision, combine, **kw)
    assert got.dtype == (torch.float32 if precision == "f32"
                         else torch.bfloat16)
    assert bool(torch.isfinite(got).all())
    assert _rel_norm(got, ref) <= tol


@pytest.mark.parametrize("name", ["seeds", "dpmpp_multistep"])
def test_family_program_solve_matches_reference(name):
    """A mixed-mode step program on each new family (the families inherit
    programs from the multistep core)."""
    from repro.core.programs import StepProgram as JStepProgram
    from repro_torch.core.programs import StepProgram
    modes = ("PECE", "PEC", "PEC", "P", "P", "P")
    prog = StepProgram(mode=modes, corrector_order=(1, 2, 2, 0, 0, 0),
                       tau=0.5)
    js = jsamplers.make_sampler(name, n_steps=6, program=JStepProgram
                                .from_json(prog.to_json()))
    ts = Sampler(SamplerSpec(name=name, n_steps=6, program=prog,
                             combine="fused"))
    conv = get_family(name).model_convention(ts.spec)
    x_T = np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(5)
    xis = [torch.from_numpy(np.array(jax.random.normal(k, SHAPE,
                                                       jnp.float32)))
           for k in jax.random.split(key, 6)]
    ref = np.asarray(js.sample(
        JGMM.default_2d().model_fn(j_get_schedule("vp_linear"), conv),
        jnp.asarray(x_T), key), np.float32)
    got = ts.sample(GMM2.model_fn(SCHED, conv), torch.from_numpy(x_T),
                    noise=lambda i: xis[i])
    assert ts.nfe == js.nfe == 8
    assert _rel_norm(got, ref) <= 1e-5


# --------------------------------------------------- capability registry
def test_family_capability_flags():
    assert list_samplers() == jsamplers.list_samplers() == [
        "ddim", "ddpm_ancestral", "dpm_solver_pp_2m", "dpmpp_multistep",
        "edm_heun", "edm_stochastic", "euler_maruyama", "sa", "seeds"]
    for name in ("dpmpp_multistep", "sa", "seeds"):
        assert get_family(name).full_programs, name
    for name in list_samplers():
        assert get_family(name).full_programs == \
            jsamplers.get_family(name).full_programs
        assert get_family(name).tau_inert == \
            jsamplers.get_family(name).tau_inert, name
    assert get_family("dpmpp_multistep").tau_inert
    assert not get_family("sa").tau_inert
    assert not get_family("seeds").tau_inert


@pytest.mark.parametrize("name,conv", [("seeds", "noise"),
                                       ("dpmpp_multistep", "data")])
def test_family_pins_its_convention(name, conv):
    """The family's builder fixes the convention whatever
    ``spec.parameterization`` says; denoise_final applies to the data
    convention only."""
    for param in ("data", "noise"):
        spec = SamplerSpec(name=name, n_steps=4, parameterization=param)
        assert get_family(name).model_convention(spec) == conv
        assert Sampler(spec).plan.statics[0] == conv
        assert Sampler(spec).plan.statics[3] == (conv == "data")


def _chip_smoke_constants():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["dpmpp_multistep", "seeds"])
def test_gmm_gate_follows_the_reference(name):
    """``chip_smoke.py``'s GMM phase gates a family at its sliced-W2 limit
    only where the reference's own CPU solve of the same spec (65,536
    points, NFE 20, predictor order 3, no corrector, tau 1) meets it; the
    port's CPU solve of that spec lands on the same side."""
    from repro.core.metrics import sliced_w2 as j_sliced_w2
    from repro_torch.core.metrics import sliced_w2
    cs = _chip_smoke_constants()
    n, kw = 65536, dict(tau=1.0, predictor_order=3, corrector_order=0,
                        combine="fused")
    js = jsamplers.make_sampler(name, nfe=cs.NFE, **kw)
    conv = get_family(name).model_convention(js.spec)
    jsched = j_get_schedule("vp_linear")
    jgmm = JGMM.default_2d()
    target = jgmm.sample(jax.random.PRNGKey(6), n)
    xT = js.init_noise(jax.random.PRNGKey(5), (n, 2))
    ref_out = js.sample(jgmm.model_fn(jsched, conv), xT, jax.random.PRNGKey(8))
    ref_sw2 = j_sliced_w2(ref_out, target, jax.random.PRNGKey(7))
    assert (ref_sw2 <= cs.SW2_LIMIT) == cs.GMM_FAMILIES[name], ref_sw2

    ts = Sampler(SamplerSpec.from_nfe(name, cs.NFE, **kw))
    g = torch.Generator().manual_seed(5)
    out = ts.sample(GMM2.model_fn(SCHED, conv), ts.init_noise(g, (n, 2)), g)
    got_sw2 = sliced_w2(out, GMM2.sample(torch.Generator().manual_seed(6), n),
                        torch.Generator().manual_seed(7))
    assert (got_sw2 <= cs.SW2_LIMIT) == cs.GMM_FAMILIES[name], got_sw2
