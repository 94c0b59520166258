"""Host plan layer of the PyTorch port against the JAX reference: noise
schedules (host f64 and device functions), tau schedules, timestep grids
and the float64 coefficient tables.

Host tables are float64 numpy on both sides and must agree to 1e-12
relative; at k = 5 near the |a|h = 0.5 series/recursion switch the
reference's own two branches differ by up to ~7e-12, so that comparison
uses 1e-11.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coefficients as jcoef
from repro.core import schedules as jsched
from repro.core import tau as jtau
from repro_torch.core import coefficients as tcoef
from repro_torch.core import schedules as tsched
from repro_torch.core import tau as ttau

SCHEDULES = ["vp_linear", "vp_cosine", "ve"]
GRIDS = ["time", "logsnr", "karras"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-300)
    return float(np.abs(a - b).max() / scale)


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("kind", GRIDS)
@pytest.mark.parametrize("n", [1, 10, 200])
def test_timestep_grid_matches_reference(name, kind, n):
    ref = jsched.timestep_grid(jsched.get_schedule(name), n, kind=kind)
    got = tsched.timestep_grid(tsched.get_schedule(name), n, kind=kind)
    assert got.dtype == np.float64
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_device_functions_match_reference(name):
    """The torch alpha/sigma/lambda functions at float32 timesteps match
    the reference's jnp functions at the same points."""
    js, ts = jsched.get_schedule(name), tsched.get_schedule(name)
    t = np.linspace(ts.t_end, ts.t_start, 37).astype(np.float32)
    for fj, ft in (("alpha_j", "alpha_d"), ("sigma_j", "sigma_d"),
                   ("lam_j", "lam_d")):
        ref = np.asarray(getattr(js, fj)(jnp.asarray(t)))
        got = getattr(ts, ft)(torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6)


def test_cosine_validate_span_and_clip():
    s = tsched.VPCosineSchedule()
    with pytest.raises(ValueError, match="usable span"):
        tsched.timestep_grid(s, 10, t_start=0.999)
    # t_of_lam clips at the schedule's own t_start, not 1.0
    assert float(s.t_of_lam(-50.0)) == pytest.approx(s.t_start)
    ref = jsched.VPCosineSchedule()
    lam = np.linspace(-12, 8, 41)
    np.testing.assert_array_equal(s.t_of_lam(lam), ref.t_of_lam(lam))


@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("make", [
    lambda m: (m.ConstantTau(0.7),),
    lambda m: (m.BandedTau(1.0, 0.05, 1.0),),
    lambda m: (m.DDIMEtaTau(0.6),),
])
def test_tau_schedules_match_reference(name, make):
    ts = jsched.timestep_grid(jsched.get_schedule(name), 25)
    (jt,), (tt,) = make(jtau), make(ttau)
    ref = jt.on_intervals(jsched.get_schedule(name), ts)
    got = tt.on_intervals(tsched.get_schedule(name), ts)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("a,h,k", [(1.0, 0.3, 3), (2.0, 0.1, 5), (1.49, 0.7, 4),
                                   (-1.0, 0.45, 3), (-1.0, 1.3, 5)])
def test_exp_monomial_integrals_match_reference(a, h, k):
    assert _rel(tcoef.exp_monomial_integrals(a, h, k),
                jcoef.exp_monomial_integrals(a, h, k)) <= 1e-12


@pytest.mark.parametrize("a", [2.8828125, 1.0, 4.0])
def test_exp_monomial_integrals_k5_near_branch_switch(a):
    """Either side of |a|h = 0.5 the port follows the same branch as the
    reference; across the switch the two branches agree to ~1e-11."""
    for h in (0.5 / a * (1 - 1e-9), 0.5 / a * (1 + 1e-9)):
        assert _rel(tcoef.exp_monomial_integrals(a, h, 5),
                    jcoef.exp_monomial_integrals(a, h, 5)) <= 1e-12
    lo = tcoef.exp_monomial_integrals(a, 0.5 / a * (1 - 1e-12), 5)
    hi = tcoef.exp_monomial_integrals(a, 0.5 / a * (1 + 1e-12), 5)
    assert _rel(lo, hi) <= 1e-11


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_lagrange_and_newton_rows_match_reference(n):
    nodes = np.array([0.0, -0.31, -0.7, -1.2][:n])
    assert _rel(tcoef.lagrange_coeff_matrix(nodes),
                jcoef.lagrange_coeff_matrix(nodes)) <= 1e-12
    assert _rel(tcoef.newton_exp_row(nodes, 0.31, 1.4),
                jcoef.newton_exp_row(nodes, 0.31, 1.4)) <= 1e-12


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("tau", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("param", ["data", "noise"])
@pytest.mark.parametrize("name", SCHEDULES)
@pytest.mark.parametrize("kind", GRIDS)
def test_build_tables_match_reference(order, tau, param, name, kind):
    ts = jsched.timestep_grid(jsched.get_schedule(name), 12, kind=kind)
    kw = dict(tau=tau, predictor_order=order, corrector_order=order,
              parameterization=param)
    ref = jcoef.build_tables(jsched.get_schedule(name), ts, **kw)
    got = tcoef.build_tables(tsched.get_schedule(name), ts, **kw)
    for field in ("decay", "noise", "pred", "corr_new", "corr", "lams",
                  "taus", "alphas", "sigmas"):
        assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-12, field
    assert (got.predictor_order, got.corrector_order) == \
        (ref.predictor_order, ref.corrector_order)


def test_build_tables_order5_near_branch_switch():
    """Order 5 rows on a grid whose (1+tau^2) h sits near the 0.5 switch."""
    s = "vp_linear"
    for n in (40, 60, 90):
        ts = jsched.timestep_grid(jsched.get_schedule(s), n)
        kw = dict(tau=0.3, predictor_order=5, corrector_order=5)
        ref = jcoef.build_tables(jsched.get_schedule(s), ts, **kw)
        got = tcoef.build_tables(tsched.get_schedule(s), ts, **kw)
        for field in ("pred", "corr_new", "corr"):
            assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-11


def test_build_tables_program_waits_for_its_slice():
    """Step programs build the reference's per-interval tables (orders,
    modes and taus varying per interval, the warm-up clamp, a width
    floor)."""
    from repro.core.programs import StepProgram as JStepProgram
    from repro_torch.core.programs import StepProgram
    ts = tsched.timestep_grid(tsched.get_schedule("vp_linear"), 5)
    prog = StepProgram(predictor_order=(1, 3, 2, 3, 1),
                       corrector_order=(2, 0, 3, 1, 2),
                       mode=("PECE", "PEC", "P", "PEC", "PEC"),
                       tau=(0.2, 1.0, 0.0, 0.5, 0.7), width=4)
    got = tcoef.build_tables(tsched.get_schedule("vp_linear"), ts,
                             program=prog)
    ref = jcoef.build_tables(jsched.get_schedule("vp_linear"), ts,
                             program=JStepProgram.from_json(prog.to_json()))
    for field in ("decay", "noise", "pred", "corr_new", "corr", "taus"):
        assert _rel(getattr(got, field), getattr(ref, field)) <= 1e-12, field
    assert got.pred.shape == ref.pred.shape == (5, 4)
    np.testing.assert_array_equal(got.p_orders, ref.p_orders)
    np.testing.assert_array_equal(got.c_orders, ref.c_orders)


def test_interval_context_and_builder_protocol():
    ts = tsched.timestep_grid(tsched.get_schedule("vp_linear"), 6)
    s = tsched.get_schedule("vp_linear")
    ctx = tcoef.IntervalContext(i=2, lams=s.lam(ts), alphas=s.alpha(ts),
                                sigmas=s.sigma(ts), tau=0.5)
    assert ctx.h == pytest.approx(s.lam(ts[3]) - s.lam(ts[2]))
    b = tcoef.SATableBuilder("data")
    row = b.row(ctx, 3, include_new=True)
    assert row.shape == (4,)
    with pytest.raises(ValueError):
        tcoef.SATableBuilder("v")


@pytest.mark.parametrize("name", ["vp_linear", "ve", "edm"])
def test_prior_scale_matches_reference(name):
    s, r = tsched.get_schedule(name), jsched.get_schedule(name)
    assert s.prior_scale(s.t_start) == r.prior_scale(r.t_start)
