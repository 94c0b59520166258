"""Whole SA solves of the PyTorch port against the JAX reference on the
analytic GMM oracle, with the reference's noise stream injected into the
port (``keys = split(key, M)``, one f32 normal per step), plus the
spec/plan/NFE accounting and the executor's own contracts.

Tolerances: f32 solves agree to 1e-5 in relative norm
(``|port - ref| / |ref|``). An element-wise bound would be the oracle's,
not the port's: late in the solve the GMM posterior is sharp, and the
reference itself moves by ~2e-5 element-wise when x_T moves by one ulp.
bf16 solves hold the reference's own bf16 bar of 1e-2.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GMM as JGMM
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro_torch.core import GMM as TGMM
from repro_torch.core import get_schedule as t_get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.kernels import ops

SHAPE = (128, 2)
LAYOUTS = [("einsum", "ring"), ("kernel", "ring"), ("fused", "ring"),
           ("einsum", "concat"), ("kernel", "concat")]


def reference_noise(key, M, shape=SHAPE):
    """The reference's per-step draws: split(key, M), one f32 normal each."""
    keys = jax.random.split(key, M)
    return [np.array(jax.random.normal(keys[i], shape, jnp.float32))
            for i in range(M)]


def solve_both(seed=0, shape=SHAPE, **kw):
    """(reference output, port output) for the same spec, x_T and noise."""
    kw.setdefault("schedule", "vp_linear")
    js = jsamplers.make_sampler("sa", **kw)
    ts = tsamplers.make_sampler("sa", **kw)
    assert js.spec.n_steps == ts.spec.n_steps and js.nfe == ts.nfe
    x_T = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    key = jax.random.PRNGKey(seed + 1)
    xis = reference_noise(key, js.spec.n_steps, shape)
    jsched = j_get_schedule(kw["schedule"])
    tsched = t_get_schedule(kw["schedule"])
    param = kw.get("parameterization", "data")
    jm = JGMM.default_2d().model_fn(jsched, param)
    tm = TGMM.default_2d().model_fn(tsched, param)
    ref = np.asarray(js.sample(jm, jnp.asarray(x_T), key), np.float32)
    got = ts.sample(tm, torch.from_numpy(x_T),
                    noise=lambda i: torch.from_numpy(xis[i]))
    return ref, got


def rel(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("combine,history", LAYOUTS)
@pytest.mark.parametrize("mode", ["PEC", "PECE"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_f32_solve_matches_reference(combine, history, mode, order):
    ref, got = solve_both(nfe=10, tau=0.7, predictor_order=order,
                          corrector_order=order, mode=mode, combine=combine,
                          history=history)
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize("combine,history", LAYOUTS)
@pytest.mark.parametrize("mode", ["PEC", "PECE"])
def test_bf16_solve_matches_reference(combine, history, mode):
    ref, got = solve_both(nfe=10, tau=0.7, mode=mode, combine=combine,
                          history=history, precision="bf16")
    assert got.dtype == torch.bfloat16
    assert rel(got, ref) <= 1e-2


@pytest.mark.parametrize("tau", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("param", ["data", "noise"])
@pytest.mark.parametrize("schedule", ["vp_linear", "vp_cosine"])
def test_tau_parameterization_schedule_sweep(tau, param, schedule):
    ref, got = solve_both(nfe=12, tau=tau, parameterization=param,
                          schedule=schedule, combine="fused",
                          denoise_final=param == "data")
    assert rel(got, ref) <= 1e-5


def test_predictor_only_solve_matches_reference():
    for combine in ("einsum", "kernel", "fused"):
        ref, got = solve_both(nfe=8, corrector_order=0, combine=combine)
        assert rel(got, ref) <= 1e-5


def test_ring_is_bitwise_concat_in_the_port():
    """The reference's internal contract, held inside the port: the f32
    ring history with the einsum/kernel combines is bitwise the concat
    layout."""
    x_T = torch.randn(SHAPE, generator=torch.Generator().manual_seed(3))
    xis = [torch.randn(SHAPE, generator=torch.Generator().manual_seed(i))
           for i in range(20)]
    model = TGMM.default_2d().model_fn(t_get_schedule("vp_linear"))
    for combine, mode in itertools.product(("einsum", "kernel"),
                                           ("PEC", "PECE")):
        outs = [tsamplers.make_sampler(
            "sa", nfe=9, combine=combine, mode=mode, history=h).sample(
                model, x_T, noise=lambda i: xis[i]) for h in ("ring", "concat")]
        assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("nfe", [1, 2, 5, 9, 20, 21])
@pytest.mark.parametrize("mode", ["PEC", "PECE"])
@pytest.mark.parametrize("corrector", [0, 3])
def test_nfe_accounting_matches_reference(nfe, mode, corrector):
    kw = dict(mode=mode, corrector_order=corrector)
    js = jsamplers.SamplerSpec.from_nfe("sa", nfe, **kw)
    ts = tsamplers.SamplerSpec.from_nfe("sa", nfe, **kw)
    assert ts.n_steps == js.n_steps
    assert ts.nfe == js.nfe
    assert ts.network_nfe == js.network_nfe


def test_model_is_called_nfe_times():
    calls = []
    model = TGMM.default_2d().model_fn(t_get_schedule("vp_linear"))

    def counted(x, t):
        calls.append(float(t))
        return model(x, t)

    for mode in ("PEC", "PECE"):
        calls.clear()
        s = tsamplers.make_sampler("sa", nfe=11, mode=mode)
        s.sample(counted, torch.zeros(SHAPE))
        assert len(calls) == s.nfe


def test_default_noise_is_a_seeded_generator():
    s = tsamplers.make_sampler("sa", nfe=6)
    model = TGMM.default_2d().model_fn(t_get_schedule("vp_linear"))
    x_T = s.init_noise(torch.Generator().manual_seed(0), SHAPE)
    a = s.sample(model, x_T, torch.Generator().manual_seed(4))
    b = s.sample(model, x_T, torch.Generator().manual_seed(4))
    c = s.sample(model, x_T, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(s.sample(model, x_T), s.sample(model, x_T))


def test_cpu_solves_launch_no_kernel():
    ops.reset_launch_counts()
    for combine in ("kernel", "fused"):
        solve_both(nfe=6, combine=combine)
    assert ops.launch_counts() == {"sa_update": 0, "sa_fused": 0,
                                   "flash_attention": 0, "rwkv6_wkv": 0}


def test_fused_coefficients_rotate_columns_not_data():
    """The fused plan rows are the reference's ``_rotated`` matrices."""
    from repro.core.samplers.multistep import _rotated
    jplan = jsamplers.build_plan(jsamplers.SamplerSpec.from_nfe("sa", 9))
    tplan = tsamplers.build_plan(tsamplers.SamplerSpec.from_nfe("sa", 9))
    P = tplan.arrays["pred"].shape[1]
    for i in range(tplan.arrays["decay"].shape[0]):
        ref = _rotated(jplan.arrays, i, P, jplan.arrays["pred"][i],
                       jplan.arrays["corr"][i])
        np.testing.assert_array_equal(tplan.arrays["fused_packed"][i].numpy(),
                                      np.asarray(ref))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(combine="fused", history="concat"), ValueError, "ring"),
    (dict(combine="pallas"), ValueError, "combine"),
    (dict(history="tree"), ValueError, "history"),
    (dict(precision="fp8"), ValueError, "precision"),
    (dict(program=object()), TypeError, "StepProgram"),
    (dict(feature_cache=2, history="concat"), ValueError, "history='ring'"),
])
def test_spec_validation(bad, exc, match):
    with pytest.raises(exc, match=match):
        tsamplers.make_sampler("sa", n_steps=5, **bad)


def test_unported_entry_points_raise_loudly():
    # trajectory=True, the baselines, the step protocol's feature cache
    # and tiers from an autotuner artifact are ported (held in
    # tests/test_torch_stepwise.py, tests/test_torch_baselines.py,
    # tests/test_torch_feature_cache_lanes.py and tests/test_torch_tune.py);
    # a feature-cached carry needs the Denoiser that shapes its features
    fc = tsamplers.make_sampler("sa", nfe=5, feature_cache=2)
    with pytest.raises(ValueError, match="model_fn="):
        tsamplers.fresh_carry(fc.plan, 2, SHAPE, torch.float32, device="cpu")
    with pytest.raises(TypeError, match="StepProgram"):
        tsamplers.make_sampler("sa", nfe=9, program=object())
    with pytest.raises(ValueError, match="unknown sampler"):
        tsamplers.make_sampler("nope", nfe=5)


def test_sliced_w2_matches_numpy():
    from repro_torch.core.metrics import sliced_w2
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 2)).astype(np.float32)
    y = (rng.standard_normal((256, 2)) * 1.5 + 0.3).astype(np.float32)
    got = sliced_w2(torch.from_numpy(x), torch.from_numpy(y),
                    torch.Generator().manual_seed(3), n_proj=16)
    dirs = torch.randn((16, 2), generator=torch.Generator().manual_seed(3))
    dirs = (dirs / dirs.norm(dim=-1, keepdim=True)).numpy()
    ref = np.mean((np.sort(x @ dirs.T, 0) - np.sort(y @ dirs.T, 0)) ** 2)
    assert got == pytest.approx(float(ref), rel=1e-5)
    with pytest.raises(ValueError, match="equal sample counts"):
        sliced_w2(torch.zeros(3, 2), torch.zeros(4, 2), torch.Generator())


def test_gaussian_oracle_matches_reference():
    from repro.core import gaussian_oracle as j_gaussian_oracle
    from repro_torch.core import gaussian_oracle
    jg = j_gaussian_oracle(j_get_schedule("vp_linear"), mean=0.5, std=0.8)
    tg = gaussian_oracle(t_get_schedule("vp_linear"), mean=0.5, std=0.8)
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    ref = jg.x0_prediction(j_get_schedule("vp_linear"), jnp.asarray(x),
                           jnp.float32(0.4))
    got = tg.x0_prediction(t_get_schedule("vp_linear"), torch.from_numpy(x),
                           torch.tensor(0.4))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_gmm_solve_reaches_the_oracle_distribution():
    """The port's SA sampler on its own noise lands on the GMM: sliced-W2
    to exact oracle samples far below that of the prior (CPU, 4096
    points; chip_smoke.py runs the same check with 65536 on the card)."""
    from repro_torch.core.metrics import sliced_w2
    gmm = TGMM.default_2d()
    s = tsamplers.make_sampler("sa", nfe=20, tau=1.0, combine="fused")
    g = torch.Generator().manual_seed(5)
    x_T = s.init_noise(g, (4096, 2))
    out = s.sample(gmm.model_fn(t_get_schedule("vp_linear")), x_T, g)
    target = gmm.sample(torch.Generator().manual_seed(6), 4096)
    assert abs(float(target.mean()) - float(gmm.means.mean())) < 0.1
    sw2 = sliced_w2(out, target, torch.Generator().manual_seed(7))
    assert sw2 < 0.05 < sliced_w2(x_T, target, torch.Generator().manual_seed(7))
