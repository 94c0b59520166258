"""The port's denoiser adapter against the JAX reference:
``convert_prediction`` between eps/x0/v, classifier-free guidance with the
``(1-s) u + s c`` combine over the analytic networks of
``repro.kernels.ref.denoiser_oracles``, and guided whole solves.

Single evaluations agree to 1e-5 (float32 transcendental functions differ
in the last bits between the frameworks); whole solves to 1e-5 in
relative norm (see tests/test_torch_samplers.py).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import GMM as JGMM
from repro.core import convert_prediction as j_convert
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.core.denoiser import Denoiser as JDenoiser
from repro.kernels.ref import denoiser_oracles
from repro_torch.core import GMM as TGMM
from repro_torch.core import Denoiser, convert_prediction, get_schedule
from repro_torch.core import samplers as tsamplers

JS, TS = j_get_schedule("vp_linear"), get_schedule("vp_linear")
J_NETS = denoiser_oracles(JS, JGMM.default_2d())
T_GMM = TGMM.default_2d()
T_MAKERS = {"x0": T_GMM.x0_prediction, "eps": T_GMM.eps_prediction,
            "v": T_GMM.v_prediction}


def t_net(kind):
    """The oracle as a Denoiser network. ``cond`` shifts each sample's
    components: one [d] shift for the batch, or one per sample with a
    leading batch axis, which is how guidance passes it (one call over
    the doubled batch)."""
    return lambda x, t, cond: T_MAKERS[kind](
        TS, x, t, shift=None if cond is None else cond[..., None, :])


def _x(seed=0, shape=(64, 2)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("src,dst", list(itertools.product(
    ["x0", "eps", "v"], repeat=2)))
@pytest.mark.parametrize("t", [0.9, 0.3, 0.02])
def test_convert_prediction_matches_reference(src, dst, t):
    x = _x()
    pred = _x(1)
    ref = np.asarray(j_convert(jnp.asarray(pred), jnp.asarray(x),
                               jnp.float32(t), src, dst, JS))
    got = convert_prediction(torch.from_numpy(pred), torch.from_numpy(x),
                             torch.tensor(t), src, dst, TS)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [("eps", "x0"), ("v", "eps"),
                                     ("x0", "v")])
def test_convert_prediction_round_trip(src, dst):
    x = torch.from_numpy(_x())
    pred = torch.from_numpy(_x(2))
    t = torch.tensor(0.4)
    back = convert_prediction(convert_prediction(pred, x, t, src, dst, TS),
                              x, t, dst, src, TS)
    torch.testing.assert_close(back, pred, rtol=1e-5, atol=1e-5)


def test_convert_prediction_bf16_converts_in_f32():
    """A bfloat16 latent converts in float32 as in the reference."""
    x = torch.from_numpy(_x()).to(torch.bfloat16)
    pred = torch.from_numpy(_x(3))
    out = convert_prediction(pred, x, torch.tensor(0.5), "eps", "x0", TS)
    assert out.dtype == torch.float32
    ref = j_convert(jnp.asarray(_x(3)), jnp.asarray(x.float().numpy()
                                                   ).astype(jnp.bfloat16),
                    jnp.float32(0.5), "eps", "x0", JS)
    assert ref.dtype == jnp.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["x0", "eps", "v"])
def test_oracle_networks_match_reference(kind):
    x, cond = _x(), np.asarray([0.3, -0.2], np.float32)
    for c in (None, cond):
        ref = J_NETS[kind](jnp.asarray(x), jnp.float32(0.45),
                           None if c is None else jnp.asarray(c))
        got = t_net(kind)(torch.from_numpy(x), torch.tensor(0.45),
                          None if c is None else torch.from_numpy(c))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["x0", "eps", "v"])
@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("target", ["data", "noise"])
def test_guided_evaluation_matches_reference(kind, scale, target):
    x, cond = _x(), np.asarray([0.5, 0.1], np.float32)
    jd = JDenoiser(J_NETS[kind], JS, prediction=kind, guidance=True)
    td = Denoiser(t_net(kind), TS, prediction=kind, guidance=True)
    ref = jd.as_model_fn(target, jnp.asarray(cond), jnp.float32(scale))(
        jnp.asarray(x), jnp.float32(0.6))
    got = td.as_model_fn(target, torch.from_numpy(cond), scale)(
        torch.from_numpy(x), torch.tensor(0.6))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_guidance_scale_one_equals_unguided():
    """(1-s) u + s c at s = 1 is exactly the conditional branch."""
    x, cond = torch.from_numpy(_x()), torch.tensor([0.4, -0.3])
    guided = Denoiser(t_net("eps"), TS, prediction="eps", guidance=True)
    plain = Denoiser(t_net("eps"), TS, prediction="eps")
    t = torch.tensor(0.5)
    assert torch.equal(guided.as_model_fn("x0", cond, 1.0)(x, t),
                       plain.as_model_fn("x0", cond, 1.0)(x, t))


@pytest.mark.parametrize("kind", ["x0", "eps", "v"])
def test_guided_solve_matches_reference(kind):
    kw = dict(nfe=10, tau=0.5, guidance=True, prediction=kind)
    js, ts = (jsamplers.make_sampler("sa", **kw),
              tsamplers.make_sampler("sa", **kw))
    x_T, cond = _x(4, (128, 2)), np.asarray([0.2, 0.4], np.float32)
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, js.spec.n_steps)
    xis = [np.array(jax.random.normal(k, x_T.shape, jnp.float32)) for k in keys]
    ref = np.asarray(js.sample(
        JDenoiser(J_NETS[kind], JS, prediction=kind, guidance=True),
        jnp.asarray(x_T), key, cond=jnp.asarray(cond), guidance_scale=2.5))
    got = ts.sample(Denoiser(t_net(kind), TS, prediction=kind, guidance=True),
                    torch.from_numpy(x_T), noise=lambda i: torch.from_numpy(xis[i]),
                    cond=torch.from_numpy(cond), guidance_scale=2.5)
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= 1e-5
    assert ts.spec.network_nfe == js.spec.network_nfe == 2 * ts.nfe


def test_plain_model_with_spec_prediction_converts():
    s = tsamplers.make_sampler("sa", nfe=6, prediction="eps")
    x_T = torch.from_numpy(_x(5))
    eps_model = lambda x, t: T_GMM.eps_prediction(TS, x, t)
    x0_model = lambda x, t: T_GMM.x0_prediction(TS, x, t)
    ref = tsamplers.make_sampler("sa", nfe=6).sample(x0_model, x_T)
    got = s.sample(eps_model, x_T)
    assert float((got - ref).norm() / ref.norm()) <= 1e-5


def test_model_argument_validation():
    s = tsamplers.make_sampler("sa", nfe=5)
    x = torch.zeros(8, 2)
    model = lambda x, t: x
    with pytest.raises(ValueError, match="Denoiser"):
        s.sample(model, x, cond=torch.zeros(2))
    with pytest.raises(ValueError, match="guidance_scale"):
        s.sample(model, x, guidance_scale=2.0)
    with pytest.raises(ValueError, match="spec.guidance"):
        s.sample(Denoiser(t_net("x0"), TS, prediction="x0", guidance=True), x)
    sg = tsamplers.make_sampler("sa", nfe=5, guidance=True)
    with pytest.raises(ValueError, match="Denoiser"):
        sg.sample(model, x)
    se = tsamplers.make_sampler("sa", nfe=5, prediction="v")
    with pytest.raises(ValueError, match="predicts"):
        se.sample(Denoiser(t_net("eps"), TS, prediction="eps"), x)
    with pytest.raises(ValueError, match="unknown prediction"):
        Denoiser(t_net("eps"), TS, prediction="score")
