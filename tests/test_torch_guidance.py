"""Class conditioning and one-call classifier-free guidance in the PyTorch
port against the JAX reference.

The port's DiT takes a class/text vector (``denoiser_cond``, ``y_proj``),
and its Denoiser runs both CFG branches as ONE network call over the
doubled batch ``[x; x]`` with ``[cond; null]``, where the reference vmaps
the network over a leading [2] lane axis. The same numpy-seeded inputs,
and the reference's per-step draws (``split(key, M)``, one f32 normal
each), go through both. The conditioning layouts are the three a caller
gives: a shared ``(seq, dz)`` input-space prompt (also with ``seq == B``),
a shared ``[d_cond]`` vector, and a per-sample ``[B, d_cond]`` batch.

Tolerances: single evaluations 1e-5; whole solves 1e-5 in relative norm
at f32 and the reference's bf16 bar of 1e-2 under the bf16 policy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Denoiser as JDenoiser
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.models import build_model as j_build_model
from repro.models.tame import tame_dit as j_tame_dit
from repro.models.tame import tame_networks as j_tame_networks
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.launch import sample as launch_sample
from repro_torch.models import TransformerLM
from repro_torch.models.tame import tame_networks

JS, TS = j_get_schedule("vp_linear"), get_schedule("vp_linear")
D_COND = 4
SEQ, DZ = 16, 8


def _anchor(mu):
    return lambda seq: torch.from_numpy(np.array(mu(seq)))


def dit_pair(d_cond=D_COND, n_layers=2):
    """The reference's tame smoke DiT made class-conditional (a random
    ``y_proj`` drawn like the port's tame one) and the port's model with
    the converted parameters: ``(jmodel, jparams, mu, tmodel, tparams)``.
    ``d_cond=None`` keeps it unconditional."""
    jmodel, jparams, mu = j_tame_dit("dit-s", n_layers=n_layers)
    if d_cond is not None:
        jmodel = j_build_model(dataclasses.replace(jmodel.cfg,
                                                   denoiser_cond=d_cond))
        d = jmodel.cfg.d_model
        jparams["denoiser"]["y_proj"] = 0.3 / np.sqrt(d_cond) * \
            jax.random.normal(jax.random.PRNGKey(7), (d_cond, d))
    tmodel = TransformerLM(dataclasses.replace(
        get_smoke("dit-s"), n_layers=n_layers, dtype=torch.float32,
        denoiser_cond=d_cond))
    tparams = params_from_jax(jax.device_get(jparams), tmodel)
    return jmodel, jparams, mu, tmodel, tparams


def networks(layout):
    """(reference network, port network, port cond_rank) of one layout's
    backbone: the class-conditional DiT for the ``class_*`` layouts, the
    unconditional one taking an input-space prompt otherwise."""
    conditional = layout.startswith("class")
    jmodel, jparams, mu, tmodel, tparams = dit_pair(
        D_COND if conditional else None)
    if conditional:
        def jnet(x, t, c):
            return jmodel.denoise(jparams, x, t, c) + mu(x.shape[-2])
    else:
        jnet, _ = j_tame_networks(jmodel, jparams, mu)
    tnet, _ = tame_networks(tmodel, tparams, _anchor(mu))
    return jnet, tnet, (1 if conditional else None)


#: layout -> (batch, seq, cond shape)
LAYOUTS = {
    "prompt_shared": (2, SEQ, (SEQ, DZ)),
    "prompt_seq_eq_batch": (4, 4, (4, DZ)),
    "class_shared": (2, SEQ, (D_COND,)),
    "class_shared_batch_eq_width": (D_COND, SEQ, (D_COND,)),
    "class_per_sample": (3, SEQ, (3, D_COND)),
}


def layout_inputs(layout, seed=0):
    B, S, cshape = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, DZ)).astype(np.float32)
    if layout.startswith("class"):
        # one-hot classes (the label-embedding lookup) for the batch, or
        # one shared class
        rows = rng.integers(0, D_COND, cshape[0] if len(cshape) == 2 else 1)
        cond = np.eye(D_COND, dtype=np.float32)[rows]
        cond = cond if len(cshape) == 2 else cond[0]
    else:
        cond = 0.3 * rng.standard_normal(cshape).astype(np.float32)
    return x, cond


# ------------------------------------------------------- the backbone
@pytest.mark.parametrize("cond_layout", ["none", "shared", "per_sample"])
def test_conditional_denoise_matches_reference(cond_layout):
    jmodel, jparams, _, tmodel, tparams = dit_pair()
    rng = np.random.default_rng(1)
    z = rng.standard_normal((3, SEQ, DZ)).astype(np.float32)
    cond = {"none": None,
            "shared": rng.standard_normal(D_COND).astype(np.float32),
            "per_sample": rng.standard_normal((3, D_COND)).astype(np.float32),
            }[cond_layout]
    for t in (0.9, 0.2):
        ref = jmodel.denoise(jparams, jnp.asarray(z), t,
                             None if cond is None else jnp.asarray(cond))
        got = tmodel.denoise(tparams, torch.from_numpy(z), t,
                             None if cond is None else torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_conditioning_moves_the_prediction_and_needs_denoiser_cond():
    _, _, _, tmodel, tparams = dit_pair()
    z = torch.from_numpy(layout_inputs("class_shared")[0])
    a = tmodel.denoise(tparams, z, 0.5, torch.eye(D_COND)[0])
    b = tmodel.denoise(tparams, z, 0.5, torch.eye(D_COND)[1])
    assert float((a - b).abs().max()) > 1e-6
    _, _, _, umodel, uparams = dit_pair(None)
    with pytest.raises(ValueError, match="denoiser_cond"):
        umodel.denoise(uparams, z, 0.5, torch.eye(D_COND)[0])
    assert "y_proj" not in uparams["denoiser"]


def test_converter_carries_y_proj():
    jmodel, jparams, _, tmodel, tparams = dit_pair()
    want = np.asarray(jparams["denoiser"]["y_proj"])
    assert tmodel.param_defs()["denoiser"]["y_proj"].shape == want.shape
    np.testing.assert_array_equal(tparams["denoiser"]["y_proj"].numpy(), want)
    # from the reference's config alone: denoiser_cond no longer refused
    by_config = params_from_jax(jax.device_get(jparams), config=jmodel.cfg)
    np.testing.assert_array_equal(by_config["denoiser"]["y_proj"].numpy(),
                                  want)
    # a conditional tree does not convert into an unconditional model
    with pytest.raises(ValueError, match="denoiser/y_proj"):
        params_from_jax(jax.device_get(jparams), dit_pair(None)[3])


# ------------------------------------------------- one-call guidance
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("scale", [1.5, 4.0])
@pytest.mark.parametrize("target", ["data", "noise"])
def test_one_call_cfg_matches_reference_vmapped_cfg(layout, scale, target):
    jnet, tnet, rank = networks(layout)
    x, cond = layout_inputs(layout)
    jd = JDenoiser(jnet, JS, prediction="x0", guidance=True)
    td = Denoiser(tnet, TS, prediction="x0", guidance=True, cond_rank=rank)
    for t in (0.8, 0.1):
        ref = jd.as_model_fn(target, jnp.asarray(cond), jnp.float32(scale))(
            jnp.asarray(x), jnp.float32(t))
        got = td.as_model_fn(target, torch.from_numpy(cond), scale)(
            torch.from_numpy(x), torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("layout", ["prompt_seq_eq_batch", "class_per_sample",
                                    "class_shared_batch_eq_width"])
def test_one_call_cfg_is_one_network_call_over_twice_the_batch(layout):
    """Both branches in one call of batch 2B; the cond rows first, each
    half of ``cond`` expanded to the batch by the declared rank, never by
    its sizes (a shared (seq, dz) prompt with seq == B, a shared [d_cond]
    class with B == d_cond)."""
    _, tnet, rank = networks(layout)
    x, cond = layout_inputs(layout)
    calls = []

    def counted(xx, t, cc):
        calls.append((tuple(xx.shape), tuple(cc.shape)))
        return tnet(xx, t, cc)

    td = Denoiser(counted, TS, prediction="x0", guidance=True, cond_rank=rank)
    td.as_model_fn("data", torch.from_numpy(cond), 2.0)(
        torch.from_numpy(x), torch.tensor(0.5))
    B = x.shape[0]
    per_sample = cond.shape if rank is not None and cond.ndim > rank \
        else (B,) + cond.shape
    assert calls == [((2 * B,) + x.shape[1:],
                      (2 * per_sample[0],) + per_sample[1:])]


def test_cfg_pair_layout_and_null_rows():
    td = Denoiser(lambda x, t, c: x, TS, prediction="x0", guidance=True,
                  cond_rank=1)
    x = torch.arange(6.0).reshape(3, 2)
    xx, cc = td._cfg_pair(x, torch.tensor([1.0, 2.0]))
    assert torch.equal(xx, torch.cat([x, x]))
    assert torch.equal(cc, torch.tensor([[1.0, 2.0]] * 3 + [[0.0, 0.0]] * 3))
    per = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    assert torch.equal(td._cfg_pair(x, per)[1],
                       torch.cat([per, torch.zeros(3, 2)]))
    assert td._cfg_pair(x, None)[1] is None
    with pytest.raises(ValueError, match="batch of 3"):
        td._cfg_pair(x, torch.ones(4, 2))
    with pytest.raises(ValueError, match="rank 1"):
        td._cfg_pair(x, torch.ones(3, 2, 2))
    with pytest.raises(ValueError, match="null_cond"):
        dataclasses.replace(td, null_cond=torch.ones(2))._cfg_pair(x, None)


@pytest.mark.parametrize("null", ["absent", "given"])
def test_null_cond_matches_reference(null):
    jnet, tnet, _ = networks("class_per_sample")
    x, cond = layout_inputs("class_per_sample")
    null_c = (None if null == "absent" else
              np.random.default_rng(5).standard_normal(D_COND)
              .astype(np.float32))
    # the reference vmaps lanes of [B, d_cond]: its null must be batched too
    j_null = None if null_c is None else jnp.broadcast_to(
        jnp.asarray(null_c), cond.shape)
    jd = JDenoiser(jnet, JS, prediction="x0", guidance=True,
                   null_cond=j_null)
    td = Denoiser(tnet, TS, prediction="x0", guidance=True, cond_rank=1,
                  null_cond=None if null_c is None
                  else torch.from_numpy(null_c))
    ref = jd.as_model_fn("data", jnp.asarray(cond), jnp.float32(2.5))(
        jnp.asarray(x), jnp.float32(0.4))
    got = td.as_model_fn("data", torch.from_numpy(cond), 2.5)(
        torch.from_numpy(x), torch.tensor(0.4))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    if null_c is not None:  # a non-zero null embedding changes the result
        zero = Denoiser(tnet, TS, prediction="x0", guidance=True,
                        cond_rank=1).as_model_fn(
            "data", torch.from_numpy(cond), 2.5)(
            torch.from_numpy(x), torch.tensor(0.4))
        assert float((zero - got).abs().max()) > 1e-7


@pytest.mark.parametrize("layout", ["prompt_shared", "class_per_sample"])
def test_guidance_scale_one_equals_unguided(layout):
    """(1-s) u + s c at s = 1 is the conditional rows of the doubled call;
    those rows agree with the unguided call of batch B to f32 rounding."""
    _, tnet, rank = networks(layout)
    x, cond = (torch.from_numpy(a) for a in layout_inputs(layout))
    t = torch.tensor(0.6)
    guided = Denoiser(tnet, TS, prediction="x0", guidance=True,
                      cond_rank=rank).as_model_fn("data", cond, 1.0)(x, t)
    plain = Denoiser(tnet, TS, prediction="x0").as_model_fn(
        "data", cond, 1.0)(x, t)
    torch.testing.assert_close(guided, plain, atol=1e-5, rtol=1e-5)


def reference_noise(key, M, shape):
    keys = jax.random.split(key, M)
    return [np.array(jax.random.normal(keys[i], shape, jnp.float32))
            for i in range(M)]


@pytest.mark.parametrize("layout", ["prompt_shared", "class_per_sample"])
@pytest.mark.parametrize("precision,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_guided_solve_matches_reference(layout, precision, tol):
    jnet, tnet, rank = networks(layout)
    x_T, cond = layout_inputs(layout, seed=3)
    kw = dict(nfe=8, tau=1.0, combine="fused", guidance=True,
              prediction="x0", precision=precision)
    js, ts = (jsamplers.make_sampler("sa", **kw),
              tsamplers.make_sampler("sa", **kw))
    key = jax.random.PRNGKey(4)
    xis = reference_noise(key, js.spec.n_steps, x_T.shape)
    ref = np.asarray(js.sample(
        JDenoiser(jnet, JS, prediction="x0", guidance=True),
        jnp.asarray(x_T), key, cond=jnp.asarray(cond), guidance_scale=1.5),
        np.float32)
    got = ts.sample(
        Denoiser(tnet, TS, prediction="x0", guidance=True, cond_rank=rank),
        torch.from_numpy(x_T), noise=lambda i: torch.from_numpy(xis[i]),
        cond=torch.from_numpy(cond), guidance_scale=1.5).float().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= tol
    assert ts.spec.network_nfe == js.spec.network_nfe == 2 * ts.nfe


# ------------------------------------------------------------ driver
@pytest.mark.parametrize("prediction", ["v", "eps", "x0"])
def test_sample_driver_guidance_flags_end_to_end(capsys, tmp_path,
                                                 prediction):
    cond = 0.1 * np.random.default_rng(0).standard_normal((SEQ, DZ))
    path = tmp_path / "cond.npy"
    np.save(path, cond.astype(np.float32))
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", str(SEQ), "--nfe", "9", "--device", "cpu",
                        "--weights", "tame", "--combine", "fused",
                        "--prediction", prediction, "--guidance-scale", "1.5",
                        "--cond-file", str(path)])
    out = capsys.readouterr().out
    assert "NFE=9 (network NFE=18) (requested 9) steps=8" in out
    assert f"prediction={prediction} guidance=1.5" in out
    assert "finite=True" in out


def test_sample_driver_prediction_round_trip_is_the_x0_solve():
    """Served as v and converted back by the Denoiser, the backbone
    samples what it samples natively: 1e-5 in relative norm."""
    outs = {}
    for prediction in ("x0", "v"):
        cfg, net, _ = launch_sample.build_denoiser(
            "dit-s", smoke=True, weights="tame", device="cpu")
        s = tsamplers.make_sampler("sa", nfe=6, prediction=prediction)
        den = Denoiser(launch_sample.as_prediction_network(net, TS,
                                                           prediction),
                       TS, prediction=prediction)
        x_T = torch.from_numpy(layout_inputs("prompt_shared")[0])
        outs[prediction] = s.sample(den, x_T,
                                    torch.Generator().manual_seed(0))
    assert float((outs["v"] - outs["x0"]).norm() / outs["x0"].norm()) <= 1e-5
