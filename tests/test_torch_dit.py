"""The port's DiT denoiser against the JAX reference, with the reference's
parameters carried across by ``repro_torch.convert.params_from_jax``:
``denoise`` on the dit-xl-2 and dit-s smoke configs with and without the
flash-attention path, the tame (contractive) network, and a whole SA solve
on the tame smoke DiT with the reference's noise injected.

Tolerances: 1e-5 with a float32 residual stream. 2e-2 with the reference's
bfloat16 residual stream: bf16 rounds at other places in the two
frameworks (XLA may keep a fused chain of bf16 elementwise ops in float32
and round once, PyTorch rounds after each op), and one flipped bf16
rounding is a 2^-8 relative step. The whole tame solve holds 1e-4 in
relative norm at float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as j_ARCHS
from repro.configs import get_smoke as j_get_smoke
from repro.core import Denoiser as JDenoiser
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.models.common import mlp_apply as j_mlp_apply
from repro.models.common import rms_norm as j_rms_norm
from repro.models.tame import tame_dit as j_tame_dit
from repro.models.tame import tame_networks as j_tame_networks
from repro.models.transformer import timestep_embedding as j_temb
from repro_torch.configs import ARCHS as ARCHS_ALL
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.models import TransformerLM
from repro_torch.models.common import ParamDef, mlp_apply, rms_norm
from repro_torch.models.tame import (ensure_contractive, jacobian_gain,
                                     tame_dit, tame_networks)
from repro_torch.models.transformer import timestep_embedding

ARCHS = ["dit-xl-2", "dit-s"]


def _pair_models(arch, dtype, flash):
    """Reference model + tame params, and the port model + converted params."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel, jparams, mu = j_tame_dit(arch, n_layers=2, dtype=jdt)
    if flash:  # the reference routes use_flash through AttentionConfig only
        jmodel.acfg = dataclasses.replace(jmodel.acfg, use_flash=True)
    tcfg = dataclasses.replace(get_smoke(arch), n_layers=2, dtype=tdt,
                               use_flash=flash)
    tmodel = TransformerLM(tcfg)
    tparams = params_from_jax(jax.device_get(jparams), tmodel)
    return jmodel, jparams, mu, tmodel, tparams


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("flash", [False, True])
def test_denoise_matches_reference(arch, dtype, tol, flash):
    jmodel, jparams, _, tmodel, tparams = _pair_models(arch, dtype, flash)
    z = np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32)
    for t in (0.9, 0.2):
        ref = np.asarray(jmodel.denoise(jparams, jnp.asarray(z), t))
        got = tmodel.denoise(tparams, torch.from_numpy(z), t)
        assert got.dtype == torch.float32 and got.shape == (2, 16, 8)
        np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_denoise_matches_reference(arch):
    """adaLN-zero init: both predict exactly zero."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jm.param_defs())
    tm = TransformerLM(dataclasses.replace(get_smoke(arch), dtype=torch.float32))
    tp = params_from_jax(jax.device_get(jp), tm)
    z = torch.randn(2, 8, 8)
    assert torch.count_nonzero(tm.denoise(tp, z, 0.5)) == 0


def test_layers_match_reference():
    rng = np.random.default_rng(3)
    x, w = rng.standard_normal((4, 32)).astype(np.float32), \
        rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6,
        atol=1e-6)
    p = {"wi": rng.standard_normal((32, 64)).astype(np.float32) / 6,
         "wo": rng.standard_normal((64, 32)).astype(np.float32) / 8}
    ref = j_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(x), "gelu", False)
    got = mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    t = np.asarray([0.001, 0.5, 0.999], np.float32)
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), 256).numpy(),
                               np.asarray(j_temb(jnp.asarray(t), 256)),
                               rtol=1e-5, atol=1e-5)


def test_scaled_init_keeps_the_reference_fan_in():
    """"scaled" uses shape[-2] as the fan-in for every rank >= 2: a 3-D
    [d, H, hd] projection draws at 1/sqrt(H)."""
    g = torch.Generator().manual_seed(0)
    w = ParamDef((512, 4, 64), (None, None, None), "scaled").materialize(
        g, torch.float32, "cpu")
    assert abs(float(w.std()) - 0.5) < 0.01
    w2 = ParamDef((400, 100), (None, None), "scaled").materialize(
        g, torch.float32, "cpu")
    assert abs(float(w2.std()) - 0.05) < 0.002


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(arch):
    jm = j_build_model(j_get_smoke(arch))
    jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                              jm.param_defs()))
    tm = TransformerLM(get_smoke(arch))
    flat_j = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}

    def walk(d, prefix=""):
        for k, v in d.items():
            if isinstance(v, ParamDef):
                flat_t[prefix + k] = tuple(v.shape)
            else:
                walk(v, prefix + k + "/")
    walk(tm.param_defs())
    assert flat_t == flat_j


def test_full_config_is_dit_xl_2():
    """DiT-XL/2's published widths; the port's registry is the
    reference's, in order (every arch of the zoo is ported), and an
    unknown name is a KeyError."""
    cfg = get_config("dit-xl-2")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
            cfg.denoiser_latent) == (28, 1152, 16, 72, 4608, 16)
    assert tuple(ARCHS_ALL) == tuple(j_ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("dit-xxl")


def test_params_from_jax_rejects_unconsumed_and_missing_leaves():
    jm = j_build_model(j_get_smoke("dit-s"))
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0), jm.param_defs()))
    tm = TransformerLM(get_smoke("dit-s"))
    extra = dict(jp, blocks=dict(jp["blocks"], stray=np.zeros(3)))
    with pytest.raises(ValueError, match="blocks/stray"):
        params_from_jax(extra, tm)
    with pytest.raises(ValueError, match="blocks/stray"):
        params_from_jax(extra, config=j_get_smoke("dit-s"))
    # without a model the DiT comes from the reference's config
    for got, want in zip(
            jax.tree.leaves(params_from_jax(jp, config=j_get_smoke("dit-s"))),
            jax.tree.leaves(params_from_jax(jp, tm))):
        assert torch.equal(got, want)
    missing = dict(jp, denoiser={k: v for k, v in jp["denoiser"].items()
                                 if k != "out_proj"})
    with pytest.raises(KeyError, match="denoiser/out_proj"):
        params_from_jax(missing, tm)
    bad = dict(jp, ln_f=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="ln_f"):
        params_from_jax(bad, tm)


def test_params_from_jax_refuses_a_zoo_denoiser():
    """A transformer tree's shapes do not say its activation, gating, RoPE
    or soft-capping: without ``model=`` or the reference config the
    converter refuses it. With starcoder2-3b's config (GELU, ungated,
    RoPE) it converts, and that zoo denoiser denoises as the reference
    does; qwen2-vl's config (M-RoPE, which an earlier slice refused)
    converts too and its denoiser denoises as the reference's; a DiT
    config still converts and denoises as the reference does."""
    jcfg = dataclasses.replace(j_get_smoke("starcoder2-3b"),
                               denoiser_latent=8, dtype=jnp.float32)
    assert jcfg.rope_type == "rope"
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jm.param_defs(), jnp.float32)
    jp["denoiser"]["out_proj"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(2), jp["denoiser"]["out_proj"].shape)
    jp = jax.device_get(jp)
    with pytest.raises(ValueError, match="config="):
        params_from_jax(jp)
    tp = params_from_jax(jp, config=jcfg)
    tm = TransformerLM(dataclasses.replace(
        get_smoke("starcoder2-3b"), denoiser_latent=8, dtype=torch.float32))
    z = np.random.default_rng(1).standard_normal((2, 16, 8)).astype(np.float32)
    ref = np.asarray(jm.denoise(jp, jnp.asarray(z), 0.5))
    got = tm.denoise(tp, torch.from_numpy(z), 0.5)
    assert float(np.abs(ref).max()) > 0.01
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    qcfg = dataclasses.replace(j_get_smoke("qwen2-vl-2b"), denoiser_latent=8,
                               dtype=jnp.float32)
    qm = j_build_model(qcfg)
    qp = j_init_params(jax.random.PRNGKey(3), qm.param_defs(), jnp.float32)
    qp["denoiser"]["out_proj"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(4), qp["denoiser"]["out_proj"].shape)
    qp = jax.device_get(qp)
    tq = params_from_jax(qp, config=qcfg)
    qt = TransformerLM(dataclasses.replace(
        get_smoke("qwen2-vl-2b"), denoiser_latent=8, dtype=torch.float32))
    ref = np.asarray(qm.denoise(qp, jnp.asarray(z), 0.5))
    got = qt.denoise(tq, torch.from_numpy(z), 0.5)
    assert float(np.abs(ref).max()) > 0.01
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    jcfg = dataclasses.replace(j_get_smoke("dit-s"), dtype=jnp.float32)
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(1), jm.param_defs(), jnp.float32)
    jp["denoiser"]["out_proj"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(2), jp["denoiser"]["out_proj"].shape)
    tp = params_from_jax(jax.device_get(jp), config=jcfg)
    tm = TransformerLM(dataclasses.replace(get_smoke("dit-s"),
                                           dtype=torch.float32))
    ref = np.asarray(jm.denoise(jp, jnp.asarray(z), 0.5))
    got = tm.denoise(tp, torch.from_numpy(z), 0.5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("field,value", [
    ("act", "silu"), ("gated_mlp", True), ("rope_type", "rope"),
    ("attn_logit_softcap", 30.0)])
def test_transformer_refuses_block_options_it_does_not_compute(field, value):
    """The DiT block's options beyond the DiT's own values are computed
    now (the LM slice): the smoke DiT with ``field`` at ``value`` denoises
    as the reference's with the same option, within 1e-5 at float32; and
    with M-RoPE (sections (4, 6, 6) of its 16 frequencies), which an
    earlier slice refused (the MoE family's fields are computed since its
    slice, tests/test_torch_moe.py)."""
    cfg = get_smoke("dit-s")
    assert (cfg.act, cfg.gated_mlp, cfg.rope_type,
            cfg.attn_logit_softcap) == ("gelu", False, "none", None)
    jcfg = dataclasses.replace(j_get_smoke("dit-s"), dtype=jnp.float32,
                               **{field: value})
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(3), jm.param_defs(), jnp.float32)
    jp["blocks"]["adaln"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(4), jp["blocks"]["adaln"].shape)
    jp["denoiser"]["out_proj"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(5), jp["denoiser"]["out_proj"].shape)
    tm = TransformerLM(dataclasses.replace(cfg, dtype=torch.float32,
                                           **{field: value}))
    tp = params_from_jax(jax.device_get(jp), tm)
    z = np.random.default_rng(2).standard_normal((2, 16, 8)).astype(np.float32)
    ref = np.asarray(jm.denoise(jp, jnp.asarray(z), 0.4))
    got = tm.denoise(tp, torch.from_numpy(z), 0.4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    mrope = {"rope_type": "mrope", "mrope_sections": (4, 6, 6)}
    jm = j_build_model(dataclasses.replace(jcfg, **mrope))
    tm = TransformerLM(dataclasses.replace(tm.cfg, **mrope))
    ref = np.asarray(jm.denoise(jp, jnp.asarray(z), 0.4))
    got = tm.denoise(tp, torch.from_numpy(z), 0.4)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ tame
@pytest.mark.parametrize("arch", ARCHS)
def test_tame_network_matches_reference(arch):
    jmodel, jparams, mu, tmodel, tparams = _pair_models(arch, "f32", False)
    jnet, _ = j_tame_networks(jmodel, jparams, mu)
    tnet, _ = tame_networks(tmodel, tparams,
                            lambda seq: torch.from_numpy(np.array(mu(seq))))
    z = np.random.default_rng(1).standard_normal((2, 16, 8)).astype(np.float32)
    for t in (0.95, 0.3):
        ref = np.asarray(jnet(jnp.asarray(z), jnp.float32(t), None))
        got = tnet(torch.from_numpy(z), torch.tensor(t), None)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_tame_solve_matches_reference():
    """Whole SA solve (fused combine, PEC, P3C3, tau=1) of the tame smoke
    DiT with the reference's noise: 1e-4 in relative norm at f32."""
    jmodel, jparams, mu, _, _ = _pair_models("dit-s", "f32", False)
    tm = TransformerLM(dataclasses.replace(get_smoke("dit-s"), n_layers=2,
                                           dtype=torch.float32, use_flash=True))
    tp = params_from_jax(jax.device_get(jparams), tm)
    jnet, _ = j_tame_networks(jmodel, jparams, mu)
    tnet, _ = tame_networks(tm, tp,
                            lambda s: torch.from_numpy(np.array(mu(s))))
    kw = dict(nfe=10, tau=1.0, combine="fused")
    js = jsamplers.make_sampler("sa", **kw)
    ts = tsamplers.make_sampler("sa", **kw)
    x_T = np.random.default_rng(2).standard_normal((2, 16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, js.spec.n_steps)
    xis = [np.array(jax.random.normal(k, x_T.shape, jnp.float32)) for k in keys]
    ref = np.asarray(js.sample(
        JDenoiser(jnet, j_get_schedule("vp_linear"), prediction="x0"),
        jnp.asarray(x_T), key))
    got = ts.sample(Denoiser(tnet, get_schedule("vp_linear"), prediction="x0"),
                    torch.from_numpy(x_T),
                    noise=lambda i: torch.from_numpy(xis[i]))
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= 1e-4


def test_port_tame_dit_is_contractive():
    """The port's own construction (its own draws): Jacobian gain < 1."""
    model, params, mu = tame_dit("dit-s", n_layers=8, device="cpu")
    net, _ = tame_networks(model, params, mu)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 8, generator=g)
    v = torch.randn(x.shape, generator=g)
    for t in (0.95, 0.5, 0.1):
        assert jacobian_gain(net, x, t, v) < 1.0


def test_ensure_contractive_damps_expansive_adaln():
    """An over-scaled adaLN is halved until the gain drops below 1; a net
    that cannot get there raises."""
    model, params, mu = tame_dit("dit-s", n_layers=4, adaln_scale=3.0,
                                 device="cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 8, generator=g)
    report = ensure_contractive(model, params, mu, x, g, max_halvings=12)
    assert report["halvings"] > 0
    assert report["damped"] == "adaln"
    assert report["factor"] == 0.5 ** report["halvings"]
    assert max(report["gains"].values()) < 1.0
    model, params, mu = tame_dit("dit-s", n_layers=4, out_div=0.01,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="expansive"):
        ensure_contractive(model, params, mu, x, g, max_halvings=1)


def test_tame_dit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tame_dit("dit-s")
