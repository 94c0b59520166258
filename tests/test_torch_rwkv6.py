"""The port's RWKV6 denoiser against the JAX reference, with the reference's
parameters carried across by ``repro_torch.convert.params_from_jax``: the
WKV evaluation paths, the norms, ``denoise`` on the smoke config with and
without the WKV-kernel route, at ``T == chunk`` and ``T > chunk``, the
contractive (tame) weights, and a whole SA solve with the reference's noise
injected.

Tolerances, each against the output's scale max(1, max|ref|), since
float32 round-off of sums of large terms sits at that scale: the WKV paths
1e-5; ``denoise`` with a float32 residual stream 1e-5. With the
reference's bfloat16 stream, 2 bf16 ulp of max|x0|: a last-bit float32
difference flips bf16 roundings of the residual stream (the reference's
own kernel and jnp paths differ by one ulp there). The whole tame solve
holds 1e-4 in relative norm at float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.core import Denoiser as JDenoiser
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.models.common import layer_norm as j_layer_norm
from repro.models.rwkv6 import group_norm as j_group_norm
from repro.models.rwkv6 import wkv_chunked as j_wkv_chunked
from repro.models.rwkv6 import wkv_sequential as j_wkv_sequential
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.kernels import ops
from repro_torch.launch import sample as launch_sample
from repro_torch.models import RWKV6, build_model, init_params
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models.common import ParamDef, layer_norm
from repro_torch.models.tame import (ensure_contractive, jacobian_gain,
                                     tame_networks, tame_rwkv6)

LATENT = 8


def scale_err(got, ref) -> float:
    """max |got - ref| over max(1, max|ref|)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _wkv_inputs(seed, B=2, T=64, H=2, hd=16, decay_shift=0.0):
    """Inputs as the reference's tests draw them; ``decay_shift`` 4 makes
    the decay slow enough (logw about -0.02) for the state to carry
    across chunks."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, T, H, hd)) - decay_shift),
                   -8.0, -1e-5).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


# ------------------------------------------------------------------- wkv
@pytest.mark.parametrize("shape,chunk", [((2, 64, 2, 16), 16),
                                         ((1, 128, 3, 32), 64),
                                         ((2, 32, 1, 8), 32)])
@pytest.mark.parametrize("decay_shift", [0.0, 4.0])
def test_wkv_paths_match_reference(shape, chunk, decay_shift):
    arrs = _wkv_inputs(sum(shape), *shape, decay_shift=decay_shift)
    tin = [torch.from_numpy(a) for a in arrs]
    jin = [jnp.asarray(a) for a in arrs]
    pairs = [(t_rwkv6.wkv_sequential(*tin), j_wkv_sequential(*jin)),
             (t_rwkv6.wkv_chunked(*tin, chunk), j_wkv_chunked(*jin, chunk))]
    for (y, S), (y_ref, S_ref) in pairs:
        assert y.dtype == S.dtype == torch.float32
        assert scale_err(y.numpy(), y_ref) <= 1e-5
        assert scale_err(S.numpy(), S_ref) <= 1e-5
    # the two port paths agree with each other as well
    (ys, Ss), (yc, Sc) = (p[0] for p in pairs)
    assert scale_err(yc.numpy(), ys.numpy()) <= 1e-5
    assert scale_err(Sc.numpy(), Ss.numpy()) <= 1e-5


def test_wkv_chunked_carries_a_large_decay_without_overflow():
    """logw at its -8 clip over a 64-token chunk puts L at -512: the
    pairwise form stays finite where exp(Lprev) * exp(-L) would not."""
    r, k, v, _, u, S0 = _wkv_inputs(7, 1, 128, 1, 16)
    logw = np.full_like(r, -8.0)
    tin = [torch.from_numpy(a) for a in (r, k, v, logw, u, S0)]
    y, S = t_rwkv6.wkv_chunked(*tin, 64)
    ys, Ss = t_rwkv6.wkv_sequential(*tin)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    assert scale_err(y.numpy(), ys.numpy()) <= 1e-5


# ------------------------------------------------------------------ norms
@pytest.mark.parametrize("d", [4, 96])
def test_layer_norm_matches_reference(d):
    rng = np.random.default_rng(d)
    x = (3.0 * rng.standard_normal((5, d)) + 1.0).astype(np.float32)
    w, b = (rng.standard_normal(d).astype(np.float32) for _ in range(2))
    got = layer_norm(*map(torch.from_numpy, (x, w, b)))
    ref = np.asarray(j_layer_norm(*map(jnp.asarray, (x, w, b))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    # population variance: normalised rows have variance exactly 1
    # (the unbiased estimate would leave (d-1)/d, 0.75 at d = 4)
    xt = torch.from_numpy(x)
    unit = layer_norm(xt, torch.ones(d), torch.zeros(d))
    np.testing.assert_allclose(unit.var(dim=-1, correction=0).numpy(), 1.0,
                               rtol=1e-3)
    bf = layer_norm(xt.bfloat16(), torch.from_numpy(w), torch.from_numpy(b))
    assert bf.dtype == torch.bfloat16


def test_group_norm_matches_reference():
    rng = np.random.default_rng(5)
    x = (2.0 * rng.standard_normal((2, 6, 32)) - 0.5).astype(np.float32)
    g, b = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    for groups in (1, 4, 8):  # 8 groups of 4: population variance matters
        got = t_rwkv6.group_norm(*map(torch.from_numpy, (x, g, b)), groups)
        ref = np.asarray(j_group_norm(*map(jnp.asarray, (x, g, b)), groups))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    bf = t_rwkv6.group_norm(torch.from_numpy(x).bfloat16(),
                            *map(torch.from_numpy, (g, b)), 4)
    assert bf.dtype == torch.float32  # the output is left in float32


# ---------------------------------------------------------------- denoise
def _pair_models(dtype: str, use_kernel: bool, out_scale: float = 0.05):
    """Reference model + params (``out_proj`` drawn at ``out_scale``: zero
    at init, it would predict exactly 0), and the port's model + the same
    params converted."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(j_get_smoke("rwkv6-3b"), denoiser_latent=LATENT,
                               dtype=jdt, use_pallas=use_kernel)
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.PRNGKey(0), jm.param_defs(), jnp.float32)
    jp["denoiser"]["out_proj"] = out_scale * jax.random.normal(
        jax.random.PRNGKey(1), jp["denoiser"]["out_proj"].shape)
    tm = build_model(dataclasses.replace(
        get_smoke("rwkv6-3b"), denoiser_latent=LATENT, dtype=tdt,
        use_kernel=use_kernel))
    return jm, jp, tm, params_from_jax(jax.device_get(jp), tm)


def _init(model):
    return init_params(torch.Generator().manual_seed(0), model.param_defs())


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("T", [64, 128])  # chunk 64: T == chunk and T > chunk
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_denoise_matches_reference(T, use_kernel, dtype):
    jm, jp, tm, tp = _pair_models(dtype, use_kernel)
    z = np.random.default_rng(T).standard_normal((2, T, LATENT)).astype(
        np.float32)
    for t in (0.9, 0.2):
        ref = np.asarray(jm.denoise(jp, jnp.asarray(z), t))
        got = tm.denoise(tp, torch.from_numpy(z), t)
        assert got.dtype == torch.float32 and got.shape == (2, T, LATENT)
        peak = float(np.abs(ref).max())
        assert peak > 0.1  # a real prediction, not the zero of init weights
        err = float(np.abs(got.numpy() - ref).max())
        if dtype == "f32":
            assert err <= 1e-5 * max(1.0, peak), err
        else:
            assert err <= 2 * _bf16_ulp(peak), (err, peak)


def test_time_mix_routes_like_the_reference(monkeypatch):
    """use_kernel sends every chunked call to ops.wkv (which raises when
    chunk does not divide T); without it, T > chunk takes wkv_chunked and
    T <= chunk the sequential recurrence."""
    calls = []
    for name in ("wkv_sequential", "wkv_chunked"):
        fn = getattr(t_rwkv6, name)
        monkeypatch.setattr(t_rwkv6, name,
                            lambda *a, _f=fn, _n=name: calls.append(_n) or _f(*a))
    fn = ops.wkv
    monkeypatch.setattr(ops, "wkv",
                        lambda *a, **kw: calls.append("ops.wkv") or fn(*a, **kw))
    z = torch.randn(1, 128, LATENT)
    for use_kernel, T, want in ((True, 64, "ops.wkv"), (True, 128, "ops.wkv"),
                                (False, 64, "wkv_sequential"),
                                (False, 128, "wkv_chunked"),
                                (False, 96, "wkv_sequential")):
        tm = build_model(dataclasses.replace(
            get_smoke("rwkv6-3b"), denoiser_latent=LATENT, dtype=torch.float32,
            use_kernel=use_kernel))
        tp = _init(tm)
        calls.clear()
        tm.denoise(tp, z[:, :T], 0.5)
        assert calls == [want] * 2 * tm.cfg.n_layers, (use_kernel, T, calls)
    with pytest.raises(ValueError, match="divisible"):
        tm = build_model(dataclasses.replace(
            get_smoke("rwkv6-3b"), denoiser_latent=LATENT, use_kernel=True))
        tm.denoise(_init(tm), z[:, :96], 0.5)


def test_init_params_denoise_is_zero():
    """Zero-initialised out_proj, as the reference: exactly 0."""
    tm = build_model(dataclasses.replace(get_smoke("rwkv6-3b"),
                                         denoiser_latent=LATENT))
    assert torch.count_nonzero(tm.denoise(_init(tm),
                                          torch.randn(2, 64, LATENT), 0.5)) == 0


# --------------------------------------------------- params and configs
def _flat_shapes(defs, prefix=""):
    out = {}
    for k, v in defs.items():
        if isinstance(v, ParamDef):
            out[prefix + k] = tuple(v.shape)
        else:
            out.update(_flat_shapes(v, prefix + k + "/"))
    return out


def test_param_tree_matches_reference():
    jm = j_build_model(dataclasses.replace(j_get_smoke("rwkv6-3b"),
                                           denoiser_latent=LATENT))
    jp = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                              jm.param_defs()))
    flat_j = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    tm = build_model(dataclasses.replace(get_smoke("rwkv6-3b"),
                                         denoiser_latent=LATENT))
    assert _flat_shapes(tm.param_defs()) == flat_j


def test_full_config_is_rwkv6_3b():
    assert "rwkv6-3b" in ARCHS
    cfg = dataclasses.replace(get_config("rwkv6-3b"), denoiser_latent=16)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
            cfg.chunk_size, cfg.dtype) == (32, 2560, 40, 64, 8960, 64,
                                           torch.bfloat16)
    shapes = _flat_shapes(RWKV6(cfg).param_defs()).values()
    assert sum(int(np.prod(s)) for s in shapes) == 3_107_153_920
    # the published config is the LM: the same tree without the denoiser
    # heads (in_proj and out_proj 16 x 2560, t_mlp1 256 x 2560, t_mlp2
    # 2560 x 2560)
    lm = _flat_shapes(RWKV6(get_config("rwkv6-3b")).param_defs())
    assert not any(k.startswith("denoiser/") for k in lm)
    assert sum(int(np.prod(s)) for s in lm.values()) == \
        3_107_153_920 - (2 * 16 + 256 + 2560) * 2560


def test_params_from_jax_takes_rwkv6_trees():
    jm, jp, tm, tp = _pair_models("f32", False)
    jp = jax.device_get(jp)
    # recognised from the tree itself (blocks/tm), leaf for leaf
    for got, want in zip(jax.tree.leaves(params_from_jax(jp)),
                         jax.tree.leaves(tp)):
        assert torch.equal(got, want)
    extra = dict(jp, blocks=dict(jp["blocks"],
                                 tm=dict(jp["blocks"]["tm"], stray=np.zeros(3))))
    with pytest.raises(ValueError, match="blocks/tm/stray"):
        params_from_jax(extra, tm)
    with pytest.raises(ValueError, match="blocks/tm/stray"):
        params_from_jax(extra)
    missing = dict(jp, blocks=dict(jp["blocks"], cm={
        k: v for k, v in jp["blocks"]["cm"].items() if k != "wr"}))
    with pytest.raises(KeyError, match="blocks/cm/wr"):
        params_from_jax(missing, tm)
    bad = dict(jp, ln_fb=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="ln_fb"):
        params_from_jax(bad, tm)


# ------------------------------------------------------------------ tame
def test_port_tame_rwkv6_is_contractive():
    model, params, mu = tame_rwkv6(n_layers=4, device="cpu")
    assert model.cfg.dtype == torch.float32 and model.cfg.denoiser_latent == 16
    assert float(params["denoiser"]["out_proj"].abs().max()) > 0
    net, _ = tame_networks(model, params, mu)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 16, generator=g)
    v = torch.randn(x.shape, generator=g)
    for t in (0.95, 0.5, 0.1):
        assert jacobian_gain(net, x, t, v) < 1.0


def test_ensure_contractive_damps_rwkv6_out_proj():
    model, params, mu = tame_rwkv6(n_layers=2, out_div=0.5, device="cpu")
    before = params["denoiser"]["out_proj"].clone()
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 16, generator=g)
    report = ensure_contractive(model, params, mu, x, g, max_halvings=12)
    assert report["damped"] == "out_proj" and report["halvings"] > 0
    assert report["factor"] == 0.5 ** report["halvings"]
    assert torch.equal(params["denoiser"]["out_proj"],
                       before * report["factor"])
    assert max(report["gains"].values()) < 1.0


def test_tame_solve_matches_reference():
    """Whole SA solve (fused combine, PEC, P3C3, tau=1) of the tame smoke
    RWKV6 at a float32 stream, through the WKV-kernel route, with the
    reference's noise: the port's weights carried into the reference's
    model. 1e-4 in relative norm."""
    model, params, mu = tame_rwkv6(n_layers=2, use_kernel=True, device="cpu")
    jcfg = dataclasses.replace(j_get_smoke("rwkv6-3b"), denoiser_latent=16,
                               dtype=jnp.float32, use_pallas=True)
    jm = j_build_model(jcfg)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    j_mu = jnp.asarray(mu(64).numpy())
    jnet = lambda x, t, cond: jm.denoise(jp, x, t) + j_mu
    tnet, _ = tame_networks(model, params, mu)
    kw = dict(nfe=8, tau=1.0, combine="fused")
    js = jsamplers.make_sampler("sa", **kw)
    ts = tsamplers.make_sampler("sa", **kw)
    x_T = np.random.default_rng(2).standard_normal((2, 64, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, js.spec.n_steps)
    xis = [np.array(jax.random.normal(k, x_T.shape, jnp.float32)) for k in keys]
    ref = np.asarray(js.sample(
        JDenoiser(jnet, j_get_schedule("vp_linear"), prediction="x0"),
        jnp.asarray(x_T), key))
    before = ops.launch_counts()
    got = ts.sample(Denoiser(tnet, get_schedule("vp_linear"), prediction="x0"),
                    torch.from_numpy(x_T),
                    noise=lambda i: torch.from_numpy(xis[i]))
    assert ops.launch_counts() == before  # CPU tensors: plain versions
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= 1e-4
    assert float(np.std(ref - np.asarray(j_mu))) > 0.01  # not the anchor alone


# ----------------------------------------------------------- entry point
def test_launch_sample_rwkv6_on_cpu(capsys):
    launch_sample.main(["--arch", "rwkv6-3b", "--smoke", "--batch", "2",
                        "--seq", "64", "--nfe", "6", "--device", "cpu",
                        "--weights", "tame", "--wkv-kernel", "--combine",
                        "fused"])
    out = capsys.readouterr().out
    assert "arch=rwkv6-smoke latent=16" in out
    assert "NFE=6 (network NFE=6) (requested 6) steps=5" in out
    assert "finite=True" in out
    assert "wkv_kernel=True" in out


def test_launch_sample_refuses_a_kernel_flag_of_another_arch():
    with pytest.raises(SystemExit, match="--flash"):
        launch_sample.build_denoiser("rwkv6-3b", smoke=True, flash=True,
                                     device="cpu")
    with pytest.raises(SystemExit, match="--wkv-kernel"):
        launch_sample.build_denoiser("dit-s", smoke=True, wkv_kernel=True,
                                     device="cpu")


def test_tame_rwkv6_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tame_rwkv6()
