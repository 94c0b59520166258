"""DeepCache-style feature caching in the PyTorch port against the JAX
reference: ``fc_policy`` and its refusals, the plan's ``fc_refresh`` /
``fc_thresh``, ``TransformerLM.denoise_cached`` refresh and reuse, and
whole cached solves (interval 1, 2, 3, the residual policy, and guided +
cached) on the tame smoke DiT, with the reference's per-step draws
(``split(key, M)``, one f32 normal each) injected into the port.

Tolerances: single evaluations 1e-5; whole solves 1e-5 in relative norm
at f32, the reference's bf16 bar of 1e-2 under the bf16 policy; a cached
solve stays within the reference's own 0.05 of the uncached one.
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
from repro.core.programs import program_preset as j_program_preset
from repro.models.tame import tame_dit as j_tame_dit
from repro.models.tame import tame_networks as j_tame_networks
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import CachedNetwork, Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.programs import program_preset
from repro_torch.core.samplers import SamplerSpec, build_plan
from repro_torch.core.samplers import multistep
from repro_torch.core.samplers.multistep import fc_policy
from repro_torch.launch import sample as launch_sample
from repro_torch.models import TransformerLM
from repro_torch.models.tame import tame_networks

JS, TS = j_get_schedule("vp_linear"), get_schedule("vp_linear")
SHAPE = (2, 16, 8)


def dit_pair(n_layers=4):
    """The reference's tame smoke DiT and the port's model with the
    converted parameters, and both packages' (network, cached) pairs."""
    jmodel, jparams, mu = j_tame_dit("dit-s", n_layers=n_layers)
    tmodel = TransformerLM(dataclasses.replace(
        get_smoke("dit-s"), n_layers=n_layers, dtype=torch.float32))
    tparams = params_from_jax(jax.device_get(jparams), tmodel)
    jnets = j_tame_networks(jmodel, jparams, mu)
    tnets = tame_networks(tmodel, tparams,
                          lambda seq: torch.from_numpy(np.array(mu(seq))))
    return jmodel, jparams, tmodel, tparams, jnets, tnets


def reference_noise(key, M, shape):
    keys = jax.random.split(key, M)
    return [np.array(jax.random.normal(keys[i], shape, jnp.float32))
            for i in range(M)]


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------ policy and plan
@pytest.mark.parametrize("fc,want", [
    (None, None), (1, ("interval", 1)), (3, ("interval", 3)),
    (("residual", 0.05), ("residual", 0.05))])
def test_fc_policy_normalizes_like_the_reference(fc, want):
    spec = SamplerSpec(n_steps=6, feature_cache=fc)
    assert fc_policy(spec) == want
    assert fc_policy(spec) == jsamplers.multistep.fc_policy(
        jsamplers.SamplerSpec(n_steps=6, feature_cache=fc))


@pytest.mark.parametrize("bad,match", [
    (dict(feature_cache=0), "interval must be >= 1"),
    (dict(feature_cache=True), "expected None"),
    (dict(feature_cache="yes"), "expected None"),
    (dict(feature_cache=2, history="concat"), "history='ring'"),
    (dict(corrector_order=0, feature_cache=("residual", 0.05)),
     "corrector_order > 0"),
    (dict(feature_cache=2, program="constant"), "step programs"),
])
def test_feature_cache_refusals_match_the_reference(bad, match):
    """Mirrors tests/test_e2e_dit.py's spec validation: the port refuses
    what the reference refuses, with the same message, before planning."""
    def spec(pkg, preset):
        kw = dict(bad)
        if "program" in kw:
            kw["program"] = preset(kw["program"], 8)
        return pkg.SamplerSpec.from_nfe("sa", 9, **kw)

    with pytest.raises(ValueError, match=match):
        jsamplers.build_plan(spec(jsamplers, j_program_preset))
    with pytest.raises(ValueError, match=match):
        build_plan(spec(tsamplers, program_preset))


@pytest.mark.parametrize("nfe", [9, 20])
@pytest.mark.parametrize("fc", [1, 2, 3, ("residual", 0.07)])
def test_fc_plan_arrays_match_the_reference(nfe, fc):
    jplan = jsamplers.build_plan(jsamplers.SamplerSpec.from_nfe(
        "sa", nfe, tau=0.4, feature_cache=fc))
    plan = build_plan(SamplerSpec.from_nfe("sa", nfe, tau=0.4,
                                           feature_cache=fc))
    refresh = plan.arrays["fc_refresh"]
    assert isinstance(refresh, tuple)  # host data: no device read a step
    assert refresh == tuple(bool(r) for r in
                            np.asarray(jplan.arrays["fc_refresh"]))
    thresh = float(np.asarray(jplan.arrays["fc_thresh"]))
    assert plan.arrays["fc_thresh"] == thresh
    dev = plan.arrays_on("cpu")
    assert dev["fc_refresh"] is refresh
    if isinstance(fc, int):
        assert sum(refresh) == len(refresh) // fc


def test_feature_cache_needs_a_cached_denoiser():
    s = tsamplers.make_sampler("sa", nfe=6, feature_cache=2)
    _, _, _, _, _, (tnet, _) = dit_pair(2)
    with pytest.raises(ValueError, match="cached="):
        s.sample(Denoiser(tnet, TS, prediction="x0"), torch.zeros(SHAPE))
    with pytest.raises(ValueError, match="cached="):
        s.sample(lambda x, t: x, torch.zeros(SHAPE))


def test_cached_statics_differ_only_in_the_cache_flag():
    plain = build_plan(SamplerSpec.from_nfe("sa", 9)).statics
    cached = [build_plan(SamplerSpec.from_nfe("sa", 9, feature_cache=fc))
              .statics for fc in (2, 3, ("residual", 0.1))]
    assert cached[0] == cached[1] == cached[2]
    assert cached[0][:-1] == plain[:-1] and (plain[-1], cached[0][-1]) == (
        False, True)


# ------------------------------------------------- the cached backbone
def test_denoise_cached_refresh_and_reuse_match_reference():
    """Mirrors tests/test_e2e_dit.py's exactness test: refresh recomputes
    every block (= denoise), reuse at the same input replays the middle
    span from the cached residual, and passes the features through."""
    jmodel, jparams, tmodel, tparams, _, _ = dit_pair()
    z = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    zt = torch.from_numpy(z)
    shape, dtype = tmodel.feature_shape(*SHAPE[:2])
    aval = jmodel.feature_shape(*SHAPE[:2])
    assert shape == tuple(aval.shape) and dtype == torch.float32
    assert tmodel.cache_span() == jmodel.cache_span() == (1, 3)
    full = tmodel.denoise(tparams, zt, 0.5)
    out, feats = tmodel.denoise_cached(tparams, zt, 0.5,
                                       feats=torch.zeros(shape),
                                       refresh=True)
    torch.testing.assert_close(out, full, atol=1e-6, rtol=1e-6)
    assert float(feats.abs().max()) > 0
    jout, jfeats = jmodel.denoise_cached(jparams, jnp.asarray(z), 0.5,
                                         feats=jnp.zeros(aval.shape),
                                         refresh=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=1e-5,
                               rtol=1e-5)
    out_c, feats_c = tmodel.denoise_cached(tparams, zt, 0.5, feats=feats,
                                           refresh=False)
    torch.testing.assert_close(out_c, full, atol=1e-5, rtol=1e-5)
    assert feats_c is feats, "a reuse must pass the features through"
    # reuse at another input against the reference's, on the same features
    z2 = z + 0.1 * np.random.default_rng(3).standard_normal(SHAPE).astype(
        np.float32)
    jout2, _ = jmodel.denoise_cached(jparams, jnp.asarray(z2), 0.3,
                                     feats=jfeats, refresh=False)
    out2, _ = tmodel.denoise_cached(tparams, torch.from_numpy(z2), 0.3,
                                    feats=feats, refresh=False)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout2), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("span", [(0, 4), (2, 2), (0, 0), (4, 4), (1, 3)])
def test_denoise_cached_spans(span):
    """Any [a, b) span refreshes to ``denoise``; an empty one caches zero
    residual."""
    _, _, tmodel, tparams, _, _ = dit_pair()
    zt = torch.from_numpy(np.random.default_rng(4).standard_normal(
        SHAPE).astype(np.float32))
    shape, _ = tmodel.feature_shape(*SHAPE[:2])
    out, feats = tmodel.denoise_cached(tparams, zt, 0.7,
                                       feats=torch.zeros(shape),
                                       refresh=True, span=span)
    torch.testing.assert_close(out, tmodel.denoise(tparams, zt, 0.7),
                               atol=1e-6, rtol=1e-6)
    assert (float(feats.abs().max()) == 0) == (span[0] == span[1])
    with pytest.raises(ValueError, match="bad cache span"):
        tmodel.denoise_cached(tparams, zt, 0.7, feats=feats, refresh=True,
                              span=(3, 5))


@pytest.mark.parametrize("flag", [True, False])
def test_denoise_cached_device_flag_is_the_bool_path(flag):
    """A 0-d bool tensor refreshes (or reuses) exactly as the Python bool
    does, bit for bit, and writes the refreshed features into the given
    buffer in place."""
    _, _, tmodel, tparams, _, _ = dit_pair()
    rng = np.random.default_rng(10)
    z0, z = (torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
             for _ in range(2))
    shape, _ = tmodel.feature_shape(*SHAPE[:2])
    _, feats0 = tmodel.denoise_cached(tparams, z0, 0.6,
                                      feats=torch.zeros(shape), refresh=True)
    ref, ref_feats = tmodel.denoise_cached(tparams, z, 0.4,
                                           feats=feats0.clone(),
                                           refresh=flag)
    buf = feats0.clone()
    out, got = tmodel.denoise_cached(tparams, z, 0.4, feats=buf,
                                     refresh=torch.tensor(flag))
    assert got is buf
    assert torch.equal(out, ref) and torch.equal(got, ref_feats)
    assert torch.equal(got, feats0) != flag


def test_denoise_cached_row_flags_equal_per_row_calls(monkeypatch):
    """A [B] mask refreshes its rows and reuses the others: each row equals
    that row's own bool call (1e-6), the refreshed rows' features are
    written in place, and an all-False mask skips the deep segment (the
    CPU decides with a Python branch)."""
    _, _, tmodel, tparams, _, _ = dit_pair()
    B = 3
    rng = np.random.default_rng(11)
    z0, z = (torch.from_numpy(rng.standard_normal(
        (B,) + SHAPE[1:]).astype(np.float32)) for _ in range(2))
    shape, _ = tmodel.feature_shape(B, SHAPE[1])
    _, feats0 = tmodel.denoise_cached(tparams, z0, 0.6,
                                      feats=torch.zeros(shape), refresh=True)
    mask = torch.tensor([True, False, True])
    buf = feats0.clone()
    out, got = tmodel.denoise_cached(tparams, z, 0.4, feats=buf,
                                     refresh=mask)
    assert got is buf
    for r in range(B):
        ref, ref_feats = tmodel.denoise_cached(
            tparams, z[r:r + 1], 0.4, feats=feats0[r:r + 1].clone(),
            refresh=bool(mask[r]))
        torch.testing.assert_close(out[r:r + 1], ref, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(got[r:r + 1], ref_feats, atol=1e-6,
                                   rtol=1e-6)
    assert torch.equal(got[1], feats0[1])
    blocks = []
    block = tmodel._block
    monkeypatch.setattr(tmodel, "_block",
                        lambda p, x, tc: blocks.append(1) or block(p, x, tc))
    tmodel.denoise_cached(tparams, z, 0.4, feats=feats0.clone(),
                          refresh=torch.zeros(B, dtype=torch.bool))
    assert len(blocks) == 2  # span (1, 3) of 4: blocks 0 and 3 only
    with pytest.raises(ValueError, match="one flag per row"):
        tmodel.denoise_cached(tparams, z, 0.4, feats=feats0.clone(),
                              refresh=torch.ones(B + 1, dtype=torch.bool))


# ------------------------------------------------------- cached solves
def solve_pair(fc, *, guided=False, precision="f32", combine="fused",
               mode="PEC", nfe=9, n_layers=4, seed=5):
    """(reference output, port output) of one SA solve of the tame smoke
    DiT, same x_T and noise; ``guided`` adds a shared (seq, dz) prompt
    under CFG scale 2.0."""
    _, _, _, _, (jnet, jcached), (tnet, tcached) = dit_pair(n_layers)
    kw = dict(nfe=nfe, tau=0.5, combine=combine, mode=mode,
              precision=precision, prediction="x0", guidance=guided,
              feature_cache=fc)
    js, ts = (jsamplers.make_sampler("sa", **kw),
              tsamplers.make_sampler("sa", **kw))
    rng = np.random.default_rng(seed)
    x_T = rng.standard_normal(SHAPE).astype(np.float32)
    cond = 0.3 * rng.standard_normal(SHAPE[1:]).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    xis = reference_noise(key, js.spec.n_steps, SHAPE)
    extra = dict(guidance_scale=2.0) if guided else {}
    ref = np.asarray(js.sample(
        JDenoiser(jnet, JS, prediction="x0", guidance=guided,
                  cached=jcached),
        jnp.asarray(x_T), key, cond=jnp.asarray(cond) if guided else None,
        **extra), np.float32)
    got = ts.sample(
        Denoiser(tnet, TS, prediction="x0", guidance=guided,
                 cached=tcached),
        torch.from_numpy(x_T), noise=lambda i: torch.from_numpy(xis[i]),
        cond=torch.from_numpy(cond) if guided else None, **extra)
    return ref, got.float().numpy()


@pytest.mark.parametrize("fc", [2, 3, ("residual", 0.05)])
@pytest.mark.parametrize("combine", ["fused", "einsum"])
def test_cached_solve_matches_reference(fc, combine):
    ref, got = solve_pair(fc, combine=combine)
    assert rel(got, ref) <= 1e-5


@pytest.mark.parametrize("fc", [2, ("residual", 0.05)])
def test_cached_pece_solve_matches_reference(fc):
    """PECE re-evaluations reuse their step's features."""
    ref, got = solve_pair(fc, mode="PECE")
    assert rel(got, ref) <= 1e-5


def test_cached_bf16_solve_matches_reference():
    ref, got = solve_pair(2, precision="bf16")
    assert rel(got, ref) <= 1e-2


@pytest.mark.parametrize("fc", [2, ("residual", 0.05)])
def test_guided_cached_solve_matches_reference(fc):
    """The features carry the doubled batch of the one-call CFG."""
    ref, got = solve_pair(fc, guided=True)
    assert rel(got, ref) <= 1e-5


def port_solve(den, fc, x_T, nfe=9, guided=False, cond=None, seed=6):
    s = tsamplers.make_sampler("sa", nfe=nfe, tau=0.5, combine="fused",
                               prediction="x0", guidance=guided,
                               feature_cache=fc)
    g = torch.Generator().manual_seed(seed)
    xis = [torch.randn(x_T.shape, generator=g) for _ in range(s.spec.n_steps)]
    return s.sample(den, x_T, noise=lambda i: xis[i], cond=cond,
                    guidance_scale=2.0 if guided else 1.0)


def test_interval_one_equals_uncached():
    """k = 1 refreshes every step: the cached executor is the plain one
    (the reference's bar: 1e-5)."""
    _, _, _, _, _, (tnet, tcached) = dit_pair()
    den = Denoiser(tnet, TS, prediction="x0", cached=tcached)
    x_T = torch.from_numpy(np.random.default_rng(7).standard_normal(
        SHAPE).astype(np.float32))
    out = port_solve(den, 1, x_T)
    ref = port_solve(den, None, x_T)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fc", [2, 3, ("residual", 0.05)])
def test_cached_solve_stays_near_uncached(fc):
    """Mirrors tests/test_e2e_dit.py's bounded-quality test: the cache
    really skips work (output != uncached) and stays within 0.05."""
    _, _, _, _, _, (tnet, tcached) = dit_pair(8)
    den = Denoiser(tnet, TS, prediction="x0", cached=tcached)
    x_T = torch.from_numpy(np.random.default_rng(8).standard_normal(
        SHAPE).astype(np.float32))
    out = port_solve(den, fc, x_T)
    ref = port_solve(den, None, x_T)
    assert 0.0 < rel(out.numpy(), ref.numpy()) < 0.05


@pytest.mark.parametrize("fc,refreshing", [(1, 8), (2, 4), (3, 2)])
@pytest.mark.parametrize("guided", [False, True])
def test_block_evaluations_follow_the_plan(monkeypatch, fc, refreshing,
                                           guided):
    """Per 9-NFE PEC solve (8 steps) of a 4-layer DiT with span (1, 3):
    4 blocks for the init evaluation, 4 for each refreshing step and 2 for
    each reusing one, at the doubled batch under guidance; the card's
    flash launch count is the same formula at 28 layers."""
    _, _, tmodel, tparams, _, _ = dit_pair()
    batches = []
    block = tmodel._block

    def counted(p, x, tcond):
        batches.append(x.shape[0])
        return block(p, x, tcond)

    monkeypatch.setattr(tmodel, "_block", counted)
    tnet, tcached = tame_networks(tmodel, tparams,
                                  lambda seq: torch.zeros(seq, SHAPE[2]))
    den = Denoiser(tnet, TS, prediction="x0", guidance=guided,
                   cached=tcached)
    x_T = torch.zeros(SHAPE)
    port_solve(den, fc, x_T, guided=guided,
               cond=torch.zeros(SHAPE[1:]) if guided else None)
    assert len(batches) == 4 + 4 * refreshing + 2 * (8 - refreshing)
    assert set(batches) == {2 * SHAPE[0] if guided else SHAPE[0]}


def test_residual_policy_refreshes_on_the_residual(monkeypatch):
    """A zero threshold refreshes every step (= interval 1); a huge one
    only the planned step 0; the interval policy never computes the
    residual, so it reads nothing back from the device."""
    _, _, _, _, _, (tnet, tcached) = dit_pair()
    refreshes = []

    def call(x, t, cond, feats, refresh):
        refreshes.append(bool(refresh))
        return tcached.call(x, t, cond, feats, refresh)

    den = Denoiser(tnet, TS, prediction="x0",
                   cached=CachedNetwork(call=call, init=tcached.init))
    x_T = torch.from_numpy(np.random.default_rng(9).standard_normal(
        SHAPE).astype(np.float32))
    out0 = port_solve(den, ("residual", 0.0), x_T)
    assert refreshes == [True] * 9
    torch.testing.assert_close(out0, port_solve(den, 1, x_T), atol=1e-6,
                               rtol=1e-6)
    refreshes.clear()
    port_solve(den, ("residual", 1e9), x_T)
    assert refreshes == [True, True] + [False] * 7
    monkeypatch.setattr(multistep, "_pc_residual", None)  # must not run
    refreshes.clear()
    port_solve(den, 2, x_T)
    assert refreshes == [True] + [i % 2 == 1 for i in range(8)]


# ------------------------------------------------------------ driver
@pytest.mark.parametrize("fc", ["2", "residual:0.05"])
def test_sample_driver_feature_cache_end_to_end(capsys, fc):
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", "16", "--nfe", "9", "--device", "cpu",
                        "--weights", "tame", "--combine", "fused",
                        "--feature-cache", fc, "--guidance-scale", "1.5"])
    out = capsys.readouterr().out
    want = launch_sample.parse_feature_cache(fc)
    assert f"feature_cache={want}" in out and "finite=True" in out
    assert "NFE=9 (network NFE=18)" in out


def test_sample_driver_refuses_feature_cache_on_rwkv6():
    assert launch_sample.parse_feature_cache("3") == 3
    assert launch_sample.parse_feature_cache("residual:0.1") == (
        "residual", 0.1)
    with pytest.raises(SystemExit, match="denoise_cached"):
        launch_sample.main(["--arch", "rwkv6-3b", "--smoke", "--batch", "2",
                            "--seq", "16", "--nfe", "6", "--device", "cpu",
                            "--feature-cache", "2"])
