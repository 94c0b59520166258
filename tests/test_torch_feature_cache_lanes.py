"""Feature caching per lane in the PyTorch port against the JAX reference:
the residual policy under ``sample_batched`` (each lane refreshing on its
own residual, as the reference's vmapped solve does), feature caching
under the step protocol (a per-lane ``feats`` carry, staggered joins,
``join``/``copy``) and the serve engine under both schedulers serving
feature-cached specs and the ``draft`` tier of ``default_tiers(
feature_cache=...)``.

The model is the tame smoke DiT of ``tests/test_torch_feature_cache.py``
(4 layers, cache span (1, 3)), one request a (16, 8) latent; the
reference's draws (``split(key, M)``, one f32 normal each) go into the
port. Tolerances, relative in norm: 1e-5 against the reference and
against a lane's own solo solve (a batch of rows rounds its products
otherwise than one row alone); the step scheduler against the solve
scheduler at one lane count, bit for bit under the fused combine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Denoiser as JDenoiser
from repro.core import get_schedule as j_get_schedule
from repro.core import samplers as jsamplers
from repro.serve import ServeEngine as JServeEngine
from repro_torch.core import CachedNetwork, Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.samplers.stepwise import carry_leaves
from repro_torch.serve import ServeEngine, default_tiers
from test_torch_feature_cache import dit_pair, reference_noise
from test_torch_serve import ref_draws
from test_torch_stepwise import j_drive, t_drive

JS, TS = j_get_schedule("vp_linear"), get_schedule("vp_linear")
SHAPE = (16, 8)
RESIDUAL = ("residual", 0.05)
#: x_T scales of the four lanes: their residuals cross the threshold at
#: different steps, so the lanes refresh on different patterns
SCALES = (1.0, 0.2, 3.0, 0.05)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def models(guided=False):
    """(reference Denoiser, port Denoiser, masks) over the tame smoke DiT
    pair, with their cached companions; the port's appends the refresh
    mask of every device-flag call to ``masks``."""
    _, _, _, _, (jnet, jcached), (tnet, tcached) = dit_pair(4)
    masks = []

    def call(x, t, c, feats, refresh):
        if isinstance(refresh, torch.Tensor):
            masks.append(refresh.clone())
        return tcached.call(x, t, c, feats, refresh)

    jden = JDenoiser(jnet, JS, prediction="x0", guidance=guided,
                     cached=jcached)
    tden = Denoiser(tnet, TS, prediction="x0", guidance=guided,
                    cond_rank=2 if guided else None,
                    cached=CachedNetwork(call=call, init=tcached.init))
    return jden, tden, masks


def spec(pkg, fc, **kw):
    kw = dict(dict(tau=0.5, combine="fused", prediction="x0",
                   schedule=TS if pkg is tsamplers else JS), **kw)
    return pkg.SamplerSpec.from_nfe("sa", 9, feature_cache=fc, **kw)


def lane_inputs(K, M, seed=3):
    """x_T [K, *SHAPE] (lane k scaled by SCALES[k]), the reference's solve
    keys [K] and their draws [K, M, *SHAPE]."""
    rng = np.random.default_rng(seed)
    scales = np.array(SCALES[:K], np.float32)[:, None, None]
    x_T = (scales * rng.standard_normal((K,) + SHAPE)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), K)
    noise = np.stack([np.stack(reference_noise(k, M, SHAPE)) for k in keys])
    return x_T, keys, noise


# ------------------------------------------------------- sample_batched
@pytest.mark.parametrize("combine", ["fused", "einsum"])
def test_batched_residual_policy_matches_reference(combine):
    """The residual policy under sample_batched: every lane within 1e-5 of
    the reference's vmapped solve and of its own solo ``sample()``; the
    lanes refresh on patterns of their own (one [K] device mask a step)."""
    jden, tden, masks = models()
    jplan = jsamplers.build_plan(spec(jsamplers, RESIDUAL, combine=combine))
    tplan = tsamplers.build_plan(spec(tsamplers, RESIDUAL, combine=combine))
    M = tplan.spec.n_steps
    x_T, keys, noise = lane_inputs(4, M)
    ref = np.asarray(jsamplers.sample_batched(jplan, jden, jnp.asarray(x_T),
                                              keys))
    masks.clear()
    got = tsamplers.sample_batched(tplan, tden, torch.from_numpy(x_T),
                                   noise=torch.from_numpy(noise)).numpy()
    patterns = torch.stack(masks).T  # [K, gated steps]
    assert patterns.shape == (4, M - 1)  # step 0 refreshes by plan
    assert len({tuple(p.tolist()) for p in patterns}) > 1, patterns
    assert patterns.any() and not patterns.all()
    for k in range(4):
        assert rel(got[k], ref[k]) <= 1e-5, k
        solo = tsamplers.sample(tplan, tden, torch.from_numpy(x_T[k:k + 1]),
                                noise=torch.from_numpy(noise[k][:, None]))
        assert rel(got[k], solo[0].numpy()) <= 1e-5, k


def test_batched_residual_threshold_is_data():
    """A threshold sweep under sample_batched rides one entry and one
    graph signature; 0 refreshes every step (= interval 1) and a huge
    threshold never past the plan's step 0."""
    _, tden, masks = models()
    x_T, _, noise = lane_inputs(2, 8)
    args = (tden, torch.from_numpy(x_T))
    tsamplers.clear_compile_cache()
    outs = {}
    for th in (0.0, 0.05, 1e9):
        masks.clear()
        outs[th] = tsamplers.sample_batched(
            tsamplers.build_plan(spec(tsamplers, ("residual", th))), *args,
            noise=torch.from_numpy(noise))
        flags = torch.stack(masks)
        if th == 0.0:
            assert flags.all()
        if th == 1e9:
            assert not flags.any()
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"], stats["aot_fallbacks"]) == (
        1, 2, 0)
    (entry,) = tsamplers.base._COMPILE_CACHE.values()
    assert len(entry.runs) == 1
    every = tsamplers.sample_batched(
        tsamplers.build_plan(spec(tsamplers, 1)), *args,
        noise=torch.from_numpy(noise))
    torch.testing.assert_close(outs[0.0], every, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------- step protocol
@pytest.mark.parametrize("fc", [2, 3, RESIDUAL])
def test_stepwise_feature_cache_matches_reference(fc):
    """Feature-cached requests through the step protocol with staggered
    joins (three requests over two lanes: the third recycles the lane the
    first freed, whose features it zeroes at join): each within
    1e-5 of the reference's stepwise drive and of its vmapped whole solve,
    and of the port's sample_batched."""
    jden, tden, masks = models()
    jplan = jsamplers.build_plan(spec(jsamplers, fc))
    tplan = tsamplers.build_plan(spec(tsamplers, fc))
    M = tplan.spec.n_steps
    x_T, keys, noise = lane_inputs(3, M)
    stagger = [0, 2, M + 2]  # the third joins the lane the first freed
    got, steps, _ = t_drive(tplan, torch.from_numpy(x_T),
                            torch.from_numpy(noise), model=tden, lanes=2,
                            stagger=stagger, shape=SHAPE)
    assert steps == [M] * 3
    jgot, _, _ = j_drive(jplan, jnp.asarray(x_T), keys, model=jden, lanes=2,
                         stagger=stagger, shape=SHAPE)
    whole = np.asarray(jsamplers.sample_batched(jplan, jden,
                                                jnp.asarray(x_T), keys))
    batched = tsamplers.sample_batched(tplan, tden, torch.from_numpy(x_T),
                                       noise=torch.from_numpy(noise))
    for b in range(3):
        assert rel(got[b], jgot[b]) <= 1e-5, b
        assert rel(got[b], whole[b]) <= 1e-5, b
        assert rel(got[b], batched[b]) <= 1e-5, b


def test_tick_refreshes_active_lanes_only():
    """A tick's refresh mask holds active lanes only: free lanes (step
    index -1) never refresh, and a tick with no refreshing lane skips the
    deep segment. Under interval 2 one lane's ticks refresh at init and at
    every second step."""
    _, tden, masks = models()
    tplan = tsamplers.build_plan(spec(tsamplers, 2))
    M = tplan.spec.n_steps
    x_T, _, noise = lane_inputs(1, M)
    masks.clear()
    stepped = []
    t_drive(tplan, torch.from_numpy(x_T), torch.from_numpy(noise),
            model=tden, lanes=3, shape=SHAPE,
            after_tick=lambda c, aux: stepped.append(aux["stepped"].clone()))
    masks = torch.stack(masks)  # the tick's first call, [ticks, 3]
    assert masks.shape == (M + 1, 3) and not masks[:, 1:].any()
    assert not torch.stack(stepped)[:, 1:].any()
    assert masks[:, 0].tolist() == [True] + [
        r for r in tplan.arrays["fc_refresh"]]


def test_join_zeroes_and_copy_moves_features():
    """``join`` zeroes the lane's features (its init tick refreshes them
    before any reuse), ``copy`` moves them with the rest of the lane, and
    a tick writes them for its refreshing lanes only."""
    _, tden, masks = models()
    plan = tsamplers.build_plan(spec(tsamplers, RESIDUAL))
    fns = tsamplers.make_stepfns(plan, tden, SHAPE, torch.float32, 3,
                                 device="cpu")
    arrays = fns.adapter.arrays(plan, torch.device("cpu"))
    src = tsamplers.fresh_carry(plan, 3, SHAPE, torch.float32, model_fn=tden,
                                device="cpu")
    dst = tsamplers.fresh_carry(plan, 3, SHAPE, torch.float32, model_fn=tden,
                                device="cpu")
    assert src["feats"].shape == (3, 1, 16, 64)
    g = torch.Generator().manual_seed(5)
    for lane in (0, 1):
        fns.join(arrays, src, lane, torch.randn(SHAPE, generator=g), g,
                 0.0, 0, 1.0)
    fns.step(arrays, src)  # both init ticks refresh; lane 2 is free
    assert src["feats"][0].abs().max() > 0 and src["feats"][1].abs().max() > 0
    assert not src["feats"][2].any()
    before = {k: v.clone() for k, v in carry_leaves(dst)}
    fns.copy(dst, src, 2, 1)
    assert torch.equal(dst["feats"][2], src["feats"][1])
    assert torch.equal(dst["feats"][:2], before[("feats",)][:2])
    fns.join(arrays, src, 1, torch.randn(SHAPE, generator=g), g, 0.0, 0, 1.0)
    assert not src["feats"][1].any() and src["feats"][0].abs().max() > 0


def test_step_cache_keys_on_the_features_shape():
    """Interval and residual specs of one step count share a step
    function (their difference is table data); the features' shape keys
    the entry (a guided Denoiser doubles it)."""
    _, tden, masks = models()
    _, gden, _ = models(guided=True)
    tsamplers.clear_stepwise_cache()
    for fc in (2, 3, RESIDUAL):
        plan = tsamplers.build_plan(spec(tsamplers, fc))
        tsamplers.make_stepfns(plan, tden, SHAPE, torch.float32, 2,
                               device="cpu")
    stats = tsamplers.stepwise_cache_stats()
    assert (stats["misses"], stats["hits"]) == (1, 2)
    gplan = tsamplers.build_plan(spec(tsamplers, 2, guidance=True))
    fns = tsamplers.make_stepfns(gplan, gden, SHAPE, torch.float32, 2,
                                 cond=torch.zeros(SHAPE), device="cpu")
    assert fns.key[-1] == ((2, 16, 64), torch.float32)
    assert tsamplers.stepwise_cache_stats()["misses"] == 2


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("scheduler", ["solve", "step"])
@pytest.mark.parametrize("fc", [2, RESIDUAL])
def test_engine_serves_feature_cache_like_reference_and_solo(scheduler, fc):
    """Feature-cached requests served on the reference's draws (five over
    four lanes: a ragged tail or a recycled lane): each within 1e-5 of the
    reference engine's and of its own solo ``sample()``."""
    jden, tden, masks = models()
    tspec = spec(tsamplers, fc)
    kw = {"scheduler": scheduler, "lanes": 4} if scheduler == "step" else {}
    eng = ServeEngine(tden, bucket_sizes=(1, 2, 4), draws=ref_draws,
                      device="cpu", **kw)
    jeng = JServeEngine(jden, bucket_sizes=(1, 2, 4), **kw)
    for rid in range(5):
        eng.submit(tspec, SHAPE, rid=rid)
        jeng.submit(spec(jsamplers, fc), SHAPE, rid=rid)
    got = {res.rid: res for res in eng.run()}
    ref = {res.rid: res for res in jeng.run()}
    M = tspec.n_steps
    prior = TS.prior_scale(float(tsamplers.build_plan(tspec).ts[0]))
    for r in range(5):
        assert got[r].status == ref[r].status == "ok"
        assert rel(got[r].x0, ref[r].x0) <= 1e-5, r
        z, noise = ref_draws(r, 0, SHAPE, M)
        solo = tsamplers.sample(tsamplers.build_plan(tspec), tden,
                                prior * torch.from_numpy(z)[None],
                                noise=torch.from_numpy(noise)[:, None])
        assert rel(got[r].x0, solo[0]) <= 1e-5, r


def test_guided_residual_served_like_reference():
    """Guided requests with their own prompt and scale under the residual
    policy, step scheduler (the features carry each lane's conditional
    and null rows): within 1e-5 of the reference engine's."""
    jden, tden, _ = models(guided=True)
    tspec = spec(tsamplers, RESIDUAL, guidance=True)
    eng = ServeEngine(tden, scheduler="step", lanes=4, draws=ref_draws,
                      device="cpu")
    jeng = JServeEngine(jden, scheduler="step", lanes=4)
    rng = np.random.default_rng(6)
    for rid, s in enumerate((1.0, 1.5, 4.0)):
        c = (0.3 * rng.standard_normal(SHAPE)).astype(np.float32)
        eng.submit(tspec, SHAPE, rid=rid, cond=torch.from_numpy(c),
                   guidance_scale=s)
        jeng.submit(spec(jsamplers, RESIDUAL, guidance=True), SHAPE,
                    rid=rid, cond=jnp.asarray(c), guidance_scale=s)
    got = {res.rid: res.x0 for res in eng.run()}
    ref = {res.rid: res.x0 for res in jeng.run()}
    for r in range(3):
        assert rel(got[r], ref[r]) <= 1e-5, r


@pytest.mark.parametrize("fc", [2, RESIDUAL])
def test_draft_tier_with_feature_cache_under_both_schedulers(fc):
    """The ``draft`` tier of ``default_tiers(feature_cache=...)`` is served
    by both schedulers: at one lane count the step scheduler's results are
    the solve scheduler's bit for bit, through a staggered arrival and a
    lane migration (an early exit frees a lane that the second batch's
    request moves into)."""
    _, tden, masks = models()
    tiers = default_tiers(feature_cache=fc, prediction="x0",
                          combine="fused")
    assert tiers.resolve("draft").feature_cache == fc
    solve = ServeEngine(tden, bucket_sizes=(3,), tiers=tiers, device="cpu")
    for rid in range(4):
        solve.submit(None, SHAPE, rid=rid, quality_tier="draft")
    ref = {res.rid: res.x0 for res in solve.run()}
    step = ServeEngine(tden, scheduler="step", lanes=3, tiers=tiers,
                       device="cpu")
    step.submit(None, SHAPE, rid=0, quality_tier="draft",
                early_exit_tol=1e3, min_steps=1)
    for rid in (1, 2, 3):
        step.submit(None, SHAPE, rid=rid, quality_tier="draft")
    out = {res.rid: res for res in step.run()}
    assert step.stats()["migrations"] >= 1 and out[0].n_steps == 1
    for rid in (1, 2, 3):
        assert out[rid].status == "ok"
        assert torch.equal(out[rid].x0, ref[rid]), rid
