"""The port's serve engine (``repro_torch.serve``) against the JAX
reference's ``repro.serve``.

Mirrors ``tests/test_serve.py``: bucket grouping by (spec, shape, dtype,
cond); masked ragged tails (a padded microbatch returns every real
request's solo-solve bytes); per-request seeds stable under re-bucketing;
honest throughput accounting; warmup and the zero-miss cache contract
across tau sweeps; the engine as sugar over ``sample_batched``; and the
step scheduler (joins, lane recycling, early exit, migration, stream
order, zero step-cache misses across churn, priority/deadline/admission,
occupancy), against the solve scheduler.

Against the reference: the port's engine takes the reference's own
``fold_in`` draws through its ``draws`` hook (initial noise from
``fold_in(PRNGKey(7), rid)``, step noise from ``split(fold_in(PRNGKey(8),
rid), M)``), and each result is held at 1e-5 relative in norm against the
reference engine's, under both schedulers, guided with per-request cond
and scales too. The model is the fusion-stable ``0.3 x cos(t)``,
lane-batched in the port.

The port's own contracts hold bitwise on the CPU within one batch shape
(ragged vs solo, re-composed buckets) and between the schedulers under the
elementwise ``fused`` combine; across bucket sizes the reference itself
allows 2e-5. The reference's mesh tests (``test_serve.py:112`` and
``:231-312``: ``align_bucket_sizes``, the one-device and 8-device meshes,
``sample_sharded``) are mirrored in ``tests/test_torch_sharding.py``; this
file holds only the engine's mesh refusals.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import Denoiser as JDenoiser
    from repro.core import get_schedule as j_get_schedule
    from repro.core import samplers as jsamplers
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve import form_microbatches as j_form_microbatches
    from repro.serve import Request as JRequest
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.denoiser import lane_view
from repro_torch.serve import (PAD_RID, Request, ServeEngine, choose_bucket,
                               fold_keys, form_microbatches, request_draws)

TS = get_schedule("vp_linear")
SPEC = tsamplers.SamplerSpec(name="sa", schedule=TS, n_steps=6, tau=0.7)
SHAPE = (64, 2)
SPEC_A = tsamplers.SamplerSpec(name="sa", schedule=TS, n_steps=8,
                               mode="PECE", tau=0.7, combine="fused")
SPEC_B = tsamplers.SamplerSpec(name="sa", schedule=TS, n_steps=6, tau=0.4,
                               combine="fused")
if jax is not None:
    JS = j_get_schedule("vp_linear")


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def STABLE(x, t):
    """Lane-batched fusion-stable model: one t per lane."""
    return 0.3 * x * lane_view(torch.cos(t), x)


def j_stable(x, t):
    return 0.3 * x * jnp.cos(t)


def engine(model=STABLE, **kw):
    return ServeEngine(model, device="cpu", **kw)


def step_engine(**kw):
    kw.setdefault("scheduler", "step")
    kw.setdefault("lanes", 4)
    return engine(**kw)


def serve_rids(eng, rids, spec=SPEC, shape=SHAPE, **kw):
    for r in rids:
        eng.submit(spec, shape, rid=r, **kw)
    return {res.rid: res.x0 for res in eng.run()}


def ref_draws(rid, attempt, shape, M):
    """The reference engine's draws of one request (both schedulers):
    unit normal from ``fold_in(PRNGKey(7), rid)`` and the M step normals
    from ``split(fold_in(PRNGKey(8), rid), M)``, the attempt folded in."""
    nk = jax.random.fold_in(jax.random.PRNGKey(7), rid)
    sk = jax.random.fold_in(jax.random.PRNGKey(8), rid)
    if attempt:
        nk = jax.random.fold_in(nk, attempt)
        sk = jax.random.fold_in(sk, attempt)
    z = jax.random.normal(nk, tuple(shape), jnp.float32)
    noise = jax.vmap(lambda k: jax.random.normal(k, tuple(shape),
                                                 jnp.float32))(
        jax.random.split(sk, M))
    return np.array(z), np.array(noise)


def j_spec(spec):
    """The reference's SamplerSpec with the port spec's fields."""
    fields = {k: getattr(spec, k) for k in ("n_steps", "tau", "mode",
                                            "combine", "guidance",
                                            "prediction")}
    return jsamplers.SamplerSpec(name=spec.name, schedule=JS, **fields)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# --------------------------------------------------------- bucket grouping
def test_microbatches_group_by_spec_and_shape(reference):
    def reqs(req_cls, spec):
        return [req_cls(0, spec, (64, 2)),
                req_cls(1, spec.replace(tau=0.2), (64, 2)),
                req_cls(2, spec, (64, 2)),
                req_cls(3, spec, (32, 2)),
                req_cls(4, spec, (64, 2))]
    mbs = form_microbatches(reqs(Request, SPEC), bucket_sizes=(4,))
    jmbs = j_form_microbatches(reqs(JRequest, j_spec(SPEC)), bucket_sizes=(4,))
    assert [[r.rid for r in mb.requests] for mb in mbs] == \
        [[r.rid for r in mb.requests] for mb in jmbs] == [[0, 2, 4], [1], [3]]
    assert all(mb.size == 4 for mb in mbs)
    assert mbs[0].rids() == jmbs[0].rids() == [0, 2, 4, PAD_RID]


def test_fifo_chunking_and_tail_takes_smallest_bucket():
    reqs = [Request(i, SPEC, SHAPE) for i in range(11)]
    mbs = form_microbatches(reqs, bucket_sizes=(1, 2, 4, 8))
    assert [(len(mb.requests), mb.size) for mb in mbs] == [(8, 8), (3, 4)]
    assert mbs[1].n_padded == 1


def test_choose_bucket():
    assert choose_bucket(3, (1, 2, 4, 8)) == 4
    assert choose_bucket(8, (1, 2, 4, 8)) == 8
    assert choose_bucket(9, (2, 4)) == 4  # callers chunk to max first
    with pytest.raises(ValueError):
        choose_bucket(0, (1,))


def test_long_seq_shapes_bucket_and_serve():
    """Long non-square latents ((frames, dz)): shape is part of the bucket
    key, and a padded long-seq microbatch returns each request's solo
    bytes."""
    reqs = [Request(0, SPEC, (1500, 4)), Request(1, SPEC, (750, 8)),
            Request(2, SPEC, (1500, 4)), Request(3, SPEC, (1500, 4))]
    mbs = form_microbatches(reqs, bucket_sizes=(2,))
    assert [[r.rid for r in mb.requests] for mb in mbs] == [[0, 2], [3], [1]]
    assert mbs[1].rids() == [3, PAD_RID]

    def model(x, t):
        return 0.97 * x
    tsamplers.clear_compile_cache()
    eng = engine(model, bucket_sizes=(2,))
    for rid, shape in [(0, (1500, 4)), (1, (750, 8)), (2, (1500, 4))]:
        eng.submit(SPEC, shape, rid=rid)
    got = {res.rid: res.x0 for res in eng.run()}
    assert got[0].shape == (1500, 4) and got[1].shape == (750, 8)
    solo = engine(model, bucket_sizes=(2,))
    solo.submit(SPEC, (1500, 4), rid=2)
    (res,) = solo.run()
    assert torch.equal(got[2], res.x0)
    assert tsamplers.compile_cache_stats()["misses"] == 2


# -------------------------------------------- masked ragged tails + RNG
def test_ragged_batch_bitwise_equal_to_solo_solves():
    """A padded ragged microbatch returns, for every real request, exactly
    the bytes of its solo solve at that bucket size: padding is masked
    lanes, and lanes are independent. Every serve reuses one entry."""
    tsamplers.clear_compile_cache()
    eng = engine(bucket_sizes=(4,))
    ragged = serve_rids(eng, [0, 1, 2])
    assert eng.stats()["padded_slots"] == 1
    for r in (0, 1, 2):
        solo = serve_rids(eng, [r])
        assert torch.equal(ragged[r], solo[r]), f"rid {r} diverged"
    assert tsamplers.compile_cache_stats()["misses"] == 1


def test_same_bucket_recomposition_is_bitwise_stable():
    eng = engine(bucket_sizes=(4,))
    a = serve_rids(eng, [0, 1, 2, 3])
    b = serve_rids(eng, [2, 7, 0, 9])
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def test_rng_stable_under_rebucketing():
    """A rid's seeds do not depend on its bucket: the same rid through
    other bucket configs gives the same sample (to the reference's 2e-5
    across batch sizes), and the seed derivation is position-free."""
    rids = list(range(5))
    outs = [serve_rids(engine(bucket_sizes=bs), rids)
            for bs in ((2,), (8,), (1, 2, 4))]
    for r in rids:
        for other in outs[1:]:
            np.testing.assert_allclose(outs[0][r], other[r], rtol=2e-5,
                                       atol=2e-5)
    assert fold_keys(7, [3, PAD_RID])[0] == fold_keys(7, [0, 1, 2, 3])[3]
    z1, n1 = request_draws(7, 8, 3, 0, SHAPE, 6, "cpu")
    z2, n2 = request_draws(7, 8, 3, 0, SHAPE, 6, "cpu")
    assert torch.equal(z1, z2) and torch.equal(n1, n2)
    z3, n3 = request_draws(7, 8, 3, 1, SHAPE, 6, "cpu")
    assert not torch.equal(z1, z3) and not torch.equal(n1, n3)


def test_no_duplicate_outputs_and_honest_accounting():
    eng = engine(bucket_sizes=(4,))
    for r in range(5):
        eng.submit(SPEC, SHAPE, rid=r)
    results = eng.run()
    assert sorted(r.rid for r in results) == [0, 1, 2, 3, 4]
    s = eng.stats()
    assert s["requests"] == 5
    assert s["padded_slots"] == 3
    assert s["model_evals"] == 5 * SPEC.nfe
    assert s["microbatches"] == 2


# ------------------------------------------------- streaming + warmup
def test_streaming_previews_and_callback_order():
    seen = []
    eng = engine(bucket_sizes=(2,), stream=True,
                 on_result=lambda res: seen.append(res.rid))
    for r in range(3):
        eng.submit(SPEC, SHAPE, rid=r)
    results = eng.run()
    assert [r.rid for r in results] == seen == [0, 1, 2]
    for res in results:
        assert res.previews.shape == (SPEC.n_steps,) + SHAPE
        assert bool(torch.isfinite(res.previews).all())


def test_warmup_then_tau_sweep_zero_misses(reference):
    """After the engine warms a bucket, serving it (re-planned taus
    included: table data) adds hits and no miss, with the reference's
    counts on the same sequence."""
    counts = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            tsamplers.clear_compile_cache()
            eng, spec, stats = (engine(bucket_sizes=(4,)), SPEC,
                                tsamplers.compile_cache_stats)
        else:
            jsamplers.clear_compile_cache()
            eng, spec, stats = (JServeEngine(j_stable, bucket_sizes=(4,)),
                                j_spec(SPEC), jsamplers.compile_cache_stats)
        serve_rids(eng, [0, 1, 2, 3], spec=spec)
        seq = [(stats()["hits"], stats()["misses"])]
        assert eng.stats()["warmups"] == 1
        for tau in (0.2, 0.5, 0.8, 1.1):
            serve_rids(eng, [0, 1, 2, 3], spec=spec.replace(tau=tau))
            seq.append((stats()["hits"], stats()["misses"]))
        counts[pkg] = seq
    assert counts["port"] == counts["ref"]
    assert counts["port"][-1][1] == 1


def test_engine_results_match_direct_sample_batched():
    """The engine is sugar: a full bucket equals one sample_batched call
    on the same per-rid draws, bit for bit."""
    got = serve_rids(engine(bucket_sizes=(4,)), [0, 1, 2, 3])
    plan = tsamplers.build_plan(SPEC)
    draws = [request_draws(7, 8, r, 0, SHAPE, SPEC.n_steps, "cpu")
             for r in range(4)]
    scale = TS.prior_scale(float(plan.ts[0]))
    xT = scale * torch.stack([z for z, _ in draws])
    ref = tsamplers.sample_batched(plan, STABLE, xT,
                                   noise=torch.stack([n for _, n in draws]))
    for r in range(4):
        assert torch.equal(ref[r], got[r])


def test_sample_batched_generators_draw_each_lane():
    """Given K generators, lane k's noise is generator k's draw: the same
    as passing that draw as ``noise``."""
    plan = tsamplers.build_plan(SPEC)
    xT = torch.randn((2,) + SHAPE, generator=torch.Generator().manual_seed(0))
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    got = tsamplers.sample_batched(plan, STABLE, xT, gens)
    noise = torch.stack([torch.randn((6,) + SHAPE, generator=torch.Generator(
        ).manual_seed(s)) for s in (5, 6)])
    assert torch.equal(got, tsamplers.sample_batched(plan, STABLE, xT,
                                                     noise=noise))
    with pytest.raises(ValueError, match="one generator per lane"):
        tsamplers.sample_batched(plan, STABLE, xT, gens[:1])


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_engine_matches_reference_engine(reference, scheduler):
    """The port's engine on the reference's draws serves every request
    within 1e-5 of the reference engine's, under each scheduler (two
    interleaved buckets, lane recycling, a ragged tail)."""
    specs = [SPEC_A.replace(combine="einsum")] * 5 + \
        [SPEC_B.replace(combine="einsum")] * 3
    kw = {"scheduler": scheduler, "lanes": 4} if scheduler == "step" else {}
    eng = engine(bucket_sizes=(1, 2, 4), draws=ref_draws, **kw)
    jeng = JServeEngine(j_stable, bucket_sizes=(1, 2, 4), **kw)
    for rid, spec in enumerate(specs):
        eng.submit(spec, (16, 2), rid=rid)
        jeng.submit(j_spec(spec), (16, 2), rid=rid)
    got = {res.rid: res for res in eng.run()}
    ref = {res.rid: res for res in jeng.run()}
    assert set(got) == set(ref) == set(range(8))
    for r in ref:
        assert got[r].status == ref[r].status == "ok"
        assert got[r].n_steps == ref[r].n_steps
        assert rel(got[r].x0, ref[r].x0) <= 1e-5, r


@pytest.mark.parametrize("scheduler", ["solve", "step"])
@pytest.mark.parametrize("name", ["ddpm_ancestral", "dpm_solver_pp_2m",
                                  "edm_stochastic"])
def test_baseline_engine_matches_reference_engine(reference, name,
                                                  scheduler):
    """Baseline specs served on the reference's draws: each request within
    1e-5 of the reference engine's, under each scheduler (the step
    scheduler through the family's step adapter, with lane recycling and
    a ragged tail)."""
    spec = tsamplers.SamplerSpec(name=name, schedule=TS, n_steps=6, tau=1.0)
    kw = {"scheduler": scheduler, "lanes": 4} if scheduler == "step" else {}
    eng = engine(bucket_sizes=(1, 2, 4), draws=ref_draws, **kw)
    jeng = JServeEngine(j_stable, bucket_sizes=(1, 2, 4), **kw)
    for rid in range(6):
        eng.submit(spec, (16, 2), rid=rid)
        jeng.submit(j_spec(spec), (16, 2), rid=rid)
    got = {res.rid: res for res in eng.run()}
    ref = {res.rid: res for res in jeng.run()}
    assert set(got) == set(ref) == set(range(6))
    for r in ref:
        assert got[r].status == ref[r].status == "ok"
        assert got[r].n_steps == ref[r].n_steps
        assert rel(got[r].x0, ref[r].x0) <= 1e-5, r
    if scheduler == "step":
        assert eng.stats()["model_evals"] == \
            6 * tsamplers.build_plan(spec).spec.nfe


@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_baseline_feature_cache_fails_as_in_the_reference(reference,
                                                          scheduler):
    """A feature-cached baseline spec fails its request with the
    reference's error under each scheduler (the gate raises inside the
    engine's containment boundary, as in the reference)."""
    spec = tsamplers.SamplerSpec(name="ddim", schedule=TS, n_steps=4,
                                 feature_cache=2)
    kw = {"scheduler": scheduler, "lanes": 2} if scheduler == "step" else {}
    eng = engine(max_retries=0, **kw)
    jeng = JServeEngine(j_stable, max_retries=0, **kw)
    eng.submit(spec, (16, 2), rid=0)
    jeng.submit(jsamplers.SamplerSpec(name="ddim", schedule=JS, n_steps=4,
                                      feature_cache=2), (16, 2), rid=0)
    (got,), (ref,) = eng.run(), jeng.run()
    assert got.status == ref.status == "failed"
    assert got.error == ref.error
    assert "not supported by the 'ddim' family" in got.error


def _cond_net(x, t, c):
    """A conditional network of both packages' lane contract: a per-lane
    [2] cond shifts the prediction."""
    if isinstance(x, torch.Tensor):
        return 0.3 * x * lane_view(torch.cos(t), x) + 0.1 * c[:, None, :]
    return 0.3 * x * jnp.cos(t) + 0.1 * c


@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_guided_per_request_cond_and_scale_match_reference(reference,
                                                           scheduler):
    """Guided requests, each with its own cond and scale, in one bucket:
    the port's one network call over 2L lanes matches the reference's
    vmapped pair, and a scale sweep adds no cache entry."""
    spec = SPEC.replace(guidance=True, prediction="x0", combine="fused")
    kw = {"scheduler": scheduler, "lanes": 4} if scheduler == "step" else {}
    den = Denoiser(_cond_net, TS, prediction="x0", guidance=True,
                   cond_rank=1)
    jden = JDenoiser(_cond_net, JS, prediction="x0", guidance=True)
    eng = engine(den, bucket_sizes=(4,), draws=ref_draws, **kw)
    jeng = JServeEngine(jden, bucket_sizes=(4,), **kw)
    rng = np.random.default_rng(0)
    conds = rng.normal(size=(4, 2)).astype(np.float32)
    for rid, s in enumerate((1.0, 1.5, 4.0, 1.5)):
        eng.submit(spec, (16, 2), rid=rid, cond=torch.from_numpy(conds[rid]),
                   guidance_scale=s)
        jeng.submit(j_spec(spec), (16, 2), rid=rid,
                    cond=jnp.asarray(conds[rid]), guidance_scale=s)
    got = {res.rid: res.x0 for res in eng.run()}
    ref = {res.rid: res.x0 for res in jeng.run()}
    for r in range(4):
        assert rel(got[r], ref[r]) <= 1e-5, r
    stats = (tsamplers.stepwise_cache_stats if scheduler == "step"
             else tsamplers.compile_cache_stats)
    misses = stats()["misses"]
    for rid, s in enumerate((2.0, 3.0)):
        eng.submit(spec, (16, 2), rid=10 + rid,
                   cond=torch.from_numpy(conds[rid]), guidance_scale=s)
    eng.run()
    assert stats()["misses"] == misses


def test_per_lane_cond_under_guidance_needs_cond_rank():
    den = Denoiser(_cond_net, TS, prediction="x0", guidance=True)
    plan = tsamplers.build_plan(SPEC.replace(guidance=True, prediction="x0"))
    with pytest.raises(ValueError, match="cond_rank"):
        tsamplers.sample_batched(plan, den, torch.zeros((2, 16, 2)),
                                 noise=torch.zeros((2, 6, 16, 2)),
                                 cond=torch.zeros(2, 2))


# ----------------------------------------- step-granular continuous batching
def test_step_scheduler_bitwise_vs_solve_through_churn():
    """A request served through join/leave/lane-recycling continuous
    batching (early exit disabled) returns exactly the solve scheduler's
    bytes for the same rid, across two interleaved buckets with lane
    recycling (5 same-key requests over 4 lanes)."""
    solve = engine(bucket_sizes=(1, 2, 4))
    rids, specs = [], {}
    for spec, n in ((SPEC_A, 5), (SPEC_B, 3)):
        for _ in range(n):
            r = solve.submit(spec, (16, 2))
            rids.append(r)
            specs[r] = spec
    ref = {res.rid: res.x0 for res in solve.run()}
    eng = step_engine()
    for r in rids:
        eng.submit(specs[r], (16, 2), rid=r)
    out = {res.rid: res for res in eng.run()}
    assert set(out) == set(ref)
    for r in rids:
        assert out[r].status == "ok"
        assert out[r].n_steps == specs[r].n_steps
        assert torch.equal(out[r].x0, ref[r]), f"rid {r}"
    s = eng.stats()
    assert s["completed"] == 8 and s["joins"] == 8


def test_step_scheduler_migration_is_bitwise_invisible():
    """rid 0 exits early out of the full first batch, so the one-request
    second batch folds into the freed lane: the migrated request's bytes
    do not move."""
    solve = engine(bucket_sizes=(1, 2, 4))
    for r in range(4):
        solve.submit(SPEC_A, (16, 2), rid=r)
    ref = {res.rid: res.x0 for res in solve.run()}
    eng = step_engine(lanes=3)
    eng.submit(SPEC_A, (16, 2), rid=0, early_exit_tol=1e3, min_steps=2)
    for r in (1, 2, 3):
        eng.submit(SPEC_A, (16, 2), rid=r)
    out = {res.rid: res for res in eng.run()}
    assert eng.stats()["migrations"] >= 1
    assert out[0].n_steps == 2
    for r in (1, 2, 3):
        assert out[r].n_steps == SPEC_A.n_steps
        assert torch.equal(out[r].x0, ref[r]), f"rid {r}"


def test_step_scheduler_early_exit_and_solo_replay():
    eng = step_engine(lanes=4)
    eng.submit(SPEC_A, (16, 2), rid=0)
    eng.submit(SPEC_A, (16, 2), rid=1, early_exit_tol=1e3, min_steps=2)
    eng.submit(SPEC_A, (16, 2), rid=2)
    out = {res.rid: res for res in eng.run()}
    assert out[1].n_steps == 2 < SPEC_A.n_steps
    assert out[0].n_steps == out[2].n_steps == SPEC_A.n_steps
    for r in (0, 2):
        e = engine(bucket_sizes=(1,))
        e.submit(SPEC_A, (16, 2), rid=r)
        assert torch.equal(out[r].x0, e.run()[0].x0), f"rid {r}"


def test_step_scheduler_stream_preview_order():
    """Per-step previews arrive in per-request step order while two
    buckets interleave, callbacks fire in completion order, and each
    request's stream is its solo-served stream."""
    seen = []
    eng = step_engine(stream=True, lanes=2,
                      on_result=lambda res: seen.append(res.rid))
    for r in (0, 1):
        eng.submit(SPEC_A, (16, 2), rid=r)
    for r in (2, 3):
        eng.submit(SPEC_B, (16, 2), rid=r)
    out = {res.rid: res for res in eng.run()}
    assert seen == [2, 3, 0, 1]
    for r, spec in ((0, SPEC_A), (1, SPEC_A), (2, SPEC_B), (3, SPEC_B)):
        pv = out[r].previews
        assert pv.shape == (spec.n_steps, 16, 2)
        solo = engine(bucket_sizes=(1,), stream=True)
        solo.submit(spec, (16, 2), rid=r)
        assert torch.equal(solo.run()[0].previews, pv)


def test_step_scheduler_zero_misses_across_churn(reference):
    """Warmup is keyed by the step function: a join/leave churn sweep
    (drain-and-refill waves, tau changed per wave, batches retired and
    re-opened) adds no step-cache miss after the first, as in the
    reference."""
    counts = {}
    for pkg in ("port", "ref"):
        if pkg == "port":
            tsamplers.clear_stepwise_cache()
            eng, spec = step_engine(lanes=2), SPEC_A
            stats = tsamplers.stepwise_cache_stats
        else:
            jsamplers.clear_stepwise_cache()
            eng = JServeEngine(j_stable, scheduler="step", lanes=2)
            spec, stats = j_spec(SPEC_A), jsamplers.stepwise_cache_stats
        for r in range(3):
            eng.submit(spec, (16, 2), rid=r)
        eng.run()
        seq = [stats()["misses"]]
        rid = 10
        for tau in (0.7, 0.2, 0.9, 0.5, 1.1):
            for _ in range(3):
                eng.submit(spec.replace(tau=tau), (16, 2), rid=rid)
                rid += 1
            eng.run()
            seq.append(stats()["misses"])
        assert eng.stats()["warmups"] == 1
        counts[pkg] = seq
    assert counts["port"] == counts["ref"] == [1] * 6


def test_step_scheduler_priority_deadline_and_admission():
    eng = step_engine(lanes=2, max_pending=3)
    eng.submit(SPEC_A, (16, 2), rid=0, priority=0)
    eng.submit(SPEC_A, (16, 2), rid=1, priority=5)
    eng.submit(SPEC_A, (16, 2), rid=2, priority=0, deadline=0.0)
    with pytest.raises(RuntimeError, match="admission control"):
        eng.submit(SPEC_A, (16, 2), rid=3)
    results = {res.rid: res for res in eng.run()}
    assert results[2].status == "shed" and results[2].x0 is None
    assert results[0].status == results[1].status == "ok"
    assert eng.stats()["shed"] == 1


def test_step_scheduler_occupancy_stats_both_schedulers():
    solve = engine(bucket_sizes=(4,))
    for r in range(3):
        solve.submit(SPEC_A, (16, 2), rid=r)
    solve.run()
    b = solve.stats()["buckets"]["sa/8step/16x2/float32"]
    assert b["lane_steps"] == 32 and b["wasted_lane_steps"] == 8
    assert b["occupancy"] == pytest.approx(0.75)
    eng = step_engine(lanes=4)
    for r in range(3):
        eng.submit(SPEC_A, (16, 2), rid=r)
    eng.run()
    sb = eng.stats()["buckets"]["sa/8step/16x2/float32"]
    assert sb["lane_steps"] == sb["active_lane_steps"] \
        + sb["wasted_lane_steps"]
    assert sb["occupancy"] == pytest.approx(0.75)


def test_engine_rejects_mesh_unknown_scheduler_and_no_card():
    # the reference's mesh refusals (src/repro/serve/engine.py:193-202)
    with pytest.raises(ValueError, match="step scheduler is single-device"):
        engine(mesh=object(), scheduler="step")
    with pytest.raises(ValueError, match="cfg_axis needs a mesh"):
        engine(cfg_axis="cfg")
    with pytest.raises(ValueError, match="scheduler"):
        engine(scheduler="nope")
    if not torch.cuda.is_available():
        for scheduler in ("solve", "step"):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                ServeEngine(STABLE, scheduler=scheduler)
