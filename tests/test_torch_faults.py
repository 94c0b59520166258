"""Fault tolerance of the port's serve engine against the JAX reference:
numerical guards, containment, retry, degradation, quarantine.

Mirrors ``tests/test_faults.py``: the per-lane numerical guard (a NaN'd
lane fails alone, its neighbours' bytes equal their solo solves, and the
guard interval is carry data: toggling it adds no step-cache entry and,
at 0, gives the unguarded bytes); per-bucket containment in both
schedulers; bounded retry with per-attempt seeds and the tau->0
degradation ladder; consecutive-failure quarantine with cooldown and a
recovery probe; the straggler watchdog; guarded ``on_result`` callbacks;
``health()``; seeded :class:`FaultPlan` determinism; and the
feature-cached draft tier served bitwise like its explicit spec.

Against the reference: the seeded fault plans are the reference's
field for field, the straggler monitor flags the same ticks on the same
wall times, and under an injected NaN (and the degradation ladder) the
port's engine on the reference's draws ends every request with the
reference's status, attempts and rung, and its results within 1e-5
relative in norm. The port's own contracts are bitwise on the CPU (the
``fused`` combine and an elementwise model). The reference's checkpointer
tests (``test_faults.py:372-389``) have no counterpart: the checkpointer
comes with the training slice of the port (ROADMAP A12).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import get_schedule as j_get_schedule
    from repro.core import samplers as jsamplers
    from repro.runtime import StragglerMonitor as JStragglerMonitor
    from repro.serve import Fault as JFault
    from repro.serve import FaultInjector as JFaultInjector
    from repro.serve import FaultPlan as JFaultPlan
    from repro.serve import ServeEngine as JServeEngine
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.denoiser import lane_view
from repro_torch.models.tame import tame_dit, tame_networks
from repro_torch.runtime import InjectedFailure, StragglerMonitor
from repro_torch.serve import (Fault, FaultInjector, FaultPlan, QualityTiers,
                               Request, ServeEngine, default_tiers,
                               poison_lane)

TS = get_schedule("vp_linear")
SPEC = tsamplers.SamplerSpec(name="sa", schedule=TS, n_steps=8, mode="PECE",
                             tau=0.7, combine="fused")
SHAPE = (16, 2)
if jax is not None:
    JS = j_get_schedule("vp_linear")
    J_SPEC = jsamplers.SamplerSpec(name="sa", schedule=JS, n_steps=8,
                                   mode="PECE", tau=0.7, combine="fused")


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


def solo_refs(rids, spec=SPEC, shape=SHAPE):
    eng = engine(bucket_sizes=(1,))
    for r in rids:
        eng.submit(spec, shape, rid=r)
    return {res.rid: res.x0 for res in eng.run()}


def ref_draws(rid, attempt, shape, M):
    """The reference engine's draws of one request (see
    tests/test_torch_serve.py)."""
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


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_same_outcomes(got, ref):
    """Every request ends with the reference's status, attempts and rung;
    served results within 1e-5."""
    assert set(got) == set(ref)
    for r in ref:
        assert (got[r].status, got[r].attempts, got[r].degraded_to) == \
            (ref[r].status, ref[r].attempts, ref[r].degraded_to), r
        if ref[r].x0 is None:
            assert got[r].x0 is None
        else:
            assert rel(got[r].x0, ref[r].x0) <= 1e-5, r


# ------------------------------------------------------- numerical guard
def test_guard_trips_nan_and_isolates_lanes():
    """NaN injected into one lane mid-solve: that request alone fails with
    status="failed_numerics"; every other lane of the running batch
    returns its solo solve's bytes."""
    rids = [0, 1, 2, 3]
    ref = solo_refs(rids)
    inj = FaultInjector(FaultPlan((Fault("nan", tick=3, rid=1),)))
    eng = step_engine(guard_interval=2, fault_injector=inj)
    for r in rids:
        eng.submit(SPEC, SHAPE, rid=r)
    out = {res.rid: res for res in eng.run()}
    assert len(out) == 4
    assert out[1].status == "failed_numerics"
    assert out[1].x0 is None and out[1].attempts == 1
    assert "non-finite" in out[1].error
    for r in (0, 2, 3):
        assert out[r].status == "ok"
        assert torch.equal(out[r].x0, ref[r]), f"rid {r}"
    assert inj.fired and inj.fired[0][0] == "nan"
    s = eng.stats()
    assert s["failed_numerics"] == 1 and s["completed"] == 3


@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_nan_fault_outcomes_match_reference(reference, scheduler):
    """The same NaN fault under the same retry budget: every request ends
    as in the reference engine (the retried one on a fresh attempt
    seed), results within 1e-5."""
    tick = 0 if scheduler == "solve" else 3
    kw = {"scheduler": scheduler, "lanes": 4} if scheduler == "step" else {}
    eng = engine(bucket_sizes=(4,), guard_interval=1, max_retries=1,
                 draws=ref_draws, fault_injector=FaultInjector(
                     FaultPlan((Fault("nan", tick=tick, rid=2),))), **kw)
    jeng = JServeEngine(j_stable, bucket_sizes=(4,), guard_interval=1,
                        max_retries=1, fault_injector=JFaultInjector(
                            JFaultPlan((JFault("nan", tick=tick, rid=2),))),
                        **kw)
    for r in range(4):
        eng.submit(SPEC, SHAPE, rid=r)
        jeng.submit(J_SPEC, SHAPE, rid=r)
    got = {res.rid: res for res in eng.run()}
    ref = {res.rid: res for res in jeng.run()}
    assert_same_outcomes(got, ref)
    assert got[2].attempts == 2


def test_guard_interval_is_data_zero_cache_miss():
    """Guard off, then at two intervals: ONE step-cache entry, and
    (fault-free) the same bytes, guard 0 included."""
    tsamplers.clear_stepwise_cache()
    outs = []
    for guard in (0, 3, 1):
        eng = step_engine(guard_interval=guard)
        for r in range(3):
            eng.submit(SPEC, SHAPE, rid=r)
        outs.append({res.rid: res.x0 for res in eng.run()})
    s = tsamplers.stepwise_cache_stats()
    assert s["misses"] == 1, s
    for got in outs[1:]:
        for r in range(3):
            assert torch.equal(got[r], outs[0][r]), f"rid {r}"


def test_solve_scheduler_post_solve_guard_and_retry():
    """A NaN'd initial lane is caught by the post-solve check and retried
    on a fresh attempt seed; the healthy lanes of the faulted microbatch
    return the fault-free bytes, with no extra cache entry."""
    clean = engine(bucket_sizes=(4,))
    for r in range(4):
        clean.submit(SPEC, SHAPE, rid=r)
    ref = {res.rid: res.x0 for res in clean.run()}
    tsamplers.clear_compile_cache()
    inj = FaultInjector(FaultPlan((Fault("nan", tick=0, rid=2),)))
    eng = engine(bucket_sizes=(4,), guard_interval=1, max_retries=1,
                 fault_injector=inj)
    for r in range(4):
        eng.submit(SPEC, SHAPE, rid=r)
    out = {res.rid: res for res in eng.run()}
    assert out[2].status == "ok" and out[2].attempts == 2
    assert bool(torch.isfinite(out[2].x0).all())
    assert not torch.equal(out[2].x0, ref[2])
    for r in (0, 1, 3):
        assert out[r].attempts == 1
        assert torch.equal(out[r].x0, ref[r]), f"rid {r}"
    assert tsamplers.compile_cache_stats()["misses"] == 1
    assert eng.stats()["retries"] == 1


# ------------------------------------------------- containment (buckets)
def _model_raising_on(seq_len):
    def model(x, t):
        if x.shape[1] == seq_len:  # one bucket's geometry fails
            raise RuntimeError("backbone rejected this geometry")
        return STABLE(x, t)
    return model


@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_raising_bucket_does_not_abort_others(scheduler):
    ref = solo_refs([0, 1])
    kw = {"scheduler": scheduler}
    if scheduler == "step":
        kw["lanes"] = 4
    eng = engine(_model_raising_on(9), bucket_sizes=(1, 2, 4), **kw)
    eng.submit(SPEC, SHAPE, rid=0)
    eng.submit(SPEC, (9, 2), rid=5)
    eng.submit(SPEC, SHAPE, rid=1)
    out = {res.rid: res for res in eng.run()}
    assert set(out) == {0, 1, 5}
    assert out[5].status == "failed"
    assert "backbone rejected" in out[5].error
    for r in (0, 1):
        assert out[r].status == "ok"
        assert torch.equal(out[r].x0, ref[r]), f"rid {r}"
    assert eng.stats()["failed"] == 1


@pytest.mark.parametrize("scheduler", ["solve", "step"])
def test_retry_succeeds_after_transient_raise(scheduler):
    inj = FaultInjector(FaultPlan((Fault("raise", tick=0),)))
    kw = {"scheduler": scheduler}
    if scheduler == "step":
        kw["lanes"] = 4
    eng = engine(bucket_sizes=(4,), max_retries=2, retry_backoff=0.01,
                 fault_injector=inj, **kw)
    for r in range(3):
        eng.submit(SPEC, SHAPE, rid=r)
    out = {res.rid: res for res in eng.run()}
    assert len(out) == 3
    assert len([f for f in inj.fired if f[0] == "raise"]) == 1
    for r in range(3):
        assert out[r].status == "ok", out[r]
        assert bool(torch.isfinite(out[r].x0).all())
    s = eng.stats()
    assert s["failed"] == 0
    if scheduler == "solve":
        assert s["retries"] == 3
        assert all(out[r].attempts == 2 for r in range(3))
    else:
        assert s["retries"] >= 1
        assert any(out[r].attempts == 2 for r in range(3))


def test_degradation_ladder_tau0_after_repeated_numerics(reference):
    """Two NaN faults chase one rid across retries: attempt 1 degrades to
    tau=0 and attempt 3 completes there, under ONE step-cache entry (tau
    is data); the reference engine ends the same way, within 1e-5."""
    plan = ((0, 2), (0, 6))
    tsamplers.clear_stepwise_cache()
    eng = step_engine(guard_interval=1, max_retries=2,
                      degrade_ladder=("tau0",), draws=ref_draws,
                      fault_injector=FaultInjector(FaultPlan(tuple(
                          Fault("nan", tick=t, rid=r) for r, t in plan))))
    jeng = JServeEngine(j_stable, scheduler="step", lanes=4,
                        guard_interval=1, max_retries=2,
                        degrade_ladder=("tau0",),
                        fault_injector=JFaultInjector(JFaultPlan(tuple(
                            JFault("nan", tick=t, rid=r) for r, t in plan))))
    eng.submit(SPEC, SHAPE, rid=0)
    jeng.submit(J_SPEC, SHAPE, rid=0)
    (res,) = eng.run()
    (jres,) = jeng.run()
    assert res.status == "ok" and res.attempts == 3
    assert res.degraded_to == "tau0"
    assert_same_outcomes({0: res}, {0: jres})
    s = eng.stats()
    assert s["retries"] == 2 and s["failed_numerics"] == 0
    assert s["degraded"] == 1
    assert s["stepwise_cache"]["misses"] == 1, s["stepwise_cache"]


def test_degraded_tau0_matches_explicit_tau0_submission():
    inj = FaultInjector(FaultPlan((Fault("nan", tick=1, rid=7),)))
    eng = step_engine(guard_interval=1, max_retries=1,
                      degrade_ladder=("tau0",), fault_injector=inj)
    eng.submit(SPEC, SHAPE, rid=7)
    (res,) = eng.run()
    assert res.status == "ok" and res.degraded_to == "tau0"
    ref_eng = step_engine()
    ref_eng._batcher.enqueue(dataclasses.replace(
        Request(rid=7, spec=SPEC.replace(tau=0.0, program=None),
                shape=SHAPE), attempt=1))
    (ref,) = ref_eng.run()
    assert torch.equal(res.x0, ref.x0)


# --------------------------------------------------- quarantine/watchdog
def test_quarantine_after_consecutive_failures_then_recovery():
    inj = FaultInjector(FaultPlan((Fault("raise", tick=0),
                                   Fault("raise", tick=1))))
    eng = step_engine(max_retries=3, retry_backoff=0.01,
                      quarantine_after=2, quarantine_s=0.1,
                      fault_injector=inj)
    eng.submit(SPEC, SHAPE, rid=0)
    t0 = time.monotonic()
    (res,) = eng.run()
    assert res.status == "ok" and res.attempts == 3
    assert eng.stats()["quarantines"] == 1
    assert time.monotonic() - t0 >= 0.1
    h = eng.health()
    assert h["status"] == "ok" and h["quarantined"] == {}


def test_health_snapshot_both_schedulers():
    for scheduler in ("solve", "step"):
        h = engine(scheduler=scheduler).health()
        assert h["status"] == "ok" and h["scheduler"] == scheduler
        for k in ("pending", "quarantined", "consecutive_failures",
                  "completed", "failed", "failed_numerics", "retries",
                  "quarantines", "callback_errors", "straggler_events"):
            assert k in h, k
    eng = engine(_model_raising_on(9), quarantine_after=1, quarantine_s=30.0)
    eng.submit(SPEC, (9, 2), rid=0)
    (res,) = eng.run()
    assert res.status == "failed"
    h = eng.health()
    assert h["status"] == "degraded"
    (remaining,) = h["quarantined"].values()
    assert 0 < remaining <= 30.0


def test_watchdog_sees_injected_latency():
    big = SPEC.replace(n_steps=30)
    spike = Fault("latency", tick=20, seconds=0.25)
    inj = FaultInjector(FaultPlan((spike,)))
    eng = step_engine(
        fault_injector=inj,
        watchdog=StragglerMonitor(alpha=0.3, z_thresh=3.0, patience=1,
                                  warmup_steps=5))
    for r in range(4):
        eng.submit(big, SHAPE, rid=r)
    out = eng.run()
    assert len(out) == 4 and all(r.status == "ok" for r in out)
    assert any(f[0] == "latency" for f in inj.fired)
    assert eng.stats()["straggler_events"] >= 1


def test_straggler_monitor_matches_reference(reference):
    """The monitor flags the same steps, with the same events, as the
    reference's on one wall-time series."""
    rng = np.random.default_rng(3)
    dts = list(0.01 + 0.001 * rng.standard_normal(60))
    dts[30] = dts[31] = dts[32] = 0.2
    mons = [StragglerMonitor(patience=2), JStragglerMonitor(patience=2)]
    flags = [[m.observe(i, dt) for i, dt in enumerate(dts)] for m in mons]
    assert flags[0] == flags[1] and any(flags[0])
    assert mons[0].events == mons[1].events


# ------------------------------------------------------ result callbacks
def test_on_result_callback_errors_do_not_lose_results():
    calls = []

    def cb(res):
        calls.append(res.rid)
        raise ValueError("frontend fell over")

    for scheduler in ("solve", "step"):
        eng = engine(scheduler=scheduler, on_result=cb)
        for r in range(3):
            eng.submit(SPEC, SHAPE, rid=r)
        out = eng.run()
        assert len(out) == 3 and all(r.status == "ok" for r in out)
        s = eng.stats()
        assert s["callback_errors"] == 3
        assert any("frontend fell over" in m
                   for m in s["callback_error_messages"])
    assert sorted(calls) == [0, 0, 1, 1, 2, 2]


# -------------------------------------------------------- chaos plumbing
def test_fault_validation_and_seeded_determinism(reference):
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("explode")
    with pytest.raises(ValueError, match="target rid or lane"):
        Fault("nan")
    kw = dict(n_ticks=50, rids=range(8), nan=2, raises=1, latency=1)
    p1, p2 = FaultPlan.seeded(42, **kw), FaultPlan.seeded(42, **kw)
    assert p1 == p2 and len(p1.faults) == 4
    assert sorted(f.kind for f in p1.faults) == \
        ["latency", "nan", "nan", "raise"]
    assert p1 != FaultPlan.seeded(43, **kw)
    jp = JFaultPlan.seeded(42, **kw)
    assert [dataclasses.astuple(f) for f in p1.faults] == \
        [dataclasses.astuple(f) for f in jp.faults]


def test_poison_lane_touches_only_target():
    carry = tsamplers.fresh_carry(tsamplers.build_plan(SPEC), 4, SHAPE,
                                  torch.float32, device="cpu")
    carry["inner"]["x"].normal_(generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in carry["inner"].items()}
    poisoned = poison_lane(carry, 2)
    for k, a in poisoned["inner"].items():
        assert torch.isnan(a[2]).all()
        keep = torch.arange(a.shape[0]) != 2
        assert torch.equal(a[keep], before[k][keep])
        assert torch.equal(carry["inner"][k], before[k])  # a copy


def test_injected_failure_raises_through_on_tick():
    inj = FaultInjector(FaultPlan((Fault("raise", tick=0, bucket="sa/"),)))

    class _B:  # minimal RunningBatch stand-in
        key = (SPEC, SHAPE, "float32", None)
        requests = [None]
        carry = None
    with pytest.raises(InjectedFailure):
        inj.on_tick(0, _B())
    inj.on_tick(1, _B())  # spent: fires at most once


# ------------------------------------------------ feature-cached tiers
def test_feature_cached_draft_tier_bitwise_equals_explicit_spec():
    """default_tiers(feature_cache=...) makes draft the cached-evaluation
    preset, and a quality_tier="draft" request is bitwise the explicit
    resolved-spec submission (the solve scheduler, a tame smoke DiT with
    its cached companion)."""
    model, params, mu = tame_dit("dit-s", n_layers=4, device="cpu")
    net, cached = tame_networks(model, params, mu)
    den = Denoiser(net, TS, prediction="x0", cached=cached)
    tiers = default_tiers(schedule=TS, feature_cache=2, prediction="x0")
    assert tiers.resolve("draft").feature_cache == 2
    assert tiers.resolve("standard").feature_cache is None
    e_tier = engine(den, tiers=tiers)
    e_tier.submit(None, shape=(16, 8), quality_tier="draft")
    (r_tier,) = e_tier.run()
    e_spec = engine(den)
    e_spec.submit(tiers.resolve("draft"), shape=(16, 8))
    (r_spec,) = e_spec.run()
    assert r_tier.rid == r_spec.rid
    assert torch.equal(r_tier.x0, r_spec.x0)
    assert bool(torch.isfinite(r_tier.x0).all())


def test_tiers_from_artifact_waits_for_the_autotuner(tmp_path):
    """``QualityTiers.from_artifact`` reads the autotuner's artifact (its
    winner served as ``best``: tests/test_torch_tune.py); it raises while
    the artifact is missing or records no evaluated program yet."""
    from repro_torch.tune import SearchConfig, run_search
    art = str(tmp_path / "tune.json")
    with pytest.raises(FileNotFoundError):
        QualityTiers.from_artifact(art)
    res = run_search(SearchConfig(budget=0, presets=("tau-anneal",)),
                     artifact=art, device="cpu")
    assert res.exhausted and res.best_program is None
    with pytest.raises(ValueError, match="no evaluated program"):
        QualityTiers.from_artifact(art)
