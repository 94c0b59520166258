"""The port's program autotuner (``repro_torch.tune``, ``launch.tune``,
``QualityTiers.from_artifact``) against the JAX reference's
``repro.tune``.

Mirrors ``tests/test_tune.py`` on the port's own draws (the objective's
seeded ``torch.Generator`` streams, on the CPU): chunk scores aligned and
bitwise equal to one-candidate calls, one compile per mode pattern, cost
accounting, same-seed determinism, the budget, resume, the artifact round
trip and version gate, the tau-only family, the feature-cache unit and its
resume, the staleness cost, tiers from an artifact (the fc winner as
``draft``, the searched program served bitwise), the default tiers and the
CLI with ``--device cpu``.

Against the reference: the reference's ``GMMObjective`` draws (initial
states, the per-step noise for each step count, targets, projection
directions) go into the port's objective, and the port's scores are held
within 1e-5 relative of the reference's for SA PEC and PECE programs, DDIM
tau tracks and feature-cache pairs; ``run_search`` at the reference test's
``SMALL`` settings visits the same candidates in the same order and finds
the same winner; each package's ``QualityTiers.from_artifact`` of the
other's artifact gives the same spec.

The candidate-stacked solve (``stacked_solve``: each lane under its own
plan) equals ``sample_batched`` of each candidate alone, bit for bit on
the oracle, under every combine and under the residual feature cache with
a threshold per lane, and for the tau-only baselines; the port's metrics
match the reference's.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import metrics as j_metrics
    from repro.core.programs import program_preset_for_nfe as j_preset
    from repro.serve import QualityTiers as JQualityTiers
    from repro.tune import GMMObjective as JGMMObjective
    from repro.tune import ProgramEvaluator as JProgramEvaluator
    from repro.tune import SearchConfig as JSearchConfig
    from repro.tune import run_search as j_run_search
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.core import StepProgram, get_schedule, metrics
from repro_torch.core.programs import program_preset, program_preset_for_nfe
from repro_torch.core.samplers import (SamplerSpec, build_plan,
                                       sample_batched)
from repro_torch.core.samplers.base import stack_plans, stacked_solve
from repro_torch.serve import QualityTiers, ServeEngine, default_tiers
from repro_torch.tune import (GMMObjective, ProgramEvaluator, SearchConfig,
                              run_search)
from repro_torch.tune.search import (fc_spec_from_state, load_state,
                                     save_state, spec_from_state)

REPO = Path(__file__).resolve().parents[1]
SCHED = get_schedule("vp_linear")

# small-but-real search settings shared by the determinism/resume tests
SMALL = dict(nfe=8, seed=0, n_samples=128, n_seeds=2, n_proj=32,
             evo_population=6, evo_generations=1, cd_passes=1)
REL = 1e-5


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def _objective(**kw):
    base = dict(n_samples=128, n_seeds=2, n_proj=32, seed=0, device="cpu")
    base.update(kw)
    return GMMObjective(**base)


def search(cfg=None, **kw):
    return run_search(cfg, device="cpu", **kw)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def ref_draws(jobj) -> dict:
    """The reference objective's draws, as the port's injection fields:
    unit normals of ``split(fold_in(seed, 0), n_seeds)``, the step normals
    of ``split(solve_key, M)`` for each seed, the targets, and the
    projection directions of ``split(fold_in(seed, 3), n_seeds)``."""
    def base(lane):
        return jax.random.fold_in(jax.random.PRNGKey(jobj.seed), lane)

    def normals(keys, shape):
        return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                         for k in keys])

    def noise(M):
        return torch.from_numpy(np.stack([
            normals(jax.random.split(k, M), jobj.shape)
            for k in jobj.solve_keys()]))

    dirs = normals(jax.random.split(base(3), jobj.n_seeds),
                   (jobj.n_proj, jobj.gmm.dim))
    return dict(
        init_draws=torch.from_numpy(normals(
            jax.random.split(base(0), jobj.n_seeds), jobj.shape)),
        noise_fn=noise, target_draws=torch.from_numpy(
            np.array(jobj.targets())), dir_draws=torch.from_numpy(dirs))


def objectives(**kw):
    """(reference objective, port objective on the reference's draws)."""
    base = dict(n_samples=128, n_seeds=2, n_proj=32, seed=0)
    base.update(kw)
    jobj = JGMMObjective(**base)
    return jobj, GMMObjective(device="cpu", **base, **ref_draws(jobj))


def spec_fields(spec) -> dict:
    """A spec of either package as plain data, field by field."""
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "program" and v is not None:
            v = json.loads(v.to_json())
        out[f.name] = v
    return out


# ------------------------------------------------------------- evaluator
def test_evaluator_scores_align_and_match_singletons():
    """Batched chunk evaluation returns the same score a one-candidate
    call does, aligned with the input order (padding never leaks)."""
    ev = ProgramEvaluator(_objective(), nfe=8, chunk=4)
    progs = [program_preset_for_nfe("tau-anneal", 8, tau=t)
             for t in (1.0, 0.6, 0.2)]
    batched = ev.evaluate(progs)
    assert batched.shape == (3,)
    solo = [ProgramEvaluator(_objective(), nfe=8, chunk=4).evaluate([p])[0]
            for p in progs]
    np.testing.assert_array_equal(batched, solo)
    # a real signal: different taus score differently
    assert len({round(s, 9) for s in batched}) == 3


def test_evaluator_one_compile_per_mode_pattern():
    """Order/tau variants of one mode pattern share ONE entry; a second
    pattern costs exactly one more; the compile cache holds one stacked
    entry per group."""
    from repro_torch.core.samplers import compile_cache_stats
    ev = ProgramEvaluator(_objective(), nfe=8, chunk=4)
    anneal = program_preset_for_nfe("tau-anneal", 8)  # uniform PEC
    variants = [anneal.replace(tau=(t,) * anneal.length())
                for t in (0.0, 0.3, 0.7, 1.0)]
    variants += [anneal.replace(predictor_order=o) for o in (1, 2)]
    misses = compile_cache_stats()["misses"]
    ev.evaluate(variants)
    assert ev.stats["compiles"] == 1, ev.stats
    assert ev.stats["dispatches"] == 2
    # new mode pattern (P tail) -> one more entry, no thrash
    ev.evaluate([program_preset_for_nfe("predictor-tail", 8)])
    assert ev.stats["compiles"] == 2, ev.stats
    # re-dispatching either pattern stays warm
    ev.evaluate(variants[:2] + [program_preset_for_nfe("predictor-tail", 8,
                                                       tau=0.4)])
    assert ev.stats["compiles"] == 2, ev.stats
    assert compile_cache_stats()["misses"] - misses == 2


def test_evaluator_cost_accounting():
    ev = ProgramEvaluator(_objective(n_seeds=2), nfe=8, chunk=8)
    prog = program_preset_for_nfe("tau-anneal", 8)
    assert ev.cost_of(prog) == ev.spec_for(prog).nfe * 2
    ev.evaluate([prog])
    assert ev.stats["nfe_spent"] == ev.cost_of(prog)
    assert ev.stats["candidates"] == 1
    assert ev.stats["pad_evals"] == 7
    assert ev.cost_of_fc(1.0, 0.05) == ev.spec_for_fc(1.0, 0.05).nfe * 2


def test_objective_draws_are_seeded_and_injectable():
    """Same seed, same draws; another seed, others; an injected draw
    replaces the objective's own."""
    spec = SamplerSpec.from_nfe("sa", 8)
    a, b, c = _objective(), _objective(), _objective(seed=1)
    assert torch.equal(a.init(spec), b.init(spec))
    assert torch.equal(a.solve_noise(7), b.solve_noise(7))
    assert torch.equal(a.targets(), b.targets())
    assert torch.equal(a.directions(), b.directions())
    assert not torch.equal(a.init(spec), c.init(spec))
    assert a.solve_noise(3).shape == (2, 3, 128, 2)
    z = torch.ones((2, 128, 2))
    assert torch.equal(_objective(init_draws=z).init(spec), z)
    assert float(a.batch_score(a.targets())) == 0.0


@pytest.mark.parametrize("conv", ["data", "noise", "v"])
def test_lane_oracle_is_the_oracle_at_each_lanes_time(conv):
    """The objective's lane-batched model: lane l is the oracle at t[l]."""
    from repro_torch.core import GMM
    gmm = GMM.default_2d()
    x = torch.randn((3, 16, 2), generator=torch.Generator().manual_seed(0))
    t = torch.tensor([0.9, 0.5, 0.05])
    got = _objective().model_fn(conv, SCHED)(x, t)
    want = torch.stack([gmm.model_fn(SCHED, conv)(x[l], t[l])
                        for l in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------- candidate-stacked solve
def _stacked_vs_batched(specs, model, obj):
    plans = [build_plan(s) for s in specs]
    S = obj.n_seeds
    x, xi = obj.init(specs[0]), obj.solve_noise(specs[0].n_steps)
    out = stacked_solve([p for p in plans for _ in range(S)], model,
                        x.repeat(len(plans), 1, 1),
                        xi.repeat(len(plans), 1, 1, 1), lane_group=S)
    alone = torch.cat([sample_batched(p, model, x, noise=xi) for p in plans])
    return out, alone


@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
@pytest.mark.parametrize("fc", [None, "residual"])
def test_stacked_solve_equals_sample_batched_alone(combine, fc):
    """Each candidate's lanes of the stacked solve are bitwise its
    ``sample_batched`` solve alone: programs of one mode pattern with
    their own taus, or the residual feature cache with a threshold per
    candidate (its own refresh flags)."""
    obj = _objective(n_samples=64)
    if fc:
        specs = [SamplerSpec(name="sa", schedule=SCHED, n_steps=4, tau=tau,
                             mode="PECE", combine=combine,
                             feature_cache=("residual", th))
                 for tau, th in ((1.0, 0.01), (0.4, 0.05), (0.0, 0.3))]
        model = obj.cached_model_fn("data", SCHED)
    else:
        specs = [SamplerSpec(name="sa", schedule=SCHED, n_steps=7,
                             combine=combine, program=program_preset(
                                 "predictor-tail", 7, tau=tau))
                 for tau in (1.0, 0.4, 0.0)]
        model = obj.model_fn("data", SCHED)
    out, alone = _stacked_vs_batched(specs, model, obj)
    assert torch.equal(out, alone)
    assert len({float(out[2 * k].sum()) for k in range(3)}) == 3


@pytest.mark.parametrize("combine", ["einsum", "kernel"])
def test_stacked_solve_concat_history(combine):
    """The concat layout (the history re-stacked every step) stacks on
    the lanes' history axis too."""
    obj = _objective(n_samples=64)
    specs = [SamplerSpec(name="sa", schedule=SCHED, n_steps=4, tau=tau,
                         mode="PECE", combine=combine, history="concat")
             for tau in (1.0, 0.2)]
    out, alone = _stacked_vs_batched(specs, obj.model_fn("data", SCHED), obj)
    assert torch.equal(out, alone)


@pytest.mark.parametrize("family", ["ddim", "ddpm_ancestral",
                                    "euler_maruyama", "edm_stochastic"])
def test_stacked_solve_tau_only_baselines(family):
    """The tau-only baselines read each lane's [L] table values."""
    obj = _objective(n_samples=64)
    specs = [SamplerSpec(name=family, schedule=SCHED, n_steps=6,
                         program=program_preset("tau-anneal", 6, tau=t))
             for t in (1.0, 0.3)]
    out, alone = _stacked_vs_batched(specs, obj.model_fn("data", SCHED), obj)
    assert torch.equal(out, alone)


def test_stack_plans_refuses_plans_that_differ_in_structure():
    def plan(**kw):
        base = dict(name="sa", schedule=SCHED, n_steps=5)
        base.update(kw)
        return build_plan(SamplerSpec(**base))
    a = plan()
    stacked = stack_plans([a, a, plan(tau=0.3), plan(tau=0.3)])
    assert stacked.arrays["pred_packed"].shape[:2] == (5, 4)
    assert stacked.arrays["stacked"] is True
    with pytest.raises(ValueError, match="statics"):
        stack_plans([a, plan(mode="PECE")])
    with pytest.raises(ValueError, match="step count"):
        stack_plans([a, plan(n_steps=6)])
    with pytest.raises(ValueError, match="grid"):
        stack_plans([a, plan(grid="time")])
    with pytest.raises(ValueError, match="table shapes"):
        stack_plans([a, plan(predictor_order=2, corrector_order=2)])
    with pytest.raises(ValueError, match="lane_group"):
        stack_plans([a, plan(tau=0.3)], lane_group=2)


# ---------------------------------------------------------------- search
def test_search_deterministic_same_seed_same_history():
    cfg = SearchConfig(budget=500, presets=("nfe8-gmm",), **SMALL)
    a = search(cfg)
    b = search(cfg)
    assert a.best_program == b.best_program
    assert a.best_score == b.best_score
    assert a.state["history"] == b.state["history"]
    assert a.state["budget_spent"] == b.state["budget_spent"]
    assert len(a.state["history"]) > 1


def test_search_respects_budget_and_improves_on_warm_start():
    cfg = SearchConfig(budget=600, presets=("nfe8-gmm",), **SMALL)
    res = search(cfg)
    assert res.state["budget_spent"] <= cfg.budget
    warm_score = res.state["history"][0]["score"]  # incumbent goes first
    assert res.best_score <= warm_score
    assert res.stats["compiles"] == 1, res.stats


def test_search_resume_replays_identically(tmp_path):
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(budget=700, presets=("nfe8-gmm", "tau-anneal"),
                       **SMALL)
    full = search(cfg)
    part = search(cfg, artifact=art, max_units=1)
    assert not part.done
    assert load_state(art)["unit"] == 1
    resumed = search(artifact=art, resume=True)
    assert resumed.done
    assert resumed.best_program == full.best_program
    assert resumed.state["history"] == full.state["history"]
    assert resumed.state["budget_spent"] == full.state["budget_spent"]


def test_artifact_round_trip_and_version_gate(tmp_path):
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(budget=400, presets=("tau-anneal",), **SMALL)
    res = search(cfg, artifact=art)
    state = load_state(art)
    assert state["history"] == res.state["history"]
    spec = spec_from_state(state)
    assert isinstance(spec.program, StepProgram)
    assert spec.nfe <= cfg.nfe
    state["version"] = 99
    bad = str(tmp_path / "bad.json")
    save_state(bad, state)
    with pytest.raises(ValueError, match="version"):
        load_state(bad)


def test_search_tau_only_family():
    cfg = SearchConfig(family="ddim", budget=300, presets=("tau-anneal",),
                       **SMALL)
    res = search(cfg)
    assert res.best_program is not None
    assert res.best_program.predictor_order == 3  # untouched scalar
    assert isinstance(res.best_program.tau, tuple)


def test_searched_program_beats_preset_on_objective():
    cfg = SearchConfig(budget=900, presets=("nfe8-gmm",), **SMALL)
    res = search(cfg)
    preset_score = res.state["history"][0]["score"]
    assert res.best_score < preset_score


# --------------------------------------------------- feature-cache search
FC = dict(budget=3000, presets=("tau-anneal",), tau_values=(0.0, 0.5, 1.0))


def test_fc_threshold_joins_search_space(tmp_path):
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(fc_thresholds=(1e-3, 0.05, 0.5), **FC, **SMALL)
    res = search(cfg, artifact=art)
    assert res.done and not res.exhausted
    fc = res.best_fc
    assert fc is not None
    assert fc["slack"] == cfg.fc_slack and fc["anchor"] > 0
    fc_hist = [h for h in res.state["history"] if "fc" in h]
    assert fc_hist
    within = [h for h in fc_hist if np.isfinite(h["score"])
              and h["score"] <= fc["slack"] * fc["anchor"]]
    if within:  # slack branch: LARGEST qualifying threshold wins
        assert fc["thresh"] == max(h["fc"]["thresh"] for h in within)
    else:  # fallback branch: pure argmin over the fc history
        assert fc["score"] == min(h["score"] for h in fc_hist)
    state = load_state(art)
    assert state["best_fc"] == fc
    spec = fc_spec_from_state(state)
    assert spec.feature_cache == ("residual", fc["thresh"])
    assert spec.mode == "PECE" and spec.tau == fc["tau"]


def test_fc_search_resume_replays_identically(tmp_path):
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(fc_thresholds=(0.01, 0.2), **FC, **SMALL)
    full = search(cfg)
    part = search(cfg, artifact=art, max_units=1)
    assert not part.done and part.best_fc is None
    resumed = search(artifact=art, resume=True)
    assert resumed.done
    assert resumed.state["history"] == full.state["history"]
    assert resumed.state["best_fc"] == full.state["best_fc"]


def test_fc_evaluation_pays_staleness_cost():
    ev = ProgramEvaluator(_objective(), nfe=8, chunk=4)
    never, always = ev.evaluate_fc([(1.0, 1e9), (1.0, 1e-6)])
    assert never > always


def test_tiers_from_artifact_maps_fc_winner_to_draft(tmp_path):
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(fc_thresholds=(0.01, 0.2), **FC, **SMALL)
    search(cfg, artifact=art)
    state = load_state(art)
    assert state["best_fc"] is not None
    tiers = QualityTiers.from_artifact(art)
    assert tiers.resolve("draft") == fc_spec_from_state(state)
    assert tiers.resolve("best") == spec_from_state(state)
    plain = QualityTiers.from_artifact(art, fc_tier=None)
    assert plain.resolve("draft") == default_tiers().resolve("draft")


# ----------------------------------------------------------------- tiers
def _gmm_model():
    return GMMObjective(device="cpu").model_fn("data", SCHED)


def test_default_tiers_resolve_and_validate():
    tiers = default_tiers()
    assert tiers.names() == ["best", "draft", "standard"]
    nfes = {n: tiers.resolve(n).nfe for n in tiers.names()}
    assert nfes["draft"] < nfes["standard"] < nfes["best"]
    with pytest.raises(ValueError, match="unknown quality tier"):
        tiers.resolve("ultra")
    with pytest.raises(TypeError, match="SamplerSpec"):
        QualityTiers({"draft": "not-a-spec"})


def test_tier_request_bitwise_equals_explicit_spec():
    model = _gmm_model()
    tiers = default_tiers()
    e_tier = ServeEngine(model, tiers=tiers, device="cpu")
    e_tier.submit(None, shape=(48, 2), quality_tier="best")
    r_tier = e_tier.run()
    e_spec = ServeEngine(model, device="cpu")
    e_spec.submit(tiers.resolve("best"), shape=(48, 2))
    r_spec = e_spec.run()
    assert r_tier[0].rid == r_spec[0].rid
    assert torch.equal(r_tier[0].x0, r_spec[0].x0)


def test_tiers_from_artifact_serve_searched_program(tmp_path):
    """search -> artifact -> QualityTiers.from_artifact -> serve; the tier
    request runs the searched winner bitwise."""
    art = str(tmp_path / "tune.json")
    cfg = SearchConfig(budget=400, presets=("nfe8-gmm",), **SMALL)
    search(cfg, artifact=art)
    tiers = QualityTiers.from_artifact(art)
    winner_spec = spec_from_state(load_state(art))
    assert tiers.resolve("best") == winner_spec
    assert set(tiers.names()) == {"best", "draft", "standard"}
    model = _gmm_model()
    e_tier = ServeEngine(model, tiers=tiers, device="cpu")
    e_tier.submit(None, shape=(32, 2), quality_tier="best")
    e_spec = ServeEngine(model, device="cpu")
    e_spec.submit(winner_spec, shape=(32, 2))
    assert torch.equal(e_tier.run()[0].x0, e_spec.run()[0].x0)


def test_submit_spec_tier_exclusivity():
    engine = ServeEngine(_gmm_model(), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        engine.submit(default_tiers().resolve("draft"), (8, 2),
                      quality_tier="draft")
    with pytest.raises(ValueError, match="spec"):
        engine.submit(None, (8, 2))


def test_mixed_tier_queue_buckets_by_resolved_spec():
    engine = ServeEngine(_gmm_model(), bucket_sizes=(1, 2, 4), device="cpu")
    engine.submit(None, (16, 2), quality_tier="draft")
    engine.submit(engine.tiers.resolve("draft"), (16, 2))
    results = engine.run()
    assert len(results) == 2
    assert engine.stats()["microbatches"] == 1


def test_tune_cli_smoke(tmp_path, capsys):
    from repro_torch.launch.tune import main
    art = str(tmp_path / "cli.json")
    argv = ["--nfe", "8", "--budget", "300", "--n-samples", "64",
            "--n-seeds", "2", "--presets", "tau-anneal",
            "--evo-generations", "1", "--cd-passes", "1",
            "--artifact", art]
    main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "best score" in out
    assert json.loads(open(art).read())["best"] is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            main(argv)


# ------------------------------------------------- against the reference
def test_evaluator_scores_match_reference(reference):
    """Same draws, same programs: SA PEC and PECE programs (einsum and
    fused), DDIM tau tracks and feature-cache pairs within 1e-5."""
    jobj, tobj = objectives()
    names = ("nfe8-gmm", "tau-anneal", "pece-head")
    for combine in ("einsum", "fused"):
        kw = {"combine": combine}
        progs = [(n, t) for n in names for t in (1.0, 0.4)]
        want = JProgramEvaluator(jobj, nfe=8, chunk=4, spec_kw=kw).evaluate(
            [j_preset(n, 8, tau=t) for n, t in progs])
        got = ProgramEvaluator(tobj, nfe=8, chunk=4, spec_kw=kw).evaluate(
            [program_preset_for_nfe(n, 8, tau=t) for n, t in progs])
        assert rel(got, want) <= REL, (combine, got, want)
    taus = (1.0, 0.5, 0.1)
    want = JProgramEvaluator(jobj, family="ddim", nfe=8, chunk=4).evaluate(
        [j_preset("tau-anneal", 8, tau=t) for t in taus])
    got = ProgramEvaluator(tobj, family="ddim", nfe=8, chunk=4).evaluate(
        [program_preset_for_nfe("tau-anneal", 8, tau=t) for t in taus])
    assert rel(got, want) <= REL, (got, want)
    pairs = [(1.0, 1e-3), (0.5, 0.05), (1.0, 0.5), (0.0, 1e9)]
    want = JProgramEvaluator(jobj, nfe=8, chunk=4).evaluate_fc(pairs)
    got = ProgramEvaluator(tobj, nfe=8, chunk=4).evaluate_fc(pairs)
    assert rel(got, want) <= REL, (got, want)


def test_search_visits_reference_candidates_in_order(reference, tmp_path):
    """``run_search`` at the reference test's SMALL settings on the
    reference's draws: the same candidates in the same order, the same
    winner, scores within 1e-5; each package's ``from_artifact`` of the
    other's artifact gives the same spec, field by field."""
    jobj, tobj = objectives()
    kw = dict(budget=600, presets=("nfe8-gmm",), **SMALL)
    j_art, t_art = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    want = j_run_search(JSearchConfig(**kw), objective=jobj, artifact=j_art)
    got = run_search(SearchConfig(**kw), objective=tobj, artifact=t_art)
    wh, gh = want.state["history"], got.state["history"]
    assert [h["program"] for h in gh] == [h["program"] for h in wh]
    assert rel([h["score"] for h in gh], [h["score"] for h in wh]) <= REL
    assert got.best_program.to_json() == want.best_program.to_json()
    assert got.state["rng"] == want.state["rng"]
    for art in (j_art, t_art):
        assert spec_fields(QualityTiers.from_artifact(art).resolve(
            "best")) == spec_fields(JQualityTiers.from_artifact(
                art).resolve("best"))
    assert spec_fields(QualityTiers.from_artifact(j_art).resolve(
        "best")) == spec_fields(QualityTiers.from_artifact(t_art).resolve(
            "best"))


def test_metrics_match_reference(reference):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(256, 3)).astype(np.float32)
    y = (rng.normal(size=(256, 3)) * 1.3 + 0.2).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    mean, var = np.array([0.1, -0.2, 0.0]), np.array([1.0, 2.0, 0.5])
    np.testing.assert_allclose(
        metrics.gaussian_w2(tx, mean, var),
        j_metrics.gaussian_w2(jnp.asarray(x), mean, var), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.energy_distance(tx, ty),
        j_metrics.energy_distance(jnp.asarray(x), jnp.asarray(y)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        metrics.mean_var_error(tx, mean, var),
        j_metrics.mean_var_error(jnp.asarray(x), mean, var), rtol=1e-6)
    key = jax.random.PRNGKey(4)
    dirs = np.asarray(jax.random.normal(key, (16, 3)))
    got = metrics.sliced_w2_stat(tx, ty, torch.from_numpy(dirs))
    assert got.dim() == 0
    np.testing.assert_allclose(
        float(got), float(j_metrics.sliced_w2_stat(
            jnp.asarray(x), jnp.asarray(y), key, 16)), rtol=1e-6)


# ------------------------------------------------------------ teardown
def test_cache_entry_outliving_its_module_exits_quietly():
    """A model whose compile-cache entry lives until the interpreter exits
    dies while the module's globals are torn down: its eviction callback
    must not fail then ("Exception ignored ... 'NoneType' object is not
    callable")."""
    code = ("import torch\n"
            "from repro_torch.core.samplers import make_sampler\n"
            "s = make_sampler('sa', nfe=5)\n"
            "model = lambda x, t: 0.5 * x\n"
            "s.sample(model, torch.zeros(4, 2))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr
    assert "Exception ignored" not in out.stderr, out.stderr
