"""The port's compile cache against the JAX reference's.

The same call sequences go to both packages, and after every call the
caches' ``hits``, ``misses`` and ``evictions`` must be equal. The
sequences mirror the reference's own cache tests:
``test_samplers.py::test_second_sample_hits_compile_cache_no_retrace``,
``test_hotpath.py``'s precision/history keys and ring tau sweep,
``test_denoiser.py``'s guidance-scale sweep and prediction types,
``test_families.py``'s tau and order-track sweep, and
``test_e2e_dit.py::test_guided_cached_sweep_zero_misses``.

On the CPU an entry runs the eager executor over its buffers (the
tables, x_T, the noise, cond and the scale, copied in per call); the
tests hold that copy-in: a re-plan through an entry equals a fresh
entry's solve bit for bit, and a result is never an entry's buffer. The
card-only tests (marked ``gpu``) hold the CUDA graph: a replay equals the
eager solve bit for bit at dit-s width, with the eager solve's launch
counts; the residual policy stays eager; ``warmup`` captures; a capture
that fails raises. The reference is imported when available, so they run
on a machine with a card and no JAX
(``pytest -m gpu tests/test_torch_compile_cache.py``).
"""

import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import GMM as JGMM
    from repro.core import get_schedule as j_get_schedule
    from repro.core import samplers as jsamplers
    from repro.core.denoiser import Denoiser as JDenoiser
    from repro.core.programs import program_preset_for_nfe as j_preset_for_nfe
    from repro.kernels.ref import denoiser_oracles
    from repro.models.tame import tame_dit as j_tame_dit
    from repro.models.tame import tame_networks as j_tame_networks
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import GMM as TGMM
from repro_torch.core import Denoiser, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.programs import StepProgram, program_preset_for_nfe
from repro_torch.core.samplers import base as tbase
from repro_torch.kernels import ops
from repro_torch.models import TransformerLM
from repro_torch.models.tame import tame_dit, tame_networks

TS, T_GMM = get_schedule("vp_linear"), TGMM.default_2d()
T_MAKERS = {"x0": T_GMM.x0_prediction, "eps": T_GMM.eps_prediction,
            "v": T_GMM.v_prediction}
T = types.SimpleNamespace(samplers=tsamplers, preset=program_preset_for_nfe)
COUNTED = ("hits", "misses", "evictions")
if jax is not None:
    JS, J_GMM = j_get_schedule("vp_linear"), JGMM.default_2d()
    J_NETS = denoiser_oracles(JS, J_GMM)
    J = types.SimpleNamespace(samplers=jsamplers, preset=j_preset_for_nfe)


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def t_net(kind):
    """The oracle as a Denoiser network; ``cond`` shifts the components
    (one [d] shift for the batch, or one per sample of the doubled
    batch)."""
    return lambda x, t, cond: T_MAKERS[kind](
        TS, x, t, shift=None if cond is None else cond[..., None, :])


def dit_models(n_layers=4):
    """The reference's tame smoke DiT and the port's on the converted
    parameters, as guided + feature-cached Denoisers over their
    (network, cached) pairs."""
    jmodel, jparams, mu = j_tame_dit("dit-s", n_layers=n_layers)
    tmodel = TransformerLM(dataclasses.replace(
        get_smoke("dit-s"), n_layers=n_layers, dtype=torch.float32))
    tparams = params_from_jax(jax.device_get(jparams), tmodel)
    jnet, jcached = j_tame_networks(jmodel, jparams, mu)
    tnet, tcached = tame_networks(
        tmodel, tparams, lambda seq: torch.from_numpy(np.array(mu(seq))))
    return (JDenoiser(jnet, JS, prediction="x0", cached=jcached,
                      guidance=True),
            Denoiser(tnet, TS, prediction="x0", cached=tcached,
                     guidance=True))


@dataclasses.dataclass
class Call:
    """One call of a sequence: ``spec(pkg)`` builds the spec from a
    package namespace; ``model`` names a (reference, port) model pair."""

    spec: object
    model: str = "gmm"
    shape: tuple = (64, 2)
    cond: object = None
    scale: float = 1.0
    warmup: bool = False


def _spec(name="sa", nfe=None, **kw):
    """A spec factory for both packages (``program`` a callable of the
    package namespace)."""
    def make(pkg):
        k = dict(kw)
        if callable(k.get("program")):
            k["program"] = k["program"](pkg)
        if nfe is not None:
            return pkg.samplers.SamplerSpec.from_nfe(name, nfe, **k)
        return pkg.samplers.SamplerSpec(name=name, **k)
    return make


def run_sequence(calls, models) -> list:
    """Each call on both packages, from cleared caches; the counted stats
    after every call must be equal. Returns the port's stats after each."""
    jsamplers.clear_compile_cache()
    tsamplers.clear_compile_cache()
    trail = []
    for i, c in enumerate(calls):
        jm, tm = models[c.model]
        js, ts = c.spec(J), c.spec(T)
        jplan, tplan = jsamplers.build_plan(js), tsamplers.build_plan(ts)
        x = np.random.default_rng(i).standard_normal(c.shape).astype(
            np.float32)
        jcond = None if c.cond is None else jnp.asarray(c.cond)
        tcond = None if c.cond is None else torch.from_numpy(c.cond)
        if c.warmup:
            jsamplers.warmup(jplan, jm, c.shape, cond=jcond)
            tsamplers.warmup(tplan, tm, c.shape, cond=tcond, device="cpu")
        else:
            jout = jsamplers.sample(jplan, jm, jnp.asarray(x),
                                    jax.random.PRNGKey(i), cond=jcond,
                                    guidance_scale=c.scale)
            tout = tsamplers.sample(tplan, tm, torch.from_numpy(x),
                                    torch.Generator().manual_seed(i),
                                    cond=tcond, guidance_scale=c.scale)
            assert bool(jnp.all(jnp.isfinite(jout)))
            assert bool(torch.isfinite(tout).all())
        jst, tst = jsamplers.compile_cache_stats(), tsamplers.compile_cache_stats()
        assert {k: tst[k] for k in COUNTED} == {k: jst[k] for k in COUNTED}, \
            (i, jst, tst)
        assert tst["size"] == jst["size"], (i, jst, tst)
        trail.append(tst)
    return trail


def gmm_models():
    return {"gmm": (J_GMM.model_fn(JS, "data"), T_GMM.model_fn(TS, "data"))}


def denoiser_models():
    return {kind: (JDenoiser(J_NETS[kind], JS, prediction=kind),
                   Denoiser(t_net(kind), TS, prediction=kind))
            for kind in ("x0", "eps", "v")} | {
        "guided_eps": (JDenoiser(J_NETS["eps"], JS, prediction="eps",
                                 guidance=True),
                       Denoiser(t_net("eps"), TS, prediction="eps",
                                guidance=True))}


def family_models(family):
    conv = tsamplers.get_family(family).model_convention(
        tsamplers.SamplerSpec.from_nfe(family, 6))
    return {"gmm": (J_GMM.model_fn(JS, conv), T_GMM.model_fn(TS, conv))}


COND = np.asarray([0.8, -0.4], np.float32)
N6 = dict(schedule="vp_linear", n_steps=6)
N5 = dict(schedule="vp_linear", n_steps=5)
DEN = dict(schedule="vp_linear", n_steps=8, tau=0.7)


def _family_sweep(family):
    """``test_families.py``: tau and per-interval order tracks
    (mode-uniform), one executor."""
    calls = [Call(_spec(family, nfe=6, tau=tau), shape=(16, 2))
             for tau in (0.0, 0.7, 1.0)]
    for orders in ("ones", "twos", "ramp"):
        def program(pkg, orders=orders):
            base = pkg.preset("tau-anneal", 6)
            M = base.length()
            track = {"ones": (1,) * M, "twos": (2,) * M,
                     "ramp": tuple(min(i + 1, 3) for i in range(M))}[orders]
            return base.replace(predictor_order=track, width=3)
        calls.append(Call(_spec(family, nfe=6, program=program),
                          shape=(16, 2)))
    return calls


SEQUENCES = {
    # test_samplers.py: second call hits, tau re-plan hits, new shape misses
    "second_sample_and_tau_replan": (gmm_models, [
        Call(_spec(tau=0.5, **N6)), Call(_spec(tau=0.5, **N6)),
        Call(_spec(tau=1.3, **N6)), Call(_spec(tau=0.5, **N6),
                                         shape=(32, 2))],
        {"hits": 2, "misses": 2}),
    # test_hotpath.py: precision and history key the cache
    "precision_and_history_keys": (gmm_models, [
        Call(_spec(**N5), shape=(32, 2)),
        Call(_spec(precision="bf16", **N5), shape=(32, 2)),
        Call(_spec(history="concat", **N5), shape=(32, 2)),
        Call(_spec(combine="fused", **N5), shape=(32, 2))],
        {"misses": 4}),
    # test_hotpath.py: a ring tau sweep reuses one executor
    "ring_tau_sweep": (gmm_models, [
        Call(_spec(tau=tau, **N5), shape=(32, 2))
        for tau in (0.0, 0.5, 1.0, 1.5)], {"misses": 1, "hits": 3}),
    # test_denoiser.py: a guidance-scale sweep, then new cond values
    "guidance_scale_sweep": (denoiser_models, [
        Call(_spec(guidance=True, prediction="eps", **DEN), "guided_eps",
             cond=COND, scale=s) for s in (0.0, 0.5, 1.0, 2.0, 7.5)] + [
        Call(_spec(guidance=True, prediction="eps", **DEN), "guided_eps",
             cond=np.ones(2, np.float32), scale=3.3)],
        {"misses": 1, "hits": 5}),
    # test_denoiser.py: each prediction type owns an entry
    "prediction_types": (denoiser_models, [
        Call(_spec(**DEN), kind) for kind in ("x0", "eps", "v")],
        {"misses": 3}),
    # test_families.py: tau and order-track sweeps, one miss per family
    **{f"family_sweep_{f}": (lambda f=f: family_models(f), _family_sweep(f),
                             {"misses": 1, "hits": 5})
       for f in ("sa", "seeds", "dpmpp_multistep")},
    # warmup builds the entry; the sample after it is a hit
    "warmup_then_sample": (gmm_models, [
        Call(_spec(tau=0.5, **N6), warmup=True),
        Call(_spec(tau=0.5, **N6), warmup=True),
        Call(_spec(tau=0.9, **N6))], {"misses": 1, "hits": 2}),
    # a new step count: a hit in the same entry (another graph signature)
    "step_count_is_a_hit": (gmm_models, [
        Call(_spec(tau=0.5, **N6)),
        Call(_spec(tau=0.5, schedule="vp_linear", n_steps=9))],
        {"misses": 1, "hits": 1}),
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_cache_stats_follow_the_reference(reference, name):
    models, calls, want = SEQUENCES[name]
    trail = run_sequence(calls, models())
    assert {k: trail[-1][k] for k in want} == want
    assert trail[-1]["graphs"] == 0  # the CPU captures nothing


def test_guided_cached_sweep_follows_the_reference(reference):
    """``test_e2e_dit.py``: tau, guidance scale and the residual threshold
    are data, so a sweep over all three on a guided + cached Denoiser is
    one entry and one graph signature (on the card, one graph); no call
    runs outside the entry's graph path (the residual decides on the
    device)."""
    jd, td = dit_models()
    prompt = 0.1 * np.random.default_rng(7).standard_normal(
        (16, 8)).astype(np.float32)
    calls = [Call(_spec(nfe=6, tau=tau, guidance=True,
                        feature_cache=("residual", th),
                        schedule="vp_linear"),
                  "dit", shape=(2, 16, 8), cond=prompt, scale=s)
             for tau in (0.0, 0.7) for s in (1.0, 3.0) for th in (0.02, 0.08)]
    trail = run_sequence(calls, {"dit": (jd, td)})
    assert trail[-1]["misses"] == 1 and trail[-1]["hits"] == 7
    assert trail[-1]["aot_fallbacks"] == 0
    (entry,) = tbase._COMPILE_CACHE.values()
    assert len(entry.runs) == 1


def test_lru_bound_follows_the_reference(reference, monkeypatch):
    """Past ``_COMPILE_CACHE_MAX`` entries the oldest goes (not counted as
    an eviction, as in the reference), and a call of it misses again."""
    monkeypatch.setattr(jsamplers.base, "_COMPILE_CACHE_MAX", 2)
    monkeypatch.setattr(tbase, "_COMPILE_CACHE_MAX", 2)
    trail = run_sequence(
        [Call(_spec(**DEN), kind) for kind in ("x0", "eps", "v", "x0")],
        denoiser_models())
    assert [t["size"] for t in trail] == [1, 2, 2, 2]
    assert trail[-1]["misses"] == 4 and trail[-1]["evictions"] == 0


def test_entry_evicted_when_the_model_dies(reference):
    """The entry holds no strong reference to the model: once the caller
    drops it, it is collected and its entry evicted, in both packages."""
    payload = torch.ones((128, 2))

    def t_model(x, t, _p=payload):
        return T_GMM.model_fn(TS, "data")(x, t) + 0.0 * _p[0, 0]

    j_payload = jnp.ones((128, 2))

    def j_model(x, t, _p=j_payload):
        return J_GMM.model_fn(JS, "data")(x, t) + 0.0 * _p[0, 0]

    run_sequence([Call(_spec(tau=0.5, **N5))], {"gmm": (j_model, t_model)})
    wt, wj = weakref.ref(t_model), weakref.ref(j_model)
    del t_model, j_model
    gc.collect()
    assert wt() is None and wj() is None
    jst, tst = jsamplers.compile_cache_stats(), tsamplers.compile_cache_stats()
    assert tst["size"] == jst["size"] == 0
    assert tst["evictions"] == jst["evictions"] == 1


class _Oracle:
    """A model as a bound method (weakly referenced as a WeakMethod)."""

    def __call__(self, x, t):
        return T_GMM.model_fn(TS, "data")(x, t)

    def predict(self, x, t):
        return self(x, t)


class _Pinned:
    """A model that cannot be weakly referenced: keyed by identity and
    held strongly by its entry."""

    __slots__ = ()

    def __call__(self, x, t):
        return T_GMM.model_fn(TS, "data")(x, t)


@pytest.mark.parametrize("kind", ["method", "pinned"])
def test_model_identity_kinds(kind):
    """A bound method hits across its transient method objects and is
    evicted with its instance; a model that cannot be weakly referenced
    hits by identity and stays pinned."""
    obj = _Oracle() if kind == "method" else _Pinned()
    model = (lambda: obj.predict) if kind == "method" else (lambda: obj)
    plan, x = _plan(tau=0.5), _x()
    tsamplers.clear_compile_cache()
    a = tsamplers.sample(plan, model(), x, noise=_noise(6))
    b = tsamplers.sample(plan, model(), x, noise=_noise(6))
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"]) == (1, 1) and torch.equal(a, b)
    del obj, model
    gc.collect()
    stats = tsamplers.compile_cache_stats()
    assert (stats["size"], stats["evictions"]) == (
        (0, 1) if kind == "method" else (1, 0))


# ------------------------------------------------------------ copy-in
def _plan(**kw):
    return tsamplers.build_plan(tsamplers.SamplerSpec(**{**N6, **kw}))


def _x(seed=0, shape=(64, 2)):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _noise(M, shape=(64, 2), seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (M,) + shape).astype(np.float32))


@pytest.mark.parametrize("kw", [dict(combine="einsum"),
                                dict(combine="fused"),
                                dict(combine="kernel", mode="PECE"),
                                dict(combine="fused", precision="bf16")])
def test_replan_through_the_entry_equals_a_fresh_build(kw):
    """A tau re-plan at one step count is a hit whose tables are copied
    into the entry: its solve equals a fresh entry's bit for bit."""
    model = T_GMM.model_fn(TS, "data")
    x, xi = _x(), _noise(6)
    tsamplers.clear_compile_cache()
    tsamplers.sample(_plan(tau=0.3, **kw), model, x, noise=xi)
    replanned = tsamplers.sample(_plan(tau=1.2, **kw), model, x, noise=xi)
    assert tsamplers.compile_cache_stats()["hits"] == 1
    tsamplers.clear_compile_cache()
    fresh = tsamplers.sample(_plan(tau=1.2, **kw), model, x, noise=xi)
    assert tsamplers.compile_cache_stats()["misses"] == 1
    assert torch.equal(replanned, fresh)


def test_cond_and_scale_are_copied_in():
    """New cond values and a new scale reach the solve through the entry's
    buffers: the hit equals a fresh entry's solve bit for bit."""
    den = Denoiser(t_net("eps"), TS, prediction="eps", guidance=True)
    plan = tsamplers.build_plan(tsamplers.SamplerSpec(
        guidance=True, prediction="eps", **DEN))
    x, xi = _x(), _noise(8)
    c1, c2 = torch.tensor([0.8, -0.4]), torch.tensor([-0.2, 0.6])
    tsamplers.clear_compile_cache()
    tsamplers.sample(plan, den, x, noise=xi, cond=c1, guidance_scale=2.0)
    hit = tsamplers.sample(plan, den, x, noise=xi, cond=c2,
                           guidance_scale=torch.tensor(4.0))
    tsamplers.clear_compile_cache()
    fresh = tsamplers.sample(plan, den, x, noise=xi, cond=c2,
                             guidance_scale=4.0)
    assert torch.equal(hit, fresh)


def test_result_is_not_an_entry_buffer():
    model = T_GMM.model_fn(TS, "data")
    plan = _plan(tau=0.5, denoise_final=False)
    tsamplers.clear_compile_cache()
    a = tsamplers.sample(plan, model, _x(), noise=_noise(6))
    (entry,) = tbase._COMPILE_CACHE.values()
    (run,) = entry.runs.values()
    buffers = [entry.x, entry.scale, run.noise] + [
        v for v in run.arrays.values() if isinstance(v, torch.Tensor)]
    ptrs = {t.untyped_storage().data_ptr() for t in buffers}
    assert a.untyped_storage().data_ptr() not in ptrs
    keep = a.clone()
    b = tsamplers.sample(plan, model, _x(2), noise=_noise(6, seed=3))
    assert torch.equal(a, keep) and not torch.equal(a, b)


def test_default_noise_is_one_draw_of_the_buffer():
    """The default source draws the [M, *shape] buffer at once from the
    generator: it equals ``noise=`` of the same draw, as a tensor or as a
    callable."""
    model = T_GMM.model_fn(TS, "data")
    plan, x = _plan(tau=1.0), _x()
    draw = torch.randn((6, 64, 2), generator=torch.Generator().manual_seed(7))
    a = tsamplers.sample(plan, model, x, torch.Generator().manual_seed(7))
    b = tsamplers.sample(plan, model, x, noise=draw)
    c = tsamplers.sample(plan, model, x, noise=lambda i: draw[i])
    assert torch.equal(a, b) and torch.equal(a, c)
    d = tsamplers.sample(plan, model, x)  # a generator seeded 0
    e = tsamplers.sample(plan, model, x, torch.Generator().manual_seed(0))
    assert torch.equal(d, e) and not torch.equal(a, d)


def test_noise_buffer_shape_is_checked():
    with pytest.raises(ValueError, match=r"\[M, \*x_T.shape\]"):
        tsamplers.sample(_plan(), T_GMM.model_fn(TS, "data"), _x(),
                         noise=torch.zeros(5, 64, 2))


def test_graph_signatures_of_one_entry():
    """One entry, one run per graph signature: the step count, and the
    host flags the loop branches on (the interval policy's refresh tuple,
    the cond fallback's PECE tuple); a tau re-plan shares its run."""
    tsamplers.clear_compile_cache()
    model = T_GMM.model_fn(TS, "data")
    x = _x()
    for kw in (dict(tau=0.2), dict(tau=0.9), dict(tau=0.2, n_steps=9)):
        tsamplers.sample(_plan(**kw), model, x)
    (entry,) = tbase._COMPILE_CACHE.values()
    assert len(entry.runs) == 2
    modes = ("P", "PECE") * 3  # six segments: the cond fallback
    for first in (0, 1):
        plan = tsamplers.build_plan(tsamplers.SamplerSpec(
            schedule="vp_linear", n_steps=6,
            program=StepProgram(mode=modes[first:] + modes[:first])))
        tsamplers.sample(plan, model, x)
    stats = tsamplers.compile_cache_stats()
    assert stats["misses"] == 2 and stats["hits"] == 3
    cond_entry = list(tbase._COMPILE_CACHE.values())[-1]
    assert cond_entry.statics[1] == ("cond",)
    assert len(cond_entry.runs) == 2


def cached_dit(n_layers=4, device="cpu"):
    """The port's tame dit-s (smoke width on the CPU, full width on the
    card), unguided, with its feature-cached twin."""
    model, params, mu = tame_dit("dit-s", smoke=device == "cpu",
                                 n_layers=n_layers, device=device)
    net, cached = tame_networks(model, params, mu)
    return Denoiser(net, TS, prediction="x0", cached=cached)


def test_interval_refresh_flags_sign_the_graph():
    """Intervals 2 and 3 at one step count share the entry (the policy is
    plan data) but not a graph signature (their refresh tuples differ)."""
    den = cached_dit()
    tsamplers.clear_compile_cache()
    x = _x(shape=(2, 16, 8))
    outs = {}
    for k in (2, 3, 2):
        plan = tsamplers.build_plan(tsamplers.SamplerSpec.from_nfe(
            "sa", 6, feature_cache=k, schedule="vp_linear"))
        outs.setdefault(k, []).append(tsamplers.sample(plan, den, x))
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"]) == (1, 2)
    (entry,) = tbase._COMPILE_CACHE.values()
    assert sorted(dict(sig)["fc_refresh"] for sig in entry.runs) == sorted(
        tsamplers.build_plan(tsamplers.SamplerSpec.from_nfe(
            "sa", 6, feature_cache=k, schedule="vp_linear")
        ).arrays["fc_refresh"] for k in (2, 3))
    assert torch.equal(*outs[2]) and not torch.equal(outs[2][0], outs[3][0])


@pytest.mark.parametrize("policy,fallbacks", [(2, 0), (("residual", 0.05), 0)])
def test_eager_calls_count_as_fallbacks(policy, fallbacks):
    """Only a call inside ``eager()`` counts in ``aot_fallbacks``: not a
    plain CPU call, and not the residual policy's (its refresh is decided
    on the device, so on the card it is captured like the interval
    policy)."""
    td = cached_dit()
    plan = tsamplers.build_plan(tsamplers.SamplerSpec.from_nfe(
        "sa", 6, feature_cache=policy, schedule="vp_linear"))
    x = _x(shape=(2, 16, 8))
    tsamplers.clear_compile_cache()
    a = tsamplers.sample(plan, td, x)
    b = tsamplers.sample(plan, td, x)
    assert tsamplers.compile_cache_stats()["aot_fallbacks"] == fallbacks
    with tsamplers.eager():
        c = tsamplers.sample(plan, td, x)
    stats = tsamplers.compile_cache_stats()
    assert stats["aot_fallbacks"] == fallbacks + 1 and stats["hits"] == 2
    assert torch.equal(a, b) and torch.equal(a, c)


def test_warmup_on_the_cpu_builds_the_entry_only():
    model = T_GMM.model_fn(TS, "data")
    plan = _plan(tau=0.5)
    tsamplers.clear_compile_cache()
    tsamplers.warmup(plan, model, (64, 2), device="cpu")
    tsamplers.warmup(plan, model, (64, 2), device="cpu")
    tsamplers.sample(plan, model, _x())
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"], stats["graphs"]) == (1, 2, 0)
    (entry,) = tbase._COMPILE_CACHE.values()
    assert len(entry.runs) == 1


# --------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_dit(card, n_layers=4):
    """The tame dit-s at full width (384, 6 heads of 64; flash) on the
    card, unguided, with its feature-cached twin, and an x_T from a
    seed."""
    x = torch.randn((4, 128, 16),
                    generator=torch.Generator(card).manual_seed(1),
                    device=card)
    return cached_dit(n_layers, card), x


def _counted(fn):
    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
@pytest.mark.parametrize("combine,precision", [("fused", "f32"),
                                               ("kernel", "bf16"),
                                               ("einsum", "f32")])
def test_replay_equals_eager_on_card(card, combine, precision):
    """The first call runs the eager warm-up and captures; the second
    replays. Both equal an ``eager()`` solve bit for bit, with its launch
    counts; a tau re-plan replays the same graph."""
    den, x = _card_dit(card)
    spec = dict(nfe=10, schedule="vp_linear", combine=combine,
                precision=precision, prediction="x0")
    s = tsamplers.make_sampler("sa", tau=1.0, **spec)
    xi = torch.randn((s.spec.n_steps,) + tuple(x.shape),
                     generator=torch.Generator(card).manual_seed(2),
                     device=card)
    tsamplers.clear_compile_cache()
    first, l_first = _counted(lambda: s.sample(den, x, noise=xi))
    replay, l_replay = _counted(lambda: s.sample(den, x, noise=xi))
    with tsamplers.eager():
        ref, l_eager = _counted(lambda: s.sample(den, x, noise=xi))
    assert torch.equal(first, ref) and torch.equal(replay, ref)
    assert l_first == l_replay == l_eager and l_eager["flash_attention"] > 0
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"], stats["graphs"],
            stats["aot_fallbacks"]) == (1, 2, 1, 1)
    replanned = tsamplers.make_sampler("sa", tau=0.5, **spec)
    got = replanned.sample(den, x, noise=xi)
    assert tsamplers.compile_cache_stats()["graphs"] == 1
    tsamplers.clear_compile_cache()
    with tsamplers.eager():
        assert torch.equal(got, replanned.sample(den, x, noise=xi))


@pytest.mark.gpu
def test_residual_policy_is_captured_on_card(card):
    """The residual policy is captured (its refresh gate a conditional
    node): no fallback outside ``eager()``, each replay equals the eager
    solve bit for bit, and a threshold sweep replays the one graph, each
    threshold equal to its own eager solve."""
    den, x = _card_dit(card, n_layers=6)

    def sampler(th):
        return tsamplers.make_sampler("sa", nfe=10, schedule="vp_linear",
                                      combine="fused", prediction="x0",
                                      feature_cache=("residual", th))

    s = sampler(0.05)
    tsamplers.clear_compile_cache()
    a = s.sample(den, x)
    b = s.sample(den, x)
    stats = tsamplers.compile_cache_stats()
    assert stats["graphs"] == 1 and stats["aot_fallbacks"] == 0
    with tsamplers.eager():
        ref = s.sample(den, x)
    assert torch.equal(a, ref) and torch.equal(b, ref)
    outs = {}
    for th in (0.0, 0.02, 0.08, 1e9):
        outs[th] = sampler(th).sample(den, x)
        with tsamplers.eager():
            assert torch.equal(outs[th], sampler(th).sample(den, x)), th
    stats = tsamplers.compile_cache_stats()
    assert stats["graphs"] == 1 and stats["misses"] == 1
    assert not torch.equal(outs[0.0], outs[1e9])


@pytest.mark.gpu
def test_warmup_then_sample_is_a_hit_on_card(card):
    den, x = _card_dit(card)
    s = tsamplers.make_sampler("sa", nfe=10, schedule="vp_linear",
                               combine="fused", prediction="x0",
                               feature_cache=2)
    tsamplers.clear_compile_cache()
    tsamplers.warmup(s.plan, den, tuple(x.shape))
    tsamplers.warmup(s.plan, den, tuple(x.shape))
    assert tsamplers.compile_cache_stats()["graphs"] == 1
    out, launches = _counted(lambda: s.sample(den, x))
    stats = tsamplers.compile_cache_stats()
    assert (stats["misses"], stats["hits"], stats["graphs"]) == (1, 2, 1)
    with tsamplers.eager():
        ref, l_eager = _counted(lambda: s.sample(den, x))
    assert torch.equal(out, ref) and launches == l_eager


@pytest.mark.gpu
def test_capture_failure_raises_on_card(card):
    """A model that reads the device back cannot be captured: the call
    raises, naming the family and the CUDA error, and runs no eager
    retry."""
    model = T_GMM.model_fn(TS, "data")

    def syncing(x, t):
        if float(x.abs().max()) > 1e9:  # a host read: not capturable
            raise AssertionError
        return model(x, t)

    s = tsamplers.make_sampler("sa", nfe=6, schedule="vp_linear")
    tsamplers.clear_compile_cache()
    with pytest.raises(RuntimeError, match="CUDA graph capture of the 'sa'"):
        s.sample(syncing, torch.zeros((64, 2), device=card))
