"""The port's step protocol, ``sample_batched`` and trajectories against
the JAX reference.

Mirrors ``tests/test_stepwise.py``: driving requests tick by tick through
``make_stepfns``/``fresh_carry`` (staggered joins into a shared carry
included) reproduces the whole-solve ``sample_batched``, and both match
the reference's whole solve and its stepwise drive on the same inputs: a
numpy-free seed for both (the reference's ``x_T`` and its per-step draws,
``split(key, M)`` and one f32 normal each, injected into the port).

The model is the reference's fusion-stable ``0.3 x cos(t)``, lane-batched
in the port (one ``t`` per lane). Tolerances, relative in norm as in
``tests/test_torch_samplers.py``: 1e-5 for f32 solves and trajectories,
1e-2 at bf16 (the reference's bf16 bar); the two frameworks' cos (and the
GMM oracle's exp/log chain) differ by ulps, which compound over steps.

The port's own contracts are bitwise on the CPU: the step protocol against
``sample_batched`` under the ``kernel`` and ``fused`` combines (every op
elementwise per lane), join invisibility (staggered joins), the disabled
early exit, and a lane slice of the lane-batched plain combines against
their solo call. Under the ``einsum`` combine the stepwise contraction runs
over [L, P] coefficient rows where the whole solve runs one [P] row over
the stacked lanes; torch's CPU contraction rounds those differently by an
ulp, so that comparison is held at 1e-6 relative. The card-only tests
(marked ``gpu``) hold the lane-batched combine kernels and the captured
tick.
"""

import types

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import GMM as JGMM
    from repro.core import StepProgram as JStepProgram
    from repro.core import get_schedule as j_get_schedule
    from repro.core import samplers as jsamplers
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.core import GMM as TGMM
from repro_torch.core import CachedNetwork, Denoiser, StepProgram, get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.denoiser import lane_view
from repro_torch.core.samplers import base as tbase
from repro_torch.core.samplers.stepwise import carry_leaves
from repro_torch.kernels import ops
from repro_torch.kernels import sa_fused as t_fused_mod
from repro_torch.kernels import sa_update as t_update_mod

CPU = torch.device("cpu")
TS = get_schedule("vp_linear")
SHAPE = (48, 2)
T = types.SimpleNamespace(samplers=tsamplers, StepProgram=StepProgram)
if jax is not None:
    JS = j_get_schedule("vp_linear")
    J = types.SimpleNamespace(samplers=jsamplers, StepProgram=JStepProgram)
    J_GMM = JGMM.default_2d().model_fn(JS, "data")


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def ident(x, t):
    return x


def t_stable(x, t):
    """The port's lane-batched fusion-stable model: one t per lane."""
    return 0.3 * x * lane_view(torch.cos(t), x)


def j_stable(x, t):
    return 0.3 * x * jnp.cos(t)


def t_stable32(x, t):
    """``t_stable`` computed in f32 whatever the carry: on a bf16 ``x``
    torch multiplies by 0.3 in f32 where JAX first rounds 0.3 to bf16, a
    0.26% gap of the model itself per evaluation."""
    return t_stable(x.float(), t)


def j_stable32(x, t):
    return j_stable(x.astype(jnp.float32), t)


def t_gmm(x, t):
    """The GMM oracle's score per lane (the oracle takes one t)."""
    model = TGMM.default_2d().model_fn(TS, "data")
    return torch.stack([model(x[l], t[l]) for l in range(x.shape[0])])


def spec(pkg, **kw):
    kw.setdefault("name", "sa")
    kw.setdefault("schedule", TS if pkg is T else JS)
    kw.setdefault("n_steps", 6)
    kw.setdefault("tau", 0.7)
    if callable(kw.get("program")):
        kw["program"] = kw["program"](pkg)
    return pkg.samplers.SamplerSpec(**kw)


def ref_inputs(jplan, n, shape=SHAPE, dtype=None):
    """The reference test's whole-solve inputs: x_T [n, *shape] and the
    solve keys [n]."""
    dtype = jnp.float32 if dtype is None else dtype
    scale = jplan.spec.resolve_schedule().prior_scale(float(jplan.ts[0]))
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    xT = jax.vmap(lambda k: scale * jax.random.normal(k, shape, dtype))(keys)
    return xT, jax.random.split(jax.random.PRNGKey(4), n)


def ref_noise(solve_keys, M, shape=SHAPE) -> torch.Tensor:
    """The reference's per-step draws of each request, [n, M, *shape]:
    ``split(key, M)`` and one f32 normal per step."""
    draw = jax.vmap(lambda sk: jax.vmap(
        lambda k: jax.random.normal(k, shape, jnp.float32))(
            jax.random.split(sk, M)))
    return torch.from_numpy(np.array(draw(solve_keys)))


def to_torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def t_drive(plan, xT, noise, *, model=t_stable, lanes=None, stagger=None,
            tol=0.0, min_i=0, stream=False, max_ticks=200, shape=SHAPE,
            after_tick=None):
    """The port's requests through the step protocol to completion.
    ``stagger[b]`` delays request b's join to that tick; ``after_tick(
    carry, aux)`` sees every tick. Returns (x_final per request, steps per
    request, previews per request)."""
    n = xT.shape[0]
    lanes = n if lanes is None else lanes
    stagger = [0] * n if stagger is None else list(stagger)
    fns = tsamplers.make_stepfns(plan, model, shape, xT.dtype, lanes,
                                 stream=stream, device="cpu")
    arrays = fns.adapter.arrays(plan, CPU)
    carry = tsamplers.fresh_carry(plan, lanes, shape, xT.dtype,
                                  model_fn=model, device="cpu")
    done, steps = {}, {}
    previews = {b: [] for b in range(n)}
    owner = [None] * lanes
    for tick in range(max_ticks):
        for b in range(n):
            if stagger[b] == tick:
                lane = owner.index(None)
                owner[lane] = b
                fns.join(arrays, carry, lane, xT[b], noise[b], tol, min_i,
                         1.0)
        if all(o is None for o in owner):
            if len(done) == n:
                break
            continue
        carry, aux = fns.step(arrays, carry)
        if after_tick is not None:
            after_tick(carry, aux)
        for lane, b in enumerate(owner):
            if b is None:
                continue
            if stream and aux["stepped"][lane]:
                previews[b].append(aux["x0"][lane].clone())
            if aux["finished"][lane]:
                done[b] = carry["x_final"][lane].clone()
                steps[b] = int(aux["i"][lane])
                owner[lane] = None
    assert len(done) == n, f"unfinished after {max_ticks} ticks"
    return ([done[b] for b in range(n)], [steps[b] for b in range(n)],
            [previews[b] for b in range(n)])


def j_drive(plan, xT, solve_keys, *, model=None, lanes=None, stagger=None,
            tol=0.0, min_i=0, stream=False, max_ticks=200, shape=SHAPE):
    """The reference test's drive, on the reference's step protocol."""
    model = j_stable if model is None else model
    n = xT.shape[0]
    lanes = n if lanes is None else lanes
    stagger = [0] * n if stagger is None else list(stagger)
    fns = jsamplers.make_stepfns(plan, model, shape, xT.dtype, lanes,
                                 stream=stream)
    arrays = fns.adapter.arrays(plan)
    M = fns.adapter.n_steps_of(arrays)
    carry = jsamplers.fresh_carry(plan, lanes, shape, xT.dtype,
                                  model_fn=model)
    done, steps = {}, {}
    previews = {b: [] for b in range(n)}
    owner = [None] * lanes
    for tick in range(max_ticks):
        for b in range(n):
            if stagger[b] == tick:
                lane = owner.index(None)
                owner[lane] = b
                carry = fns.join(arrays, carry, lane, xT[b],
                                 jax.random.split(solve_keys[b], M), tol,
                                 min_i, 1.0)
        if all(o is None for o in owner):
            if len(done) == n:
                break
            continue
        carry, aux = fns.step(arrays, carry)
        fin, stepped, idx = jax.device_get((aux["finished"], aux["stepped"],
                                            aux["i"]))
        for lane, b in enumerate(owner):
            if b is None:
                continue
            if stream and stepped[lane]:
                previews[b].append(np.asarray(aux["x0"][lane]))
            if fin[lane]:
                done[b] = np.asarray(carry["x_final"][lane], np.float32)
                steps[b] = int(idx[lane])
                owner[lane] = None
    return ([done[b] for b in range(n)], [steps[b] for b in range(n)],
            [previews[b] for b in range(n)])


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_f32_close(got, ref, tol=1e-5):
    assert rel(got, ref) <= tol


def check_against_reference(kw, *, stagger=None, lanes=None, dtype="f32",
                            j_model=None, t_model=t_stable, stepwise_ref=True):
    """One spec through: the reference's sample_batched (and stepwise
    drive), the port's sample_batched and the port's step protocol on the
    reference's inputs. Returns the port's stepwise results and its
    sample_batched result."""
    jplan = jsamplers.build_plan(spec(J, **kw))
    tplan = tsamplers.build_plan(spec(T, **kw))
    bf16 = dtype == "bf16"
    jxT, skeys = ref_inputs(jplan, 3, dtype=jnp.bfloat16 if bf16 else None)
    ref = np.asarray(jsamplers.sample_batched(
        jplan, j_stable if j_model is None else j_model, jxT, skeys),
        np.float32)
    xT = to_torch(jxT, torch.bfloat16 if bf16 else torch.float32)
    noise = ref_noise(skeys, tplan.spec.n_steps)
    batched = tsamplers.sample_batched(tplan, t_model, xT, noise=noise)
    got, steps, _ = t_drive(tplan, xT, noise, model=t_model, stagger=stagger,
                            lanes=lanes)
    assert all(s == tplan.spec.n_steps for s in steps)
    refs = [ref]
    if stepwise_ref:
        jgot, _, _ = j_drive(jplan, jxT, skeys, model=j_model,
                             stagger=stagger, lanes=lanes)
        refs.append(np.stack(jgot))
    for r in refs:
        for b in range(3):
            if bf16:
                assert rel(got[b].float(), r[b]) < 1e-2
            else:
                assert_f32_close(got[b], r[b])
        if bf16:
            assert rel(batched.float(), r) < 1e-2
        else:
            assert_f32_close(batched, r)
    return got, batched


def assert_port_contract(got, batched, combine):
    """The port's step protocol against its sample_batched: bitwise under
    the elementwise combines, 1e-6 relative under einsum (see the module
    docstring)."""
    for b in range(len(got)):
        if combine == "einsum":
            assert rel(got[b].float(), batched[b].float()) < 1e-6
        else:
            assert torch.equal(got[b], batched[b]), f"request {b} diverged"


# ------------------------------------------------------ SA parity
@pytest.mark.parametrize("combine", ["einsum", "kernel", "fused"])
@pytest.mark.parametrize("mode,corr", [("PEC", 3), ("PEC", 0), ("PECE", 3),
                                       ("PECE", 1)])
def test_sa_stepwise_matches_reference(reference, mode, corr, combine):
    """SA through the step protocol equals the reference's whole solve and
    stepwise drive, PEC/PECE with and without a corrector, under each
    combine; and the port's own whole solve bit for bit."""
    kw = dict(mode=mode, corrector_order=corr, combine=combine)
    got, batched = check_against_reference(
        kw, stepwise_ref=combine == "einsum")
    assert_port_contract(got, batched, combine)


@pytest.mark.parametrize("combine", ["kernel", "fused"])
def test_sa_stepwise_six_row_history_matches_reference(reference, combine):
    """P6C6 over 8 steps, wider than the combine kernels' template
    instances (the card's runtime-P kernel): the lane-batched entries of
    ``sample_batched`` and of the step protocol against the reference's
    solve of the same combine (its Pallas kernels in interpret mode under
    the lane vmap) on its draws, and the port's two bit for bit."""
    kw = dict(predictor_order=6, corrector_order=6, n_steps=8,
              combine=combine)
    got, batched = check_against_reference(kw, stepwise_ref=False)
    assert_port_contract(got, batched, combine)


def test_sa_stepwise_bf16_and_no_denoise(reference):
    got, batched = check_against_reference(
        dict(precision="bf16", combine="fused"), dtype="bf16")
    assert_port_contract(got, batched, "fused")
    got, batched = check_against_reference(
        dict(denoise_final=False, combine="fused"))
    assert_port_contract(got, batched, "fused")


def test_sa_stepwise_under_staggered_joins(reference):
    """Mid-flight joins into a shared carry (other lanes mid-solve) perturb
    nobody: each request's bytes equal its unstaggered run (join
    invisibility), and the reference's staggered drive."""
    kw = dict(combine="fused")
    got, _ = check_against_reference(kw, stagger=[0, 3, 5], lanes=4)
    _, tplan, _, _, xT, noise = _inputs(kw, 3)
    flat, _, _ = t_drive(tplan, xT, noise, lanes=4)
    for b in range(3):
        assert torch.equal(got[b], flat[b]), f"request {b} moved"


def test_sa_stepwise_gmm_model_float_tolerance(reference):
    """An arbitrary model (the GMM score, per lane in the port) at float
    tolerance against the reference's solves."""
    check_against_reference(dict(combine="fused"), j_model=J_GMM,
                            t_model=t_gmm, stepwise_ref=False)


def test_sa_stepwise_multi_segment_program(reference):
    """A mode-switching program (P/PEC/PECE segments: the per-step cond
    path in the tick) against the reference, and bitwise against the
    port's segment-wise whole solve."""
    def prog(pkg):
        return pkg.StepProgram(mode=("P", "P", "PEC", "PEC", "PECE", "PECE"),
                               tau=(1.0, 1.0, 0.4, 0.4, 0.7, 0.7))
    for combine in ("fused", "kernel"):
        got, batched = check_against_reference(
            dict(program=prog, combine=combine),
            stepwise_ref=combine == "fused")
        assert_port_contract(got, batched, combine)


@pytest.mark.parametrize("name", ["seeds", "dpmpp_multistep"])
def test_other_families_stepwise_match_reference(reference, name):
    """SEEDS and DPM-Solver++ (P3, no corrector) through the step
    protocol, against the reference's whole solve and stepwise drive."""
    got, batched = check_against_reference(
        dict(name=name, tau=1.0, corrector_order=0, combine="fused"))
    assert_port_contract(got, batched, "fused")


BASELINES = ("ddim", "ddpm_ancestral", "dpm_solver_pp_2m", "euler_maruyama",
             "edm_heun", "edm_stochastic")


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_stepwise_matches_reference(reference, name, precision):
    """Each baseline's adapter through the step protocol against the
    reference's whole solve and stepwise drive (1e-5 in f32, 1e-2 in
    bf16), and against the port's own whole solve at the reference's
    step-vs-solve bar (rtol and atol 2e-5, ``tests/test_stepwise.py``),
    which promises no bitwise equality for the baselines. The model
    computes in f32 (``t_stable32``), so that in bf16 the frameworks'
    models agree and the gap is the samplers'."""
    kw = dict(name=name, tau=1.0, precision=precision)
    got, batched = check_against_reference(kw, dtype=precision,
                                           j_model=j_stable32,
                                           t_model=t_stable32)
    assert tsamplers.stepwise_supported(spec(T, **kw))
    for b in range(3):
        if precision == "f32":
            np.testing.assert_allclose(got[b].numpy(), batched[b].numpy(),
                                       rtol=2e-5, atol=2e-5)
        else:
            assert rel(got[b].float(), batched[b].float()) < 1e-2


@pytest.mark.parametrize("name", ["dpm_solver_pp_2m", "edm_stochastic"])
def test_baseline_stepwise_under_staggered_joins(reference, name):
    """Joins into a shared carry mid-solve leave a baseline lane's bytes as
    they are without the stagger, and match the reference's staggered
    drive."""
    kw = dict(name=name, tau=1.0)
    got, _ = check_against_reference(kw, stagger=[0, 3, 5], lanes=4)
    _, tplan, _, _, xT, noise = _inputs(kw, 3)
    flat, _, _ = t_drive(tplan, xT, noise, lanes=4)
    for b in range(3):
        assert torch.equal(got[b], flat[b]), f"request {b} moved"


# ----------------------------------------------------------- early exit
def _inputs(kw, n):
    jplan = jsamplers.build_plan(spec(J, **kw))
    tplan = tsamplers.build_plan(spec(T, **kw))
    jxT, skeys = ref_inputs(jplan, n)
    return jplan, tplan, jxT, skeys, to_torch(jxT), ref_noise(
        skeys, tplan.spec.n_steps)


def test_early_exit_fires_after_min_steps(reference):
    """A generous tolerance retires lanes right at min_i, as in the
    reference; the early result is the reference's early result."""
    kw = dict(n_steps=10, mode="PECE", combine="fused")
    jplan, tplan, jxT, skeys, xT, noise = _inputs(kw, 2)
    full, steps_full, _ = t_drive(tplan, xT, noise, tol=0.0, min_i=4)
    assert steps_full == [10, 10]
    early, steps_early, _ = t_drive(tplan, xT, noise, tol=1e3, min_i=4)
    assert steps_early == [4, 4]
    jearly, jsteps, _ = j_drive(jplan, jxT, skeys, tol=1e3, min_i=4)
    assert jsteps == [4, 4]
    for b in range(2):
        assert torch.isfinite(early[b]).all()
        assert not torch.equal(early[b], full[b])
        assert_f32_close(early[b], jearly[b])


def test_early_exit_disabled_is_exact():
    """tol <= 0 never fires, so the early-exit machinery adds nothing: both
    drives equal the whole solve bit for bit."""
    tplan = tsamplers.build_plan(spec(T, n_steps=5, combine="fused"))
    g = torch.Generator().manual_seed(0)
    xT = torch.randn((2,) + SHAPE, generator=g)
    noise = torch.randn((2, 5) + SHAPE, generator=g)
    a, _, _ = t_drive(tplan, xT, noise, tol=0.0)
    b, _, _ = t_drive(tplan, xT, noise, tol=-1.0, min_i=0)
    ref = tsamplers.sample_batched(tplan, t_stable, xT, noise=noise)
    for i in range(2):
        assert torch.equal(a[i], ref[i]) and torch.equal(b[i], ref[i])


def test_predictor_only_steps_never_fire_exit():
    """An all-P program has no corrector residual: even an infinite tol
    never exits early (the ee_ok gate)."""
    tplan = tsamplers.build_plan(spec(T, program=StepProgram(
        mode=("P",) * 6, tau=0.7)))
    g = torch.Generator().manual_seed(1)
    xT = torch.randn((2,) + SHAPE, generator=g)
    noise = torch.randn((2, 6) + SHAPE, generator=g)
    _, steps, _ = t_drive(tplan, xT, noise, tol=float("inf"), min_i=0)
    assert steps == [6, 6]


# ---------------------------------------------- stream and trajectories
def test_stream_previews_per_step(reference):
    """One preview per real step (the init tick emits none), equal to the
    reference's stream."""
    kw = dict(n_steps=5, combine="fused")
    jplan, tplan, jxT, skeys, xT, noise = _inputs(kw, 2)
    _, _, previews = t_drive(tplan, xT, noise, stagger=[0, 2], lanes=2,
                             stream=True)
    _, _, jprev = j_drive(jplan, jxT, skeys, stagger=[0, 2], lanes=2,
                          stream=True)
    for p, jp in zip(previews, jprev):
        assert len(p) == 5
        assert_f32_close(torch.stack(p), np.stack(jp))


@pytest.mark.parametrize("kw", [dict(), dict(parameterization="noise"),
                                dict(mode="PECE", combine="fused")])
def test_trajectory_matches_reference(reference, kw):
    """``sample(trajectory=True)`` and ``sample_batched(trajectory=True)``
    return the reference's per-step states and previews; the trajectory's
    last state is the solve's input to the denoise-final eval, and the
    stepwise previews equal the batched trajectory's."""
    jplan = jsamplers.build_plan(spec(J, **kw))
    tplan = tsamplers.build_plan(spec(T, **kw))
    jxT, skeys = ref_inputs(jplan, 2)
    jx0, jtraj = jsamplers.sample_batched(jplan, j_stable, jxT, skeys,
                                          trajectory=True)
    xT, noise = to_torch(jxT), ref_noise(skeys, tplan.spec.n_steps)
    x0, traj = tsamplers.sample_batched(tplan, t_stable, xT, noise=noise,
                                        trajectory=True)
    assert traj["x"].shape == (2, tplan.spec.n_steps) + SHAPE
    assert_f32_close(x0, jx0)
    for k in ("x", "x0"):
        assert_f32_close(traj[k], jtraj[k])
    # the unbatched entry point: one request at shape [1, *SHAPE]
    jx0s, jtrajs = jsamplers.sample(jplan, lambda x, t: j_stable(x, t),
                                    jxT[0], skeys[0], trajectory=True)
    x0s, trajs = tsamplers.sample(
        tplan, lambda x, t: 0.3 * x * torch.cos(t), xT[0], noise=noise[0],
        trajectory=True)
    assert_f32_close(x0s, jx0s)
    for k in ("x", "x0"):
        assert_f32_close(trajs[k], jtrajs[k])
    if kw.get("combine") == "fused":
        _, _, previews = t_drive(tplan, xT, noise, stream=True)
        for b in range(2):
            assert torch.equal(torch.stack(previews[b]), traj["x0"][b])


def test_trajectory_and_batch_key_the_compile_cache(reference):
    """``trajectory`` and the lane count join the compile-cache key, as in
    the reference: the same call sequence gives the same stats."""
    stats = {}
    for pkg in (T, J):
        pkg.samplers.clear_compile_cache()
        plan = pkg.samplers.build_plan(spec(pkg))
        if pkg is T:
            x1, x2 = torch.zeros((2,) + SHAPE), torch.zeros((4,) + SHAPE)
            run = lambda x, **kw: tsamplers.sample_batched(  # noqa: E731
                plan, t_stable, x, noise=torch.zeros(
                    (x.shape[0], 6) + SHAPE), **kw)
            solo = lambda **kw: tsamplers.sample(  # noqa: E731
                plan, ident, x1[0], **kw)
        else:
            x1, x2 = jnp.zeros((2,) + SHAPE), jnp.zeros((4,) + SHAPE)
            run = lambda x, **kw: jsamplers.sample_batched(  # noqa: E731
                plan, j_stable, x, jax.random.split(
                    jax.random.PRNGKey(0), x.shape[0]), **kw)
            solo = lambda **kw: jsamplers.sample(  # noqa: E731
                plan, ident, x1[0], jax.random.PRNGKey(0), **kw)
        seq = []
        for call in (lambda: run(x1), lambda: run(x1),
                     lambda: run(x1, trajectory=True), lambda: run(x2),
                     lambda: solo(), lambda: solo(trajectory=True),
                     lambda: solo(trajectory=True)):
            call()
            s = pkg.samplers.compile_cache_stats()
            seq.append((s["hits"], s["misses"], s["evictions"]))
        stats[pkg is T] = seq
    assert stats[True] == stats[False]


# ------------------------------------------------------------ cache contract
def _cache_sequence(pkg, device_kw):
    """The reference test's step-cache sequence in one package."""
    pkg.samplers.clear_stepwise_cache()
    model = t_stable if pkg is T else j_stable
    dtype = torch.float32 if pkg is T else jnp.float32
    base = spec(pkg, n_steps=6)
    fns = pkg.samplers.make_stepfns(pkg.samplers.build_plan(base), model,
                                    SHAPE, dtype, 4, **device_kw)
    same = [fns]
    for s in (base.replace(tau=0.2), base.replace(tau=1.1),
              base.replace(program=pkg.StepProgram(tau=0.5)),
              base.replace(program=pkg.StepProgram(
                  predictor_order=2, corrector_order=2, tau=0.9, width=3))):
        same.append(pkg.samplers.make_stepfns(pkg.samplers.build_plan(s),
                                              model, SHAPE, dtype, 4,
                                              **device_kw))
    mid = pkg.samplers.stepwise_cache_stats()
    pkg.samplers.make_stepfns(pkg.samplers.build_plan(base), model, SHAPE,
                              dtype, 8, **device_kw)
    end = pkg.samplers.stepwise_cache_stats()
    return (all(f is fns for f in same),
            [(s["hits"], s["misses"], s["evictions"], s["size"])
             for s in (mid, end)])


def test_cache_shared_across_tau_and_program_data(reference):
    """Specs differing only in tau / per-interval program orders resolve to
    ONE step-function entry; a lane count is a new one. The stats follow
    the reference's on the same sequence."""
    t_same, t_stats = _cache_sequence(T, {"device": "cpu"})
    j_same, j_stats = _cache_sequence(J, {})
    assert t_same and j_same
    assert t_stats == j_stats == [(4, 1, 0, 1), (4, 2, 0, 2)]


def test_warm_is_idempotent_and_an_empty_carry_steps():
    plan = tsamplers.build_plan(spec(T, n_steps=4))
    fns = tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32, 2,
                                 device="cpu")
    arrays = fns.adapter.arrays(plan, CPU)
    carry = tsamplers.fresh_carry(plan, 2, SHAPE, torch.float32,
                                  device="cpu")
    assert not fns.warmed
    fns.warm(arrays, carry)
    assert fns.warmed
    fns.warm(arrays, carry)  # no-op
    carry2, aux = fns.step(arrays, carry)  # an all-free carry still steps
    assert not aux["finished"].any() and not carry2["active"].any()


def test_copy_moves_the_whole_lane():
    """``copy`` moves one lane's whole slice (state, history, step index,
    noise, knobs) and leaves every other lane's bytes alone."""
    plan = tsamplers.build_plan(spec(T, n_steps=4))
    fns = tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32, 3,
                                 device="cpu")
    arrays = fns.adapter.arrays(plan, CPU)
    g = torch.Generator().manual_seed(2)
    src = tsamplers.fresh_carry(plan, 3, SHAPE, torch.float32, device="cpu")
    dst = tsamplers.fresh_carry(plan, 3, SHAPE, torch.float32, device="cpu")
    for lane in range(3):
        fns.join(arrays, src, lane, torch.randn(SHAPE, generator=g), g,
                 0.5, 2, 1.5, guard=3)
    fns.step(arrays, src)
    fns.join(arrays, dst, 0, torch.randn(SHAPE, generator=g), g, 0.0, 0, 1.0)
    before = {k: v.clone() for k, v in carry_leaves(dst)}
    fns.copy(dst, src, 2, 1)
    for path, v in carry_leaves(dst):
        s = src[path[0]][path[1]] if len(path) > 1 else src[path[0]]
        assert torch.equal(v[2], s[1]), path
        assert torch.equal(v[:2], before[path][:2]), path


def test_feature_cache_and_residual_policy_are_refused():
    """Feature caching under the step protocol and the residual policy
    under sample_batched run (tests/test_torch_feature_cache_lanes.py);
    what they still refuse: a carry with no Denoiser to shape its
    features, a model without a cached companion, and a family whose
    executors never dispatch the cached evaluation (the reference's
    message)."""
    den = Denoiser(lambda x, t, c: x, TS, prediction="x0",
                   cached=CachedNetwork(call=lambda x, t, c, f, r: (x, f),
                                        init=torch.zeros_like))
    for fc in (2, ("residual", 0.05)):
        plan = tsamplers.build_plan(spec(T, feature_cache=fc,
                                         prediction="x0"))
        with pytest.raises(ValueError, match="model_fn="):
            tsamplers.fresh_carry(plan, 2, SHAPE, torch.float32,
                                  device="cpu")
        carry = tsamplers.fresh_carry(plan, 2, SHAPE, torch.float32,
                                      model_fn=den, device="cpu")
        # one feature row per lane (G = 1 unguided), zero until a tick
        assert carry["feats"].shape == (2, 1) + SHAPE
        assert not carry["feats"].any()
        with pytest.raises(ValueError, match="cached="):
            tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32, 2,
                                   device="cpu")
        with pytest.raises(ValueError, match="cached="):
            tsamplers.sample_batched(plan, t_stable,
                                     torch.zeros((2,) + SHAPE),
                                     noise=torch.zeros((2, 6) + SHAPE))
    ddim = tsamplers.build_plan(spec(T, name="ddim", feature_cache=2))
    with pytest.raises(ValueError, match="not supported by the 'ddim'"):
        tsamplers.fresh_carry(ddim, 2, SHAPE, torch.float32, model_fn=den,
                              device="cpu")
    with pytest.raises(ValueError, match="not supported by the 'ddim'"):
        tsamplers.make_stepfns(ddim, den, SHAPE, torch.float32, 2,
                               device="cpu")
    with pytest.raises(ValueError, match="not supported by the 'ddim'"):
        tsamplers.sample_batched(ddim, den, torch.zeros((2,) + SHAPE),
                                 noise=torch.zeros((2, 6) + SHAPE))


def test_entry_points_run_on_the_card_unless_asked():
    """The step protocol's builders default to the card and raise without
    one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    plan = tsamplers.build_plan(spec(T))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsamplers.fresh_carry(plan, 2, SHAPE, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32, 2)


# ----------------------------------------------------------------- errors
def test_family_without_adapter_raises():
    fam = tsamplers.SamplerFamily(
        name="__scan_only__", plan=lambda s: ({}, {}),
        execute=lambda *a, **k: None, statics=lambda s: (),
        nfe_of=lambda s: s.n_steps, steps_from_nfe=lambda n, kw: n)
    tsamplers.register_sampler(fam)
    try:
        s = spec(T, name="__scan_only__")
        assert not tsamplers.stepwise_supported(s)
        with pytest.raises(ValueError, match="no step-granular adapter"):
            tsamplers.stepwise_adapter(s)
    finally:
        tbase._REGISTRY.pop("__scan_only__", None)


def test_adapter_reports_in_band_init():
    adapter = tsamplers.stepwise_adapter(spec(T))
    assert adapter.i0 == -1  # the init eval runs as a lane's first tick
    assert adapter.evals_per_tick == 1
    assert tsamplers.stepwise_adapter(spec(T, mode="PECE")).evals_per_tick \
        == 2
    # the baselines have no init evaluation; EDM's tick makes both
    for name in BASELINES:
        adapter = tsamplers.stepwise_adapter(spec(T, name=name))
        assert adapter.i0 == 0
        assert adapter.evals_per_tick == (2 if name.startswith("edm")
                                          else 1)


# ------------------------------------------------- lane-batched combines
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_plain_combines_equal_solo_calls(P, dtype):
    """A lane slice of each lane-batched plain combine equals the solo
    plain call on that lane's operands bit for bit, and the CPU dispatch
    takes the plain versions and counts no launch."""
    g = torch.Generator().manual_seed(P)
    L, shape = 4, (16, 8)
    x = torch.randn((L,) + shape, generator=g).to(dtype)
    buf = torch.randn((L, P) + shape, generator=g).to(dtype)
    xi = torch.randn((L,) + shape, generator=g).to(dtype)
    c = torch.randn((L, 2, P + 2), generator=g)
    before = ops.launch_counts()
    up = ops.sa_update_lanes(x, buf, xi, c[:, 0].contiguous())
    fp, fc = ops.sa_fused_update_lanes(x, buf, xi, c)
    assert ops.launch_counts() == before
    for l in range(L):
        assert torch.equal(up[l], t_update_mod.sa_update_plain(
            x[l], buf[l], xi[l], c[l, 0]))
        p, q = t_fused_mod.sa_fused_update_plain(x[l], buf[l], xi[l], c[l])
        assert torch.equal(fp[l], p) and torch.equal(fc[l], q)


def test_lane_kernel_wrappers_refuse_cpu_tensors():
    x, buf = torch.randn(2, 16), torch.randn(2, 3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        t_update_mod.sa_update_lanes(x, buf, x, torch.zeros(2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_mod.sa_fused_update_lanes(x, buf, x, torch.zeros(2, 2, 5))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 16), (5003,), (7, 3)])
@pytest.mark.parametrize("P", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_kernels_match_plain_and_solo_on_card(card, shape, P, dtype):
    """The lane-batched kernels against their plain versions (bitwise: the
    plain chain is the kernel's rounding), and each lane against a solo
    launch on its operands, bit for bit."""
    g = torch.Generator(card).manual_seed(P)
    L = 8
    rnd = lambda s: torch.randn(s, generator=g, device=card).to(dtype)  # noqa
    x, buf, xi = rnd((L,) + shape), rnd((L, P) + shape), rnd((L,) + shape)
    c = torch.randn((L, 2, P + 2), generator=g, device=card)
    before = ops.launch_counts()
    up = ops.sa_update_lanes(x, buf, xi, c[:, 0].contiguous())
    fp, fc = ops.sa_fused_update_lanes(x, buf, xi, c)
    after = ops.launch_counts()
    assert after["sa_update"] - before["sa_update"] == 1
    assert after["sa_fused"] - before["sa_fused"] == 1
    pu = ops.sa_update_lanes(x, buf, xi, c[:, 0].contiguous(), mode="plain")
    pp, pc = ops.sa_fused_update_lanes(x, buf, xi, c, mode="plain")
    assert torch.equal(up, pu) and torch.equal(fp, pp) and torch.equal(fc, pc)
    for l in range(L):
        assert torch.equal(up[l], ops.sa_update(
            x[l].contiguous(), buf[l].contiguous(), xi[l].contiguous(),
            c[l, 0].contiguous()))
        sp, sc = ops.sa_fused_update(x[l].contiguous(), buf[l].contiguous(),
                                     xi[l].contiguous(), c[l].contiguous())
        assert torch.equal(fp[l], sp) and torch.equal(fc[l], sc)


@pytest.mark.gpu
@pytest.mark.parametrize("combine", ["fused", "kernel"])
def test_captured_tick_equals_eager_ticks_on_card(card, combine):
    """The tick's CUDA graph replays the eager tick bit for bit, through
    joins and retirements, and a warmed entry shared by two batches keeps
    them apart (each tick copies its batch's carry in and out)."""
    plan = tsamplers.build_plan(spec(T, n_steps=6, mode="PECE",
                                     combine=combine))
    shape = (256, 16)
    fns = tsamplers.make_stepfns(plan, t_stable, shape, torch.float32, 4,
                                 device=card, stream=True)
    arrays = fns.adapter.arrays(plan, card)
    g = torch.Generator(card).manual_seed(0)
    carries = [tsamplers.fresh_carry(plan, 4, shape, torch.float32,
                                     device=card) for _ in range(3)]
    fns.warm(arrays, carries[0])
    assert tsamplers.stepwise_cache_stats()["graphs"] >= 1
    for c in carries[:2]:
        for lane in range(3):
            fns.join(arrays, c, lane, torch.randn(shape, generator=g,
                                                  device=card), g, 0.0, 0, 1.0)
    carries[2] = {k: ({k2: v2.clone() for k2, v2 in v.items()}
                      if isinstance(v, dict) else v.clone())
                  for k, v in carries[0].items()}
    for _ in range(8):
        _, aux0 = fns.step(arrays, carries[0])
        fns.step(arrays, carries[1])
        with tsamplers.eager():
            _, aux2 = fns.step(arrays, carries[2])
        for k in aux0:
            assert torch.equal(aux0[k], aux2[k]), k
    for path, v in carry_leaves(carries[0]):
        w = carries[2][path[0]][path[1]] if len(path) > 1 \
            else carries[2][path[0]]
        assert torch.equal(v, w), path


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["dpm_solver_pp_2m", "edm_stochastic"])
def test_captured_baseline_tick_equals_eager_ticks_on_card(card, name):
    """A baseline's tick captured as a CUDA graph replays its eager tick
    bit for bit, and a full drive equals the eager drive."""
    plan = tsamplers.build_plan(spec(T, name=name, tau=1.0))
    g = torch.Generator(card).manual_seed(0)
    xT = torch.randn((3,) + SHAPE, generator=g, device=card)
    noise = torch.randn((3, 6) + SHAPE, generator=g, device=card)

    def drive():
        fns = tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32,
                                     4, device=card)
        arrays = fns.adapter.arrays(plan, card)
        carry = tsamplers.fresh_carry(plan, 4, SHAPE, torch.float32,
                                      device=card)
        fns.warm(arrays, carry)
        for lane in range(3):
            fns.join(arrays, carry, lane, xT[lane], noise[lane], 0.0, 0, 1.0)
        for _ in range(6):
            fns.step(arrays, carry)
        return carry["x_final"][:3].clone()

    tsamplers.clear_stepwise_cache()
    replayed = drive()
    assert tsamplers.stepwise_cache_stats()["graphs"] == 1
    with tsamplers.eager():
        eager_out = drive()
    assert torch.equal(replayed, eager_out)
    ref = tsamplers.sample_batched(plan, t_stable, xT, noise=noise)
    torch.testing.assert_close(replayed, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("fc", [2, ("residual", 0.05)])
def test_captured_cached_tick_equals_eager_ticks_on_card(card, fc):
    """A feature-cached tick over the tame dit-s at full width (6 layers,
    span (1, 5)), captured as a CUDA graph with its refresh gate a
    conditional node, replays the eager tick bit for bit through staggered
    joins and retirements, features included; its drive equals each lane's
    solo ``sample()`` within 1e-4."""
    from repro_torch.models.tame import tame_dit, tame_networks
    model, params, mu = tame_dit("dit-s", smoke=False, n_layers=6,
                                 device=card)
    net, cached = tame_networks(model, params, mu)
    den = Denoiser(net, TS, prediction="x0", cached=cached)
    plan = tsamplers.build_plan(spec(T, n_steps=6, combine="fused",
                                     prediction="x0", feature_cache=fc))
    shape = (128, 16)
    g = torch.Generator(card).manual_seed(0)
    xT = torch.randn((4,) + shape, generator=g, device=card)
    noise = torch.randn((4, 6) + shape, generator=g, device=card)
    tsamplers.clear_stepwise_cache()
    fns = tsamplers.make_stepfns(plan, den, shape, torch.float32, 3,
                                 device=card)
    arrays = fns.adapter.arrays(plan, card)
    carries = [tsamplers.fresh_carry(plan, 3, shape, torch.float32,
                                     model_fn=den, device=card)
               for _ in range(2)]
    fns.warm(arrays, carries[0])
    assert tsamplers.stepwise_cache_stats()["graphs"] == 1
    done = {}
    owner = [None] * 3
    for tick in range(16):
        for b, at in enumerate((0, 0, 2, 8)):
            if at == tick:
                lane = owner.index(None)
                owner[lane] = b
                for c in carries:
                    fns.join(arrays, c, lane, xT[b], noise[b], 0.0, 0, 1.0)
        _, aux = fns.step(arrays, carries[0])
        with tsamplers.eager():
            _, aux_eager = fns.step(arrays, carries[1])
        for k in aux:
            assert torch.equal(aux[k], aux_eager[k]), (tick, k)
        for path, v in carry_leaves(carries[0]):
            w = carries[1][path[0]][path[1]] if len(path) > 1 \
                else carries[1][path[0]]
            assert torch.equal(v, w), (tick, path)
        for lane, b in enumerate(owner):
            if b is not None and aux["finished"][lane]:
                done[b] = carries[0]["x_final"][lane].clone()
                owner[lane] = None
    assert sorted(done) == [0, 1, 2, 3]
    for b in range(4):
        solo = tsamplers.sample(plan, den, xT[b:b + 1],
                                noise=noise[b][:, None])
        assert rel(done[b].cpu(), solo[0].cpu()) <= 1e-4, b


@pytest.mark.gpu
def test_captures_work_after_a_failed_capture_on_card(card):
    """A capture that fails (a model that reads the device back) leaves
    the shared pool unusable for later captures; the next capture, of a
    solve or of a tick, gets a fresh side stream and pool and succeeds."""
    def syncing(x, t):
        if float(x.abs().max()) > 1e9:  # a host read: not capturable
            raise AssertionError
        return t_stable(x, t)

    plan = tsamplers.build_plan(spec(T, n_steps=4, combine="fused"))
    tsamplers.clear_compile_cache()
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        tsamplers.sample(plan, syncing, torch.zeros((1,) + SHAPE,
                                                    device=card))
    x = torch.ones((2,) + SHAPE, device=card)
    noise = torch.zeros((2, 4) + SHAPE, device=card)
    out = tsamplers.sample_batched(plan, t_stable, x, noise=noise)
    with tsamplers.eager():
        ref = tsamplers.sample_batched(plan, t_stable, x, noise=noise)
    assert torch.equal(out, ref)
    fns = tsamplers.make_stepfns(plan, t_stable, SHAPE, torch.float32, 2,
                                 device=card)
    carry = tsamplers.fresh_carry(plan, 2, SHAPE, torch.float32, device=card)
    fns.warm(fns.adapter.arrays(plan, card), carry)
    assert fns.warmed
