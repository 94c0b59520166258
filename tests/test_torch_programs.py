"""Step programs in the PyTorch port against the JAX reference.

The same x_T and the reference's per-step noise draws (``split(key, M)``,
one f32 normal each) go through the reference's solve and the port's on
the analytic GMM oracle. The port runs each of its combines, which on
the CPU are the kernels' plain versions; the reference runs its fused
combine against the port's fused one (in bf16 that combine rounds the
corrector base before adding the new evaluation, which the einsum does
not) and its einsum combine otherwise (its Pallas kernel combine runs in
interpret mode here; its own tests hold it to the einsum).

Tolerances: whole solves agree to 1e-5 in relative norm in f32 and to
1e-2 in bf16 (the reference's bf16 bar); host f64 tables to 1e-12
relative. Inside the port, a program that pins constant order and tau is
bitwise the fixed spec, and the f32 ring history is bitwise the concat
layout under any program.

The reference is imported when available, so the one card test runs on a
machine with a card and no JAX (``pytest -m gpu tests/test_torch_programs.py``).
"""

import functools

import numpy as np
import pytest
import torch

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import GMM as JGMM
    from repro.core import get_schedule as j_get_schedule
    from repro.core import programs as jprograms
    from repro.core import samplers as jsamplers
    from repro.core.coefficients import build_tables as j_build_tables
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None

from repro_torch.core import GMM as TGMM
from repro_torch.core import get_schedule as t_get_schedule
from repro_torch.core import programs as tprograms
from repro_torch.core import samplers as tsamplers
from repro_torch.core.coefficients import build_tables
from repro_torch.core.programs import (MODES, StepProgram, list_presets,
                                       parse_program, program_preset,
                                       program_preset_for_nfe)
from repro_torch.core.samplers import SamplerSpec, build_plan
from repro_torch.core.samplers.multistep import MAX_SCAN_SEGMENTS
from repro_torch.core.schedules import timestep_grid
from repro_torch.core.tau import BandedTau, ConstantTau, DDIMEtaTau
from repro_torch.kernels import ops

SCHED = t_get_schedule("vp_linear")
MODEL = TGMM.default_2d().model_fn(SCHED, "data")
SHAPE = (96, 2)
XT = torch.from_numpy(
    np.random.default_rng(9).standard_normal(SHAPE).astype(np.float32))
XIS = [torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
    SHAPE).astype(np.float32)) for i in range(32)]
COMBINES = ["einsum", "kernel", "fused"]
MIXED = [
    ("PECE", "PECE", "PEC", "PEC", "P", "P"),    # 3 segments
    ("PEC", "P", "PEC", "P", "PEC", "P"),        # 6: the cond fallback
    ("P", "PEC", "PECE", "PEC", "P", "PEC"),     # 5: the cond fallback
]


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def _sa(**kw):
    return tsamplers.make_sampler("sa", schedule=SCHED, **kw)


def _solve(s, model=MODEL, x=XT):
    return s.sample(model, x, noise=lambda i: XIS[i])


def _to_ref(prog: StepProgram):
    """The reference's StepProgram with the same tracks (through JSON)."""
    return jprograms.StepProgram.from_json(prog.to_json())


@functools.lru_cache(maxsize=None)
def _ref_solve(name, program_json, n_steps, precision="f32", history="ring",
               denoise_final=True, combine="einsum", seed=0):
    """(x_T, noise draws, the reference's solve) for one spec: the draws
    are kept for the port's solve."""
    prog = jprograms.StepProgram.from_json(program_json)
    jsched = j_get_schedule("vp_linear")
    spec = jsamplers.SamplerSpec(
        name=name, schedule=jsched, n_steps=n_steps, program=prog,
        precision=precision, history=history, denoise_final=denoise_final,
        combine=combine)
    js = jsamplers.Sampler(spec)
    conv = jsamplers.get_family(name).model_convention(spec)
    x_T = np.random.default_rng(seed).standard_normal(SHAPE).astype(
        np.float32)
    key = jax.random.PRNGKey(seed + 1)
    keys = jax.random.split(key, n_steps)
    xis = tuple(np.array(jax.random.normal(keys[i], SHAPE, jnp.float32))
                for i in range(n_steps))
    out = js.sample(JGMM.default_2d().model_fn(jsched, conv),
                    jnp.asarray(x_T), key)
    return x_T, xis, np.asarray(out, np.float32)


def solve_both(prog: StepProgram, n_steps, *, name="sa", combine="einsum",
               precision="f32", history="ring", denoise_final=True,
               ref_combine=None):
    """(reference output, port output) of one program on the same x_T and
    the reference's noise; the reference's combine is ``ref_combine``, by
    default its fused one against the port's fused one and its einsum
    otherwise."""
    if ref_combine is None:
        ref_combine = "fused" if combine == "fused" else "einsum"
    x_T, xis, ref = _ref_solve(name, prog.to_json(), n_steps, precision,
                               history, denoise_final, ref_combine)
    ts = tsamplers.make_sampler(
        name, schedule=SCHED, n_steps=n_steps, program=prog,
        combine=combine, precision=precision, history=history,
        denoise_final=denoise_final)
    conv = tsamplers.get_family(name).model_convention(ts.spec)
    got = ts.sample(TGMM.default_2d().model_fn(SCHED, conv),
                    torch.from_numpy(x_T),
                    noise=lambda i: torch.from_numpy(xis[i]))
    return ref, got


def rel(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _tol(precision):
    return 1e-5 if precision == "f32" else 1e-2


# -------------------------------------------- bitwise lock vs fixed specs
@pytest.mark.parametrize("history", ["ring", "concat"])
@pytest.mark.parametrize("mode", ["PEC", "PECE"])
@pytest.mark.parametrize("p,c", [(1, 1), (2, 2), (3, 3)])
def test_constant_program_bitwise_matrix(history, mode, p, c):
    """PEC/PECE x orders 1-3 x ring/concat, every combine the layout
    takes: a program pinning the fixed spec's constants is bitwise the
    fixed-spec path."""
    for combine in COMBINES if history == "ring" else ("einsum", "kernel"):
        kw = dict(n_steps=6, history=history, combine=combine)
        fixed = _sa(tau=0.7, predictor_order=p, corrector_order=c,
                    mode=mode, **kw)
        prog = _sa(program=StepProgram(predictor_order=p, corrector_order=c,
                                       mode=mode, tau=0.7), **kw)
        assert torch.equal(_solve(fixed), _solve(prog)), combine


def test_constant_program_shares_fixed_statics_and_tables():
    fixed = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=5,
                                   tau=0.4))
    prog = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=5,
                                  program=StepProgram(tau=0.4)))
    assert fixed.statics == prog.statics
    ta, tb = fixed.host["tables"], prog.host["tables"]
    for f in ("decay", "noise", "pred", "corr_new", "corr", "taus"):
        assert np.array_equal(getattr(ta, f), getattr(tb, f)), f
    for k, v in fixed.arrays.items():
        assert torch.equal(v, prog.arrays[k]), k


@pytest.mark.parametrize("combine", COMBINES)
def test_predictor_only_program_matches_c0_spec(combine):
    fixed = _sa(n_steps=6, tau=0.5, corrector_order=0, combine=combine)
    programmed = _sa(n_steps=6, program=StepProgram(mode="P", tau=0.5),
                     combine=combine)
    assert fixed.plan.statics == programmed.plan.statics
    assert torch.equal(_solve(fixed), _solve(programmed))


@pytest.mark.parametrize("combine", COMBINES)
def test_order_ramp_preset_is_bitwise_the_default(combine):
    a = _sa(n_steps=7, program=program_preset("constant", 7), combine=combine)
    b = _sa(n_steps=7, program=program_preset("order-ramp", 7),
            combine=combine)
    c = _sa(n_steps=7, combine=combine)
    assert a.plan.statics == b.plan.statics == c.plan.statics
    assert torch.equal(_solve(a), _solve(b))
    assert torch.equal(_solve(a), _solve(c))


# ----------------------------------------------- segmented mode execution
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("modes", MIXED)
def test_mixed_mode_program_matches_reference(reference, modes, combine,
                                              precision):
    prog = StepProgram(mode=modes, tau=0.6)
    ref, got = solve_both(prog, len(modes), combine=combine,
                          precision=precision, denoise_final=False)
    assert rel(got, ref) <= _tol(precision)


@pytest.mark.parametrize("combine", ["einsum", "kernel"])
@pytest.mark.parametrize("modes", [("PECE", "PEC", "PEC", "P", "P", "PEC"),
                                   MIXED[1]])
def test_mixed_mode_ring_matches_concat(combine, modes):
    """Both history layouts agree bitwise under a multi-segment program and
    under the cond fallback: the ring head follows the global step index
    across segment boundaries."""
    prog = StepProgram(mode=modes, tau=(1.0, 0.8, 0.5, 0.3, 0.1, 0.0))
    kw = dict(n_steps=6, program=prog, combine=combine)
    assert torch.equal(_solve(_sa(history="ring", **kw)),
                       _solve(_sa(history="concat", **kw)))


@pytest.mark.parametrize("combine,want", [
    ("fused", {"sa_fused": 4, "sa_update": 2}),
    ("kernel", {"sa_fused": 0, "sa_update": 2 * 4 + 2}),
    ("einsum", {"sa_fused": 0, "sa_update": 0}),
])
def test_segment_calls_follow_the_modes(monkeypatch, combine, want):
    """Each step calls the combine its mode needs: under ``fused`` a step
    with a corrector takes sa_fused and a predictor-only step sa_update;
    under ``kernel`` two sa_update calls or one. Counted through the
    dispatch, since on the CPU no kernel launches."""
    calls = {"sa_fused": 0, "sa_update": 0}
    for name, key in (("sa_update", "sa_update"),
                      ("sa_fused_update", "sa_fused")):
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    s = _sa(n_steps=6, program=StepProgram(
        mode=("PECE", "PEC", "PEC", "PECE", "P", "P")), combine=combine)
    assert s.plan.statics[1][0] == "segments"
    _solve(s)
    assert calls == want


# ------------------------------------------------- warm-up ramp / tables
def test_variable_order_tables_apply_warmup_ramp():
    ts = timestep_grid(SCHED, 6, kind="logsnr")
    tb = build_tables(SCHED, ts, program=StepProgram(tau=0.5))
    fixed = build_tables(SCHED, ts, tau=0.5, predictor_order=3,
                         corrector_order=3)
    assert list(tb.p_orders) == [1, 2, 3, 3, 3, 3]
    assert list(tb.c_orders) == [1, 2, 3, 3, 3, 3]
    np.testing.assert_array_equal(tb.pred, fixed.pred)
    np.testing.assert_array_equal(tb.corr, fixed.corr)
    assert fixed.p_orders is None and fixed.c_orders is None


def test_per_interval_orders_zero_pad_rows():
    ts = timestep_grid(SCHED, 5, kind="logsnr")
    tb = build_tables(SCHED, ts, program=StepProgram(
        predictor_order=(1, 1, 2, 3, 2), corrector_order=(1, 2, 2, 2, 0),
        tau=0.3))
    assert tb.pred.shape == (5, 3)
    assert list(tb.p_orders) == [1, 1, 2, 3, 2]
    assert list(tb.c_orders) == [1, 2, 2, 2, 0]
    assert np.all(tb.pred[0, 1:] == 0) and np.all(tb.pred[4, 2:] == 0)
    assert np.all(tb.corr[4] == 0) and tb.corr_new[4] == 0


def test_program_width_floors_table_rows():
    ts = timestep_grid(SCHED, 4, kind="logsnr")
    tb = build_tables(SCHED, ts, program=StepProgram(
        predictor_order=1, corrector_order=1, width=3))
    assert tb.pred.shape == (4, 3) and tb.corr.shape == (4, 3)
    plan = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=4,
                                  program=StepProgram(width=4)))
    assert tuple(plan.arrays["fused_packed"].shape) == (4, 2, 4 + 2)


def test_tau_schedule_inside_program():
    ts = timestep_grid(SCHED, 8, kind="logsnr")
    banded = BandedTau(tau=0.8)
    a = build_tables(SCHED, ts, tau=banded, predictor_order=3,
                     corrector_order=3)
    b = build_tables(SCHED, ts, program=StepProgram(tau=banded))
    np.testing.assert_array_equal(a.taus, b.taus)
    np.testing.assert_array_equal(a.noise, b.noise)


_TABLE_PROGRAMS = [
    StepProgram(tau=0.5),
    StepProgram(predictor_order=(1, 1, 2, 3, 2, 3), corrector_order=(
        1, 2, 2, 2, 0, 3), mode=("PEC", "PECE", "PEC", "P", "PEC", "PEC"),
        tau=(0.3, 0.0, 1.0, 0.7, 0.2, 0.9)),
    StepProgram(predictor_order=2, corrector_order=1, width=5),
    StepProgram(tau=BandedTau(tau=0.8)),
    StepProgram(tau=DDIMEtaTau(eta=0.6), mode="P"),
]


@pytest.mark.parametrize("prog", _TABLE_PROGRAMS, ids=range(5))
@pytest.mark.parametrize("param", ["data", "noise"])
def test_program_tables_match_reference(reference, prog, param):
    ts = timestep_grid(SCHED, 6, kind="logsnr")
    got = build_tables(SCHED, ts, program=prog, parameterization=param)
    ref = j_build_tables(j_get_schedule("vp_linear"), ts,
                         program=_to_ref(prog), parameterization=param)
    for f in ("decay", "noise", "pred", "corr_new", "corr", "taus"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-300), f
    np.testing.assert_array_equal(got.p_orders, ref.p_orders)
    np.testing.assert_array_equal(got.c_orders, ref.c_orders)


# --------------------------------------------------- NFE accounting / spec
def test_program_nfe_counts_pece_steps():
    prog = StepProgram(mode=("PECE", "PECE", "PEC", "P"))
    spec = SamplerSpec(name="sa", schedule=SCHED, n_steps=4, program=prog)
    assert spec.nfe == 7 and spec.network_nfe == 7


def test_model_is_called_program_nfe_times():
    calls = []

    def counted(x, t):
        calls.append(float(t))
        return MODEL(x, t)

    for modes in (("PECE", "PECE", "PEC", "P"), ("PEC", "P") * 3):
        calls.clear()
        s = _sa(n_steps=len(modes), program=StepProgram(mode=modes))
        _solve(s, model=counted)
        assert len(calls) == s.nfe == s.spec.program.nfe(len(modes))


def test_from_nfe_with_explicit_program():
    prog = StepProgram(mode=("PECE",) + ("PEC",) * 4)
    spec = SamplerSpec.from_nfe("sa", 8, schedule=SCHED, program=prog)
    assert spec.n_steps == 5 and spec.nfe == 7
    with pytest.raises(ValueError, match="budget"):
        SamplerSpec.from_nfe("sa", 5, schedule=SCHED, program=prog)


def test_from_nfe_with_scalar_program():
    spec = SamplerSpec.from_nfe("sa", 9, schedule=SCHED,
                                program=StepProgram(mode="PECE"))
    assert spec.n_steps == 4 and spec.nfe == 9


@pytest.mark.parametrize("nfe", [2, 5, 9, 20])
@pytest.mark.parametrize("prog", [
    StepProgram(mode="PECE"), StepProgram(mode="P"),
    StepProgram(mode=("PECE", "PEC", "P")), StepProgram(tau=(0.1,) * 8)],
    ids=["pece", "p", "explicit", "explicit8"])
def test_from_nfe_matches_reference(reference, nfe, prog):
    """Same step count and NFE as the reference, or the same refusal."""
    def spec(pkg, program):
        try:
            s = pkg.SamplerSpec.from_nfe("sa", nfe, program=program)
        except ValueError as e:
            return str(e)
        return s.n_steps, s.nfe
    assert spec(tsamplers, prog) == spec(jsamplers, _to_ref(prog))


def test_program_length_must_match_steps():
    with pytest.raises(ValueError, match="intervals"):
        build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=5,
                               program=StepProgram(tau=(0.5, 0.5, 0.5))))


def test_program_validation():
    with pytest.raises(ValueError, match="mode"):
        StepProgram(mode="PCE")
    with pytest.raises(ValueError, match="predictor_order"):
        StepProgram(predictor_order=0)
    with pytest.raises(ValueError, match="corrector_order"):
        StepProgram(corrector_order=-1)
    with pytest.raises(ValueError, match="disagree"):
        StepProgram(tau=(0.1, 0.2), mode=("PEC", "PEC", "PEC"))
    with pytest.raises(TypeError, match="StepProgram"):
        build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=4,
                               program=("PEC", "PEC", "PEC", "PEC")))


def test_mode_normalization_c0_is_predictor_only():
    a = StepProgram(mode="PEC", corrector_order=0)
    b = StepProgram(mode="P")
    assert a.segments(4) == b.segments(4) == ((False, False, 4),)
    assert a.nfe(4) == b.nfe(4) == 5
    assert StepProgram(mode="PECE", corrector_order=0).segments(3) == (
        (False, False, 3),)


def test_modes_constant():
    assert MODES == ("P", "PEC", "PECE")


# ----------------------------------------- table width against the kernels
def _rows_per_call(monkeypatch):
    """{entry: set of history rows} of the combine calls made while the
    monkeypatch is active."""
    rows = {}
    for name in ("sa_update", "sa_fused_update"):
        fn = getattr(ops, name)

        def call(x, buf, xi, coeffs, _fn=fn, _name=name, **kw):
            rows.setdefault(_name, set()).add(int(buf.shape[0]))
            return _fn(x, buf, xi, coeffs, **kw)
        monkeypatch.setattr(ops, name, call)
    return rows


@pytest.mark.parametrize("combine", ["kernel", "fused"])
@pytest.mark.parametrize("kw", [
    dict(predictor_order=6, corrector_order=6),
    dict(program=StepProgram(width=6)),
    dict(program=StepProgram(predictor_order=(1, 2, 3, 6, 3, 3))),
], ids=["order6", "width6", "track6"])
def test_kernel_combines_refuse_tables_wider_than_the_kernels(
        reference, monkeypatch, combine, kw):
    """Tables wider than the combine kernels' template instances (P 1..5;
    the card runs them through the runtime-P kernel): the port's solve
    with the kernel or fused combine matches the reference's solve with
    the same combine (its Pallas kernels in interpret mode) on the
    reference's draws, at 1e-5 in f32, with six history rows a call (and
    seven in the kernel combine's corrector call)."""
    prog = kw.get("program") or StepProgram(**kw)
    rows = _rows_per_call(monkeypatch)
    ref, got = solve_both(prog, 6, combine=combine, ref_combine=combine)
    assert rel(got, ref) < 1e-5
    assert max(max(r) for r in rows.values()) == \
        (7 if combine == "kernel" and prog.corrector_order != 0 else 6)


@pytest.mark.parametrize("kw,kernel_ok", [
    (dict(predictor_order=5, corrector_order=5), False),
    (dict(predictor_order=5, corrector_order=0), True),
    (dict(predictor_order=4, corrector_order=4), True),
    (dict(program=StepProgram(mode="P", width=5)), True),
    (dict(program=StepProgram(mode=("P", "PEC") * 3, width=5)), False),
])
def test_kernel_combine_counts_the_corrector_row(reference, monkeypatch, kw,
                                                 kernel_ok):
    """The kernel combine's corrector call stacks the predicted-point eval
    on the table's rows, one row more than the fused combine's calls
    (``kernel_ok``: the kernel combine's widest call fits the five-row
    template instances). Both solve, agree with each other and with the
    reference's solve of the same combine."""
    prog = kw.get("program") or StepProgram(**kw)
    widest, outs = {}, {}
    for combine in ("kernel", "fused"):
        rows = _rows_per_call(monkeypatch)
        ref, outs[combine] = solve_both(prog, 6, combine=combine,
                                        ref_combine=combine)
        assert rel(outs[combine], ref) < 1e-5, combine
        widest[combine] = max(max(r) for r in rows.values())
        monkeypatch.undo()
    corrector = prog.corrector_order != 0 and prog.mode != "P"
    assert widest["kernel"] == widest["fused"] + int(corrector)
    assert (widest["kernel"] <= 5) == kernel_ok
    assert rel(outs["kernel"], outs["fused"].float().numpy()) < 1e-5


@pytest.mark.parametrize("combine", ["kernel", "fused"])
def test_kernel_combines_take_an_eight_row_program(reference, monkeypatch,
                                                   combine):
    """A program eight rows wide (order 8 from its eighth step, PEC and
    PECE, tau varying) against the reference's solve of the same combine,
    at 1e-5 in f32."""
    prog = StepProgram(predictor_order=(1, 2, 3, 4, 5, 6, 7, 8, 8, 8),
                       corrector_order=(1, 2, 3, 4, 5, 6, 7, 8, 8, 7),
                       mode=("PEC",) * 6 + ("PECE",) * 4,
                       tau=(1.0, 0.8) * 5)
    rows = _rows_per_call(monkeypatch)
    ref, got = solve_both(prog, 10, combine=combine, ref_combine=combine)
    assert rel(got, ref) < 1e-5
    assert max(max(r) for r in rows.values()) == \
        (9 if combine == "kernel" else 8)


# ----------------------------------------------------------- JSON / presets
_JSON_PROGRAMS = [
    StepProgram(),
    StepProgram(predictor_order=(1, 2, 3), corrector_order=(0, 1, 2),
                mode=("P", "PEC", "PECE"), tau=(0.0, 0.5, 1.0)),
    StepProgram(tau=BandedTau(tau=0.7, band_lo=0.05, band_hi=50.0)),
    StepProgram(tau=DDIMEtaTau(eta=0.6), width=3),
    StepProgram(tau=ConstantTau(0.3)),
]


@pytest.mark.parametrize("prog", _JSON_PROGRAMS, ids=range(5))
def test_json_round_trip(reference, prog):
    assert StepProgram.from_json(prog.to_json()) == prog
    assert _to_ref(prog).to_json() == prog.to_json()


def test_json_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown program fields"):
        StepProgram.from_json('{"order": 3}')
    with pytest.raises(ValueError, match="tau kind"):
        StepProgram.from_json('{"tau": {"kind": "bogus"}}')
    with pytest.raises(ValueError, match="object"):
        StepProgram.from_json("[1, 2]")


def test_parse_program_forms(tmp_path):
    assert parse_program("constant", 6) == program_preset("constant", 6)
    inline = parse_program('{"tau": 0.25, "mode": "P"}', 6)
    assert inline.tau == 0.25 and inline.mode == "P"
    f = tmp_path / "prog.json"
    f.write_text(StepProgram(tau=(0.1, 0.2)).to_json())
    assert parse_program(f"@{f}", 2) == StepProgram(tau=(0.1, 0.2))
    with pytest.raises(ValueError, match="preset"):
        parse_program("nope", 6)


def test_parse_program_json_inherits_tau_only_when_omitted():
    assert parse_program('{"mode": ["PEC", "PEC", "P"]}', 3, tau=0.3).tau \
        == 0.3
    assert parse_program('{"mode": "P", "tau": 0.9}', 3, tau=0.3).tau == 0.9


def test_parse_program_nfe_stamps_presets_to_budget():
    prog = parse_program("pece-head", 7, nfe=8)
    assert prog.length() == 6 and prog.nfe(6) == 8
    assert parse_program('{"tau": 0.5}', 7, nfe=8) == StepProgram(tau=0.5)
    with pytest.raises(ValueError, match="cannot fit"):
        program_preset_for_nfe("pece-head", 2)


@pytest.mark.parametrize("name", list_presets())
@pytest.mark.parametrize("nfe", [3, 8, 20])
def test_preset_for_nfe_matches_reference(reference, name, nfe):
    """Every preset stamped through its NFE budget fits it, and is the
    reference's stamp (same tracks, step count and NFE)."""
    prog = program_preset_for_nfe(name, nfe)
    ref = jprograms.program_preset_for_nfe(name, nfe)
    assert prog.to_json() == ref.to_json()
    spec = SamplerSpec.from_nfe("sa", nfe, schedule=SCHED, program=prog)
    jspec = jsamplers.SamplerSpec.from_nfe("sa", nfe, program=ref)
    assert spec.nfe <= nfe
    assert (spec.n_steps, spec.nfe) == (jspec.n_steps, jspec.nfe)
    L = prog.length()
    assert L is None or spec.n_steps == L


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("combine", COMBINES)
@pytest.mark.parametrize("name", list_presets())
def test_presets_match_reference(reference, name, combine, precision):
    prog = program_preset(name, 6, tau=0.8)
    assert prog.to_json() == jprograms.program_preset(name, 6, tau=0.8) \
        .to_json()
    ref, got = solve_both(prog, 6, combine=combine, precision=precision)
    assert bool(torch.isfinite(got).all())
    assert rel(got, ref) <= _tol(precision)


def test_nfe8_preset_is_the_recorded_winner():
    w = program_preset("nfe8-gmm", 7)
    assert w.mode == ("PEC",) * 5 + ("P",) * 2
    assert w.tau == tprograms.anneal_taus(1.0, 7)
    assert SamplerSpec(name="sa", schedule=SCHED, n_steps=7,
                       program=w).nfe == 8


def test_program_tau_track_validation():
    ts = timestep_grid(SCHED, 6, kind="logsnr")
    with pytest.raises(TypeError):
        tprograms.program_tau_track("nope", SCHED, ts, "ddim")
    with pytest.raises(ValueError, match="order"):
        tprograms.program_tau_track(
            StepProgram(predictor_order=(1, 2, 3, 3, 3, 3)), SCHED, ts,
            "ddim")
    with pytest.raises(ValueError, match="mode"):
        tprograms.program_tau_track(StepProgram(mode="PECE"), SCHED, ts,
                                    "ddim")
    track = tprograms.program_tau_track(program_preset("tau-anneal", 6),
                                        SCHED, ts, "ddim")
    assert track.shape == (6,) and track[0] == 1.0 and track[-1] == 0.0


# --------------------------- cond fallback: fragmented mode patterns
def test_fragmented_patterns_collapse_to_cond_statics():
    plans = [build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=6,
                                    program=StepProgram(mode=m, tau=0.5)))
             for m in (("PEC", "P") * 3, ("P", "PEC") * 3)]
    assert plans[0].statics == plans[1].statics
    assert plans[0].statics[1] == ("cond",)
    seg = StepProgram(mode=("PECE",) * 2 + ("PEC",) * 2 + ("P", "PEC"),
                      tau=0.5)
    assert len(seg.segments(6)) == MAX_SCAN_SEGMENTS
    c = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=6,
                               program=seg))
    assert c.statics[1][0] == "segments"


def test_cond_fallback_plan_folds_p_steps_before_packing():
    """P steps get their predictor rows as corrector rows (corr_new is 0
    there) in ``corr`` AND in the packed kernel coefficients built from
    it; the per-step PECE flags stay a host tuple, which the device copy
    leaves on the host."""
    modes = ("PECE", "P", "PEC", "P", "PEC", "P")
    plan = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=6,
                                  program=StepProgram(mode=modes, tau=0.5)))
    tables = plan.host["tables"]
    assert plan.arrays["pece"] == tuple(m == "PECE" for m in modes)
    assert plan.arrays_on("cpu")["pece"] is plan.arrays["pece"]
    corr = plan.arrays["corr"].numpy()
    P = corr.shape[1]
    for i, m in enumerate(modes):
        want = (tables.pred if m == "P" else tables.corr)[i]
        np.testing.assert_array_equal(corr[i], want.astype(np.float32))
        np.testing.assert_array_equal(
            plan.arrays["corr_packed"][i, 3:].numpy(), corr[i])
        rot = plan.arrays["fused_packed"][i].numpy()
        pos = [(i - j) % P for j in range(P)]
        np.testing.assert_array_equal(rot[1, 2 + np.array(pos)], corr[i])
        if m == "P":
            assert tables.corr_new[i] == 0.0
            np.testing.assert_array_equal(rot[0], rot[1])
    seg = build_plan(SamplerSpec(name="sa", schedule=SCHED, n_steps=6,
                                 program=StepProgram(mode=("PEC",) * 4
                                                     + ("P",) * 2, tau=0.5)))
    assert "pece" not in seg.arrays


@pytest.mark.parametrize("history,combine", [
    ("ring", "einsum"), ("ring", "kernel"), ("ring", "fused"),
    ("concat", "einsum"), ("concat", "kernel")])
def test_cond_fallback_matches_reference(reference, history, combine):
    """The cond fallback's folded tables and host flags compute the
    reference's solve; under ``fused`` this catches a fold made after the
    packing (its P steps would combine all-zero corrector rows)."""
    modes = ("PECE", "P", "PEC", "P", "PEC", "PECE")
    prog = StepProgram(mode=modes, tau=0.6)
    s = _sa(n_steps=6, program=prog, history=history, combine=combine)
    assert s.plan.statics[1] == ("cond",)
    ref, got = solve_both(prog, 6, combine=combine, history=history,
                          denoise_final=False)
    assert rel(got, ref) <= 1e-5


def test_cond_fallback_calls_one_combine_per_step(monkeypatch):
    """Under the cond fallback every step runs the corrector combine:
    ``fused`` calls sa_fused on every step, sa_update never."""
    calls = []
    orig_f, orig_u = ops.sa_fused_update, ops.sa_update
    monkeypatch.setattr(ops, "sa_fused_update",
                        lambda *a, **k: calls.append("f") or orig_f(*a, **k))
    monkeypatch.setattr(ops, "sa_update",
                        lambda *a, **k: calls.append("u") or orig_u(*a, **k))
    _solve(_sa(n_steps=6, program=StepProgram(mode=MIXED[1]),
               combine="fused"))
    assert calls == ["f"] * 6


# ---------------------------------------------------- tau schedule programs
@pytest.mark.parametrize("tau", [BandedTau(tau=0.9), DDIMEtaTau(eta=0.6)],
                         ids=["banded", "ddim_eta"])
def test_tau_schedule_program_matches_fixed_and_reference(reference, tau):
    """A TauSchedule program is the fixed spec with that schedule, bitwise,
    and the reference's solve."""
    fixed = _sa(n_steps=8, tau=tau)
    prog = StepProgram(tau=tau)
    assert torch.equal(_solve(fixed), _solve(_sa(n_steps=8, program=prog)))
    ref, got = solve_both(prog, 8, combine="fused")
    assert rel(got, ref) <= 1e-5


def test_ddim_eta_tau_one_step_predictor_is_ddim():
    """The 1-step SA-Predictor under DDIMEtaTau(eta) is the DDIM-eta update
    (float64, the source sigma s_i in the formula)."""
    ts = timestep_grid(SCHED, 11, kind="logsnr")
    a, s = SCHED.alpha(ts), SCHED.sigma(ts)
    rng = np.random.default_rng(3)
    x, x0_hat, xi = (rng.normal(size=(7, 2)) for _ in range(3))
    for eta in (0.0, 0.3, 0.7, 1.0):
        tb = build_tables(SCHED, ts, program=StepProgram(
            predictor_order=1, mode="P", tau=DDIMEtaTau(eta=eta)))
        for i in range(len(ts) - 1):
            var = eta ** 2 * (s[i + 1] ** 2 / s[i] ** 2) * (
                1 - a[i] ** 2 / a[i + 1] ** 2)
            eps_hat = (x - a[i] * x0_hat) / s[i]
            ddim = (a[i + 1] * x0_hat + np.sqrt(max(s[i + 1] ** 2 - var, 0))
                    * eps_hat + np.sqrt(max(var, 0.0)) * xi)
            ours = tb.decay[i] * x + tb.pred[i, 0] * x0_hat + tb.noise[i] * xi
            np.testing.assert_allclose(ours, ddim, rtol=1e-9, atol=1e-12)


# ------------------------------------------------------------------- card
@pytest.mark.gpu
def test_mixed_mode_program_fused_on_card_matches_plain(monkeypatch):
    """A mixed-mode program (PECE, PEC and P segments) under ``fused`` on
    the card launches both combine kernels and agrees with the same solve
    through the plain versions (``ops.*(mode="plain")``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    model = TGMM.default_2d().model_fn(SCHED, "data")
    s = _sa(n_steps=8, program=StepProgram(
        mode=("PECE",) * 2 + ("PEC",) * 4 + ("P",) * 2, tau=0.6),
        combine="fused")
    x = torch.randn((4096, 2), generator=torch.Generator().manual_seed(1))
    xis = [torch.randn((4096, 2), generator=torch.Generator().manual_seed(
        2 + i)).to(dev) for i in range(8)]
    ops.reset_launch_counts()
    got = s.sample(model, x.to(dev), noise=lambda i: xis[i])
    assert ops.launch_counts()["sa_fused"] == 6
    assert ops.launch_counts()["sa_update"] == 2
    for name in ("sa_update", "sa_fused_update"):
        monkeypatch.setattr(ops, name, functools.partial(
            getattr(ops, name), mode="plain"))
    plain = s.sample(model, x.to(dev), noise=lambda i: xis[i])
    assert rel(got.cpu(), plain.cpu().numpy()) <= 1e-5
