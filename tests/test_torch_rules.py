"""Rules the PyTorch port keeps, checked without a card.

- ``src/repro_torch`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package ``repro``;
- entry points run on the card unless the caller asks for the CPU, and
  without a card they stop with an error naming it; on the card they go
  through the kernels unless the caller asks for the plain versions, and
  on the CPU the default runs the plain paths it always ran;
- ``chip_smoke.py`` fails (non-zero exit, no success line) without a card
  and when run alone, away from the repository;
- the kernel libraries are built from the repository's sources into a
  git-ignored directory, named by a hash of source and flags.
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.launch import attention_precision
from repro_torch.launch import sample as launch_sample

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_and_no_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_import_rule_walks_every_module_of_the_port():
    """The import rule above is parametrized over a walk of the package,
    so modules added to the port are checked too."""
    files = {str(p.relative_to(PORT)) for p in _files() if PORT in p.parents}
    assert {"core/programs.py", "core/samplers/seeds.py",
            "core/samplers/dpmpp.py", "tune/search.py",
            "tune/evaluate.py", "launch/tune.py"} <= files
    assert files == {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}


def test_relative_imports_stay_inside_the_port():
    for path in PORT.rglob("*.py"):
        depth = len(path.relative_to(PORT).parts) - 1
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, f"{path} escapes the package"


def test_resolve_device_names_the_missing_card():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device()


def test_launch_sample_without_device_flag_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        launch_sample.main(["--arch", "dit-s", "--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_sample.build_denoiser("dit-s", smoke=True)


@pytest.mark.parametrize("extra", [
    ["--weights", "tame", "--combine", "fused", "--flash"],
    ["--weights", "init", "--combine", "kernel", "--mode", "PECE",
     "--precision", "bf16"],
])
def test_launch_sample_on_cpu_prints_nfe_accounting(capsys, extra):
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", "16", "--nfe", "9", "--device", "cpu",
                        *extra])
    out = capsys.readouterr().out
    steps = 8 if "PECE" not in extra else 4
    assert f"NFE=9 (network NFE=9) (requested 9) steps={steps}" in out
    assert "finite=True" in out


def test_launch_sample_runs_a_family_under_a_program(capsys):
    """``--sampler`` and ``--program``: a preset stamped to the NFE budget
    (pece-head at NFE 9: 7 steps, 1 PECE + 6 PEC), printed in place of
    tau/P/C/mode."""
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", "16", "--nfe", "9", "--device", "cpu",
                        "--sampler", "seeds", "--program", "pece-head",
                        "--grid", "time", "--schedule", "vp_cosine",
                        "--history", "concat"])
    out = capsys.readouterr().out
    assert ("sampler=seeds NFE=9 (network NFE=9) (requested 9) steps=7 "
            "program=pece-head") in out
    assert "history=concat" in out and "finite=True" in out
    assert " P3C3 " not in out and "tau=" not in out


def test_launch_sample_refuses_a_program_for_a_tau_track_family(capsys):
    """``--program`` needs a family that consumes full step programs. The
    guard is checked through a stub family that consumes only a tau
    track (the baselines also refuse a full program in their own plans)."""
    from repro_torch.core.samplers import base
    sa = base.get_family("sa")
    stub = base.SamplerFamily(
        name="tau_track_stub", plan=sa.plan, execute=sa.execute,
        statics=sa.statics, nfe_of=sa.nfe_of,
        steps_from_nfe=sa.steps_from_nfe,
        model_convention=sa.model_convention)
    assert not stub.full_programs
    base.register_sampler(stub)
    try:
        with pytest.raises(SystemExit, match="only honors the tau track"):
            launch_sample.main(["--arch", "dit-s", "--smoke", "--device",
                                "cpu", "--sampler", "tau_track_stub",
                                "--program", "constant"])
    finally:
        del base._REGISTRY["tau_track_stub"]
    assert "tau_track_stub" not in base.list_samplers()


def _samples_line(out: str) -> str:
    """The printed sample statistics, without the timings."""
    line = next(ln for ln in out.splitlines() if "out mean=" in ln)
    return line[line.index("out mean="):]


@pytest.mark.parametrize("arch,plain,seq", [
    ("dit-s", "--no-flash", 16), ("rwkv6-3b", "--no-wkv-kernel", 64)])
def test_launch_sample_default_on_cpu_runs_the_plain_paths(capsys, arch,
                                                           plain, seq):
    """With no kernel flag a CPU run is bitwise the run that asks for the
    plain versions (DiT: ``_sdpa``; RWKV6: the chunked plain recurrence),
    as every CPU run was before the kernels became the card's default."""
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--seq", str(seq),
            "--nfe", "6", "--device", "cpu", "--weights", "tame",
            "--combine", "fused"]
    launch_sample.main(argv)
    default = capsys.readouterr().out
    launch_sample.main(argv + [plain])
    asked = capsys.readouterr().out
    assert "flash=False wkv_kernel=False" in default
    assert _samples_line(default) == _samples_line(asked)
    assert "'flash_attention': 0" in default and "'rwkv6_wkv': 0" in default


def test_launch_sample_refuses_a_plain_flag_of_another_arch():
    with pytest.raises(SystemExit, match="--no-flash"):
        launch_sample.main(["--arch", "rwkv6-3b", "--smoke", "--device",
                            "cpu", "--no-flash"])
    with pytest.raises(SystemExit, match="--no-wkv-kernel"):
        launch_sample.main(["--arch", "dit-s", "--smoke", "--device", "cpu",
                            "--no-wkv-kernel"])


def test_attention_precision_on_cpu_records_every_call(capsys):
    """The attention-precision entry point holds every attention call of one
    solve against the plain version, SDPA and float64; on the CPU the
    "kernel" is the plain version, so those two agree exactly."""
    rec = attention_precision.main(["--arch", "dit-s", "--smoke", "--batch",
                                    "2", "--seq", "16", "--nfe", "4",
                                    "--device", "cpu"])
    assert '"calls"' in capsys.readouterr().out
    n_layers = launch_sample.get_smoke("dit-s").n_layers
    assert rec["finite"] and rec["calls"] == n_layers * rec["nfe"] > 0
    assert rec["kernel_vs_plain"] == {"max_abs_err": 0.0, "over_tolerance": 0}
    for pair in ("plain_vs_f64", "sdpa_vs_plain", "sdpa_vs_f64"):
        assert rec[pair]["over_tolerance"] == 0, rec
    assert rec["plain_vs_f64"]["max_abs_err"] > 0.0
    assert rec["max_abs_logit"] > 0.0 and rec["max_abs_v"] > 0.0
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            attention_precision.main(["--arch", "dit-s", "--smoke"])


@pytest.mark.parametrize("name", _build.SOURCES)
def test_build_hash_covers_the_shared_headers(monkeypatch, tmp_path, name):
    """An edit to a shared header under csrc/ names a new library for every
    source, so no stale library built against the old header is loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(PORT / "kernels" / "csrc", csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.lib_path(name)
    header = csrc / "tf32_mma.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert _build.lib_path(name) != before


def _run_chip_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    r = _run_chip_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_chip_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_build_paths_are_hashed_and_ignored():
    for name in _build.SOURCES:
        path = _build.lib_path(name)
        assert path.parent == PORT / "kernels" / "_build"
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()
    assert "src/repro_torch/kernels/_build/" in (REPO / ".gitignore").read_text()


def test_missing_nvcc_is_reported(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises naming nvcc; nothing
    falls back."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_reused_library_reports_its_build_log(monkeypatch, tmp_path):
    """A library built earlier comes back with the nvcc output (ptxas
    registers and spills) of the build that made it; a library without
    that log is built again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    lib = _build.lib_path("flash_attention")
    lib.write_bytes(b"")
    line = "ptxas info    : Used 254 registers, 0 bytes spill stores"
    lib.with_suffix(".log").write_text(line + "\n")
    log = _build.build(("flash_attention",))["flash_attention"]
    assert log["reused"] and log["ptxas"] == [line]
    lib.with_suffix(".log").unlink()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("the CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(("flash_attention",))


@pytest.mark.gpu
def test_launch_sample_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    launch_sample.main(["--arch", "dit-s", "--smoke", "--batch", "2",
                        "--seq", "16", "--nfe", "9", "--combine", "fused",
                        "--flash", "--weights", "tame"])
    out = capsys.readouterr().out
    assert "NFE=9 (network NFE=9) (requested 9) steps=8" in out
    assert "finite=True" in out
    assert "'sa_fused': 16" in out and "'flash_attention': 36" in out  # two runs


@pytest.mark.gpu
def test_guided_cached_solve_on_the_card_matches_plain():
    """One-call CFG with feature caching on the card: flash runs at the
    doubled batch on the partial stacks the refresh plan gives (a 6-layer
    DiT, span (1, 5), 8 steps at interval 2: 6 + 6 * 4 + 2 * 4 launches),
    and the solve agrees with the same solve through the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerLM
    from repro_torch.models.tame import tame_dit, tame_networks
    dev = torch.device("cuda")
    schedule = get_schedule("vp_linear")
    model, params, mu = tame_dit("dit-s", n_layers=6, use_flash=True,
                                 device=dev)
    plain = TransformerLM(dataclasses.replace(model.cfg, use_flash=False))
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn((2, 16, 8), generator=g, device=dev)
    prompt = 0.1 * torch.randn((16, 8), generator=g, device=dev)
    xis = [torch.randn((2, 16, 8), generator=g, device=dev)
           for _ in range(8)]
    outs, counts = {}, {}
    for name, m, combine in (("kernel", model, "fused"),
                             ("plain", plain, "einsum")):
        net, cached = tame_networks(m, params, mu)
        s = make_sampler("sa", nfe=9, combine=combine, prediction="x0",
                         schedule=schedule, guidance=True, feature_cache=2)
        ops.reset_launch_counts()
        outs[name] = s.sample(
            Denoiser(net, schedule, prediction="x0", guidance=True,
                     cached=cached), x, noise=lambda i: xis[i],
            cond=prompt, guidance_scale=1.5)
        counts[name] = ops.launch_counts()
    assert counts["kernel"] == {"sa_update": 0, "sa_fused": 8,
                                "flash_attention": 38, "rwkv6_wkv": 0}
    assert not any(counts["plain"].values())
    assert float((outs["kernel"] - outs["plain"]).norm()
                 / outs["plain"].norm()) <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("arch,seq,kernel,calls", [
    ("dit-s", 16, "flash_attention", 2 * 9 * 2),      # layers x NFE x runs
    ("rwkv6-3b", 64, "rwkv6_wkv", 2 * 2 * 9 * 2)])    # x two directions
def test_launch_sample_defaults_to_the_kernels_on_the_card(capsys, arch, seq,
                                                          kernel, calls):
    """With no kernel flag ``launch.sample`` runs the arch's kernel on the card;
    ``--no-flash`` / ``--no-wkv-kernel`` run the plain version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--seq", str(seq),
            "--nfe", "9", "--weights", "tame"]
    launch_sample.main(argv)
    out = capsys.readouterr().out
    assert f"'{kernel}': {calls}" in out and "finite=True" in out
    launch_sample.main(argv + ["--no-flash" if arch == "dit-s"
                               else "--no-wkv-kernel"])
    assert f"'{kernel}': 0" in capsys.readouterr().out
