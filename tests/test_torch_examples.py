"""The port's two thin examples on the CPU against the reference's.

``examples/torch_quickstart.py`` (the GMM oracle through ``make_sampler``)
and ``examples/torch_serve_diffusion.py`` (``ServeEngine`` over the dit-s
smoke backbone) with ``--device cpu``, beside ``examples/quickstart.py``
and ``examples/serve_diffusion.py``: the same registry, sample shapes and
NFE, the same served shapes, microbatches, padded lanes and compile-cache
misses, and the quickstart's sliced-W2 below half the prior's.
"""

import importlib.util
import os
import re
import sys

import pytest

from repro.core import samplers as j_samplers
from repro_torch.core import samplers as t_samplers

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(name, argv, monkeypatch, capsys) -> str:
    monkeypatch.setattr(sys, "argv", [name] + argv)
    _load(name).main()
    return capsys.readouterr().out


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    ref = _run_reference("quickstart", [], monkeypatch, capsys)
    got = _load("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for pat in (r"registry: .*", r"sampled \d+ points with NFE=\d+"):
        assert re.search(pat, out).group(0) == re.search(pat, ref).group(0)
    assert got["shape"] == (4096, 2) and got["nfe"] == 20 and got["finite"]
    assert got["sliced_w2"] < 0.5 * got["prior_sliced_w2"]


def test_serve_diffusion_matches_the_reference(monkeypatch, capsys):
    argv = ["--requests", "6", "--bucket-sizes", "1,2,4", "--nfe", "9",
            "--stream"]
    # each package's compile cache is the process's: count this run's
    j_samplers.clear_compile_cache()
    ref = _run_reference("serve_diffusion", argv, monkeypatch, capsys)
    t_samplers.clear_compile_cache()
    got = _load("torch_serve_diffusion").main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    served = r"served rid (\d+): x0 \((\d+), (\d+)\)"
    assert sorted(re.findall(served, out)) == sorted(re.findall(served, ref))
    summary = r"(\d+) requests in [\d.]+s over (\d+) microbatches \((\d+) "
    assert re.search(summary, out).groups() == \
        re.search(summary, ref).groups()
    cache = r"'misses': (\d+)"
    assert re.search(cache, out).group(1) == re.search(cache, ref).group(1)
    s = got["stats"]
    assert len(got["results"]) == 6
    assert all(r.previews is not None for r in got["results"])
    # each bucket used compiled once
    assert s["compile_cache"]["misses"] == len(s["buckets"])


def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_quickstart", "torch_serve_diffusion"):
        with pytest.raises(SystemExit, match="no CUDA card"):
            _load(name).main([])
