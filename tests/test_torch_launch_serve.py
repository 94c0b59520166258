"""The port's serving entry point, ``repro_torch.launch.serve``, on the CPU:
``--mode lm`` over starcoder2-3b's and RWKV6's smoke configs (RWKV6 at
the reference's default prompt of 32 tokens, under one chunk of 64, and
at 200 tokens, three chunks and a tail), ``--mode diffusion`` under both
schedulers with the reference's summary (no compile-cache miss beyond
the buckets warmed), under guidance with a prompt file, sharded over two
gloo ranks that torchrun starts (killed at 120 s), and ``serve_lm``'s
greedy tokens against the reference ``serve_lm``'s own at float32.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro_torch.convert import _dit_from_config, params_from_jax
from repro_torch.core import samplers as tsamplers
from repro_torch.launch import serve


def _lm_out(out):
    m = re.search(r"arch=(\S+) prefill (\d+) toks x(\d+): [\d.]+s; "
                  r"decode (\d+) steps: [\d.]+ ms/tok", out)
    ids = re.search(r"sample token ids: \[([\d, ]+)\]", out)
    assert m and ids, out
    return m.groups(), [int(t) for t in ids.group(1).split(",")]


@pytest.mark.parametrize("arch,prompt,name", [
    ("starcoder2-3b", 32, "starcoder2-3b-smoke"),
    ("rwkv6-3b", 32, "rwkv6-smoke"),
    ("rwkv6-3b", 200, "rwkv6-smoke")])
def test_main_lm_on_cpu(arch, prompt, name, capsys):
    serve.main(["--mode", "lm", "--arch", arch, "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", str(prompt), "--gen", "6"])
    (got_name, S, B, gen), ids = _lm_out(capsys.readouterr().out)
    assert (got_name, S, B, gen) == (name, str(prompt), "2", "6")
    assert len(ids) == 6 and all(0 <= t < 512 for t in ids)


def test_main_lm_defaults_to_starcoder2_on_the_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA card"):
        serve.main(["--smoke"])


def test_serve_lm_returns_the_generated_ids(capsys):
    args = types.SimpleNamespace(arch="rwkv6-3b", smoke=True, batch=3,
                                 prompt_len=70, gen=5)
    toks = serve.serve_lm(args, "cpu")
    assert toks.shape == (3, 5) and toks.dtype == torch.int64
    _, ids = _lm_out(capsys.readouterr().out)
    assert ids == toks[0].tolist()


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-3b"])
def test_serve_lm_greedy_tokens_match_the_reference(arch, capsys,
                                                    monkeypatch):
    """The reference's ``serve_lm`` at float32 (its smoke config
    with a float32 stream and cache), and the port's on the same weights
    (the reference's ``init_params(PRNGKey(0))`` carried across) and the
    same prompt (the reference's ``randint(PRNGKey(1))`` injected): the
    same greedy token ids."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    if hasattr(jcfg, "cache_dtype"):
        jcfg = dataclasses.replace(jcfg, cache_dtype=jnp.float32)
    monkeypatch.setattr(j_serve, "get_smoke", lambda name: jcfg)
    B, S, gen = 4, 32, 12
    args = types.SimpleNamespace(arch=arch, smoke=True, batch=B,
                                 prompt_len=S, gen=gen)
    j_serve.serve_lm(args)
    _, ref_ids = _lm_out(capsys.readouterr().out)

    jm = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0), jm.param_defs(),
                                      jnp.float32))
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                           jcfg.vocab_size))
    if arch == "rwkv6-3b":
        tp = params_from_jax(jp)
        cfg = dataclasses.replace(
            serve.get_smoke(arch), dtype=torch.float32)
    else:
        tp = params_from_jax(jp, config=jcfg)
        cfg = dataclasses.replace(_dit_from_config(jcfg).cfg,
                                  dtype=torch.float32,
                                  cache_dtype=torch.float32)
    toks = serve.serve_lm(args, "cpu", cfg=cfg, params=tp, batch={
        "tokens": torch.from_numpy(prompt.astype(np.int64))})
    _, ids = _lm_out(capsys.readouterr().out)
    assert ids == toks[0].tolist() == ref_ids


def _summary(out):
    m = re.search(r"compile cache: (\{.*\})", out)
    assert m, out
    return ast.literal_eval(m.group(1))


def test_main_diffusion_solve_scheduler(capsys):
    tsamplers.clear_compile_cache()
    serve.main(["--mode", "diffusion", "--device", "cpu", "--requests", "7",
                "--bucket-sizes", "1,2,4", "--nfe", "8", "--seq", "16"])
    out = capsys.readouterr().out
    m = re.search(r"served 7 requests in [\d.]+s over (\d+) microbatches "
                  r"\((\d+) padded lanes, (\d+) bucket compiles, "
                  r"mesh=none\)", out)
    assert m, out
    microbatches, padded, compiles = map(int, m.groups())
    assert (microbatches, padded) == (2, 1)  # 4, then 3 in a bucket of 4
    assert _summary(out)["misses"] <= compiles <= 3
    assert "NFE=8, network NFE=8" in out and "arch=dit-s-smoke" in out


def test_main_diffusion_step_scheduler_and_guidance(capsys, tmp_path):
    serve.main(["--mode", "diffusion", "--device", "cpu", "--requests", "3",
                "--scheduler", "step", "--lanes", "2", "--nfe", "6",
                "--seq", "8", "--arch", "rwkv6-3b"])
    out = capsys.readouterr().out
    assert re.search(r"served 3 requests in [\d.]+s \(\d+ lane joins", out)
    assert "arch=rwkv6-smoke" in out and "stepwise cache:" in out
    prompt = tmp_path / "prompt.npy"
    np.save(prompt, np.random.default_rng(0).normal(
        0, 0.1, (8, 8)).astype(np.float32))
    tsamplers.clear_compile_cache()
    serve.main(["--mode", "diffusion", "--device", "cpu", "--requests", "3",
                "--bucket-sizes", "4", "--nfe", "7", "--seq", "8",
                "--prediction", "v", "--guidance-scale", "2.0",
                "--cond-file", str(prompt), "--sharded"])
    out = capsys.readouterr().out
    assert "--sharded: only one rank" in out and "torchrun" in out
    assert "guidance=2.0" in out and "prediction=v" in out
    assert "network NFE=14" in out
    assert _summary(out)["misses"] <= 1


def test_main_diffusion_sharded_over_two_gloo_ranks():
    """``--sharded`` under torchrun: each rank makes the group from
    torchrun's environment, the engine shards its lanes over the ``data``
    axis of a (data=2, model=1) mesh, and rank 0 alone prints."""
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mode", "diffusion", "--device", "cpu", "--requests", "4",
         "--sharded", "--bucket-sizes", "2,4", "--nfe", "6", "--seq", "8"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    served = [ln for ln in r.stdout.splitlines()
              if ln.startswith("served 4 requests")]
    assert len(served) == 1, r.stdout
    assert "mesh={'data': 2, 'model': 1}" in served[0]
    assert "--sharded: only one rank" not in r.stdout
