"""Training the port's LMs against the JAX reference, at smoke width in
float32: ``loss_fn``'s value and every parameter leaf's gradient
(autograd against ``jax.value_and_grad``) for the dense transformer (GQA,
MQA, gemma's tied and scaled embeddings with GeGLU, the sequence-chunked
head) and RWKV6 (the chunked WKV's plain form and its ``logw`` clamp);
three steps of ``launch.train``'s step against the reference driver's
jitted ``train_step``; the driver's CLI killed by ``--fail-at`` and
resumed; a checkpoint of the reference's ``TrainLoop`` resumed by the
port's driver; the driver's refusals, and a world of four gloo ranks
started from torchrun's environment; the optimiser's donated buffers;
and ``examples/torch_lm_train_resume.py`` end to end on the CPU.

Token batches come from ``synthetic_lm_batch`` (numpy, the same arrays in
both packages); the reference's parameters are carried across with
``params_from_jax``. The weights are tempered after the reference's
init, as ``chip_smoke.py``'s ``_temper_lm`` tempers them on the card:
every leaf nudged off zero by 0.02 N(0, 1) (after three AdamW steps of
3e-4 a zero-initialised leaf is ~1e-4 across, where an element of
rounding-sized gradient moves by a full step either way); the
transformer's attention projections rescaled to the usual fan-in (the
reference divides a [d, H, hd] projection by sqrt(H), not sqrt(d), so
its logits are far from unit scale, a sharp softmax amplifies float32
rounding, and at starcoder2-3b's 30 layers its gradient norm overflows
float32); and RWKV6's ``w0`` lowered by 2 with ``wr``/``wk`` scaled by
0.1 (at the init the cumulative log-decay reaches ~-300 within a chunk,
and the reference's float32 cumulative sum, taken in another order,
moves the gradients past 1e-5 of their scale).
Tolerances: 1e-5 relative per leaf (max |diff| over max |reference|) for
losses, gradients and the state after three steps; bitwise where both
sides are the port (remat, resume, donation).
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.models.common import STRATEGIES as J_STRATEGIES
from repro.configs import get_smoke as j_get_smoke
from repro.data import synthetic_lm_batch as j_synthetic_lm_batch
from repro.data import TokenTaskConfig as JTokenTaskConfig
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.runtime import TrainLoop as JTrainLoop
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.optim import adamw, apply_updates, chain, \
    clip_by_global_norm, linear_warmup_cosine
from repro_torch.tree import paths_and_leaves, tree_map

_EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch_lm_train_resume.py")


def _pair(arch: str, **over):
    """The reference model with its float32 init, tempered (module
    docstring), as numpy, and the port's model in its training form on
    the same parameters; ``over`` replaces config fields on both sides."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32, **over)
    jm = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      jm.param_defs(), jnp.float32))
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
        np.shape(a))).astype(np.float32), jp)
    if "attn" in jp["blocks"]:  # the usual fan-in: q, k, v of std ~1
        a, H, K = jp["blocks"]["attn"], jcfg.n_heads, jcfg.n_kv_heads
        for k, f in (("wq", H), ("wk", K), ("wv", K)):
            a[k] = a[k] * np.float32(math.sqrt(f / jcfg.d_model))
        a["wo"] = a["wo"] * np.float32(1 / math.sqrt(H))
    else:
        tm = jp["blocks"]["tm"]
        tm["w0"] = tm["w0"] - np.float32(2)
        for k in ("wr", "wk"):
            tm[k] = tm[k] * np.float32(0.1)
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32, **over)
    model = build_model(t_train.train_config(cfg))
    return jm, jp, model, params_from_jax(jp, model)


def _batch(vocab: int, B: int, S: int, step: int = 0):
    """(reference batch, port batch) of ``synthetic_lm_batch``."""
    b = synthetic_lm_batch(TokenTaskConfig(vocab_size=vocab, seq_len=S), B,
                           step)
    return ({k: jnp.asarray(b[k]) for k in ("tokens", "labels")},
            {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")})


def _rel_per_leaf(got, ref) -> dict:
    """max |got - ref| / max |ref| per checkpoint key; a leaf whose
    reference is all zero must be all zero."""
    got = dict(paths_and_leaves(got))
    ref = dict(paths_and_leaves(jax.tree.map(np.asarray, ref)))
    assert set(got) == set(ref)
    out = {}
    for k, r in ref.items():
        g = got[k].detach().numpy()
        assert g.shape == r.shape, k
        scale = float(np.max(np.abs(r)))
        err = float(np.max(np.abs(g - r)))
        out[k] = err / scale if scale else (0.0 if err == 0 else np.inf)
    return out


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("arch,B,S,over", [
    ("starcoder2-3b", 2, 32, {}),                    # GQA 3:1
    ("granite-34b", 2, 32, {}),                      # MQA
    ("gemma-7b", 2, 32, {}),                         # tied, scaled, GeGLU
    ("rwkv6-3b", 2, 128, {}),                        # two WKV chunks
    # the sequence-chunked head: vocab >= 32,000 at S a multiple of 512
    ("starcoder2-3b", 1, 1024, {"vocab_size": 32768, "n_layers": 1}),
])
def test_loss_and_gradients_match_the_reference(arch, B, S, over):
    jm, jp, model, params = _pair(arch, **over)
    jb, tb = _batch(model.cfg.vocab_size, B, S)
    j_loss, j_grads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jax.tree.map(jnp.asarray, jp), jb)
    loss, grads = t_train.loss_and_grads(model, params, tb)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    rel = _rel_per_leaf(grads, j_grads)
    assert max(rel.values()) <= 1e-5, rel
    # every leaf is trained (a tied head trains the embedding alone)
    assert all(float(g.abs().max()) > 0 for _, g in paths_and_leaves(grads))


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-3b"])
def test_remat_gives_bitwise_the_same_gradients(arch):
    """``remat="full"`` (each layer recomputed in the backward) against
    "none", on the same parameters: the same loss and gradients, bit for
    bit."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32)
    out = []
    for remat in ("none", "full"):
        model = build_model(t_train.train_config(
            dataclasses.replace(cfg, remat=remat)))
        params = t_train.make_init_state(
            model, chain(), torch.device("cpu"))()["params"]
        out.append(t_train.loss_and_grads(
            model, params, _batch(cfg.vocab_size, 2, 128)[1]))
    assert torch.equal(out[0][0], out[1][0])
    for (k, a), (_, b) in zip(paths_and_leaves(out[0][1]),
                              paths_and_leaves(out[1][1])):
        assert torch.equal(a, b), k


# ------------------------------------------------------------ train steps
def _j_train_step(jm, opt):
    """The reference driver's ``train_step`` (``repro.launch.train``)."""
    @jax.jit
    def train_step(state, batch):
        def loss_fn(p):
            return jm.loss_fn(p, batch)
        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = opt.update(grads, state["opt"], state["params"],
                                        state["step"])
        params = j_optim.apply_updates(state["params"], updates)
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1},
                {"loss": loss, "gnorm": j_optim.global_norm(grads)})
    return train_step


def _j_optimizer(lr: float, steps: int):
    return j_optim.chain(j_optim.clip_by_global_norm(1.0), j_optim.adamw(
        j_optim.linear_warmup_cosine(lr, 10, steps)))


@pytest.mark.parametrize("arch,S", [("starcoder2-3b", 32), ("rwkv6-3b", 128)])
def test_three_driver_steps_match_the_reference(arch, S):
    """Three steps of the driver's step and the reference driver's jitted
    step (clip -> AdamW, weight decay 0.1, the driver's defaults: LR 3e-4
    warmed up over 10 of 100 steps) from the same parameters and batches:
    losses and gradient norms, then the parameters and the AdamW state
    per leaf."""
    jm, jp, model, params = _pair(arch)
    j_opt, opt = _j_optimizer(3e-4, 100), t_train.make_optimizer(3e-4, 100)
    j_step, step = _j_train_step(jm, j_opt), t_train.make_train_step(model,
                                                                      opt)
    j0 = jax.tree.map(jnp.asarray, jp)
    j_state = {"params": j0, "opt": j_opt.init(j0),
               "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for k in range(3):
        jb, tb = _batch(model.cfg.vocab_size, 2, S, step=k)
        j_state, jm_ = j_step(j_state, jb)
        state, m = step(state, tb)
        for key in ("loss", "gnorm"):
            assert abs(float(m[key]) - float(jm_[key])) <= \
                1e-5 * float(jm_[key]), key
    assert int(state["step"]) == 3
    for part in ("params", "opt"):
        rel = _rel_per_leaf(state[part], j_state[part])
        assert max(rel.values()) <= 1e-5, (part, rel)


def test_donated_optimizer_is_bitwise_the_functional_one():
    """``update``/``apply_updates`` with ``donate=True`` write into the
    given gradients, moments and parameters, bit for bit the functional
    results, over three steps of clip -> AdamW."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(7, 5, generator=g),
              "b": {"c": torch.randn(11, generator=g)}}
    opt = chain(clip_by_global_norm(1.0),
                adamw(linear_warmup_cosine(1e-2, 1, 5)))
    fun = {"params": params, "opt": opt.init(params)}
    don = tree_map(torch.clone, fun)
    for k in range(3):
        grads = tree_map(lambda t: 3 * torch.randn(t.shape, generator=g),
                         params)
        step = torch.tensor(k, dtype=torch.int32)
        upd, o = opt.update(grads, fun["opt"], fun["params"], step)
        fun = {"params": apply_updates(fun["params"], upd), "opt": o}
        given = tree_map(torch.clone, grads)
        leaves = [t for _, t in paths_and_leaves(don)]
        upd, o = opt.update(given, don["opt"], don["params"], step,
                            donate=True)
        p = apply_updates(don["params"], upd, donate=True)
        assert p is don["params"]
        don = {"params": p, "opt": o}
        # the same tensors, written in place
        for a, b in zip(leaves, (t for _, t in paths_and_leaves(don))):
            assert a is b
        for (key, a), (_, b) in zip(paths_and_leaves(fun),
                                    paths_and_leaves(don)):
            assert torch.equal(a, b), key


# ------------------------------------------------------------ the driver
def _cli(tmp, arch, *extra, steps=12, save_every=5):
    return t_train.main(["--arch", arch, "--smoke", "--steps", str(steps),
                         "--batch", "4", "--seq", "64", "--save-every",
                         str(save_every), "--device", "cpu", "--ckpt",
                         str(tmp), *extra])


@pytest.mark.parametrize("arch,steps,save_every,fail_at", [
    ("starcoder2-3b", 12, 5, 7),
    ("rwkv6-3b", 8, 3, 5)])  # 64 tokens: RWKV6's sequential WKV, slower
def test_driver_resumes_bitwise_after_fail_at(tmp_path, arch, steps,
                                              save_every, fail_at):
    """``--fail-at`` stops the run at that step (after a checkpoint);
    ``--resume auto`` finishes it with an uninterrupted run's loss stream
    and state, bit for bit; ``--resume fresh`` starts over."""
    from repro_torch.runtime import InjectedFailure
    kw = dict(steps=steps, save_every=save_every)
    ref_state, ref_hist = _cli(tmp_path / "a", arch, **kw)
    with pytest.raises(InjectedFailure, match=f"step {fail_at}"):
        _cli(tmp_path / "b", arch, "--fail-at", str(fail_at), **kw)
    state, hist = _cli(tmp_path / "b", arch, "--resume", "auto", **kw)
    start = fail_at - fail_at % save_every
    assert len(ref_hist) == steps and hist == ref_hist[start:]
    for (k, a), (_, b) in zip(paths_and_leaves(state),
                              paths_and_leaves(ref_state)):
        assert torch.equal(a, b), k
    if arch == "starcoder2-3b":
        _, fresh = _cli(tmp_path / "b", arch, "--resume", "fresh", **kw)
        assert fresh == ref_hist


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference driver's step and ``TrainLoop`` write a checkpoint at
    step 4; the port's driver resumes it (``--resume auto``) and trains
    steps 4-7 within 1e-5 of the reference's uninterrupted losses."""
    arch, steps, lr, B, S = "starcoder2-3b", 8, 3e-4, 4, 64
    jm, jp, _, _ = _pair(arch)
    j_opt = _j_optimizer(lr, steps)
    j_step = _j_train_step(jm, j_opt)
    task = JTokenTaskConfig(vocab_size=jm.cfg.vocab_size, seq_len=S)

    def init_state():
        p = jax.tree.map(jnp.asarray, jp)
        return {"params": p, "opt": j_opt.init(p),
                "step": jnp.zeros((), jnp.int32)}

    class Batches:
        def __init__(self):
            self.step = 0

        def __iter__(self):
            return self

        def __next__(self):
            b = j_synthetic_lm_batch(task, B, self.step)
            self.step += 1
            return {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}

    ckpt = tmp_path / "ckpt"
    _, part = JTrainLoop(j_step, init_state, str(ckpt), save_every=4).run(
        Batches(), 4, log=None)
    _, whole = JTrainLoop(j_step, init_state, str(tmp_path / "whole"),
                          save_every=100).run(Batches(), steps, log=None)
    assert [h["loss"] for h in part] == [h["loss"] for h in whole[:4]]
    args = t_train.parse_args([
        "--arch", arch, "--smoke", "--steps", str(steps), "--batch", str(B),
        "--seq", str(S), "--lr", str(lr), "--device", "cpu", "--ckpt",
        str(ckpt), "--resume", "auto"])
    # the driver on the float32 stream of the reference's run
    state, hist, _ = t_train.train(
        dataclasses.replace(get_smoke(arch), dtype=torch.float32), args,
        torch.device("cpu"), log=None)
    assert len(hist) == 4 and int(state["step"]) == steps
    for got, want in zip(hist, whole[4:]):
        for key in ("loss", "gnorm"):
            assert abs(got[key] - want[key]) <= 1e-5 * abs(want[key]), key


def test_musicgen_is_refused_where_the_reference_raises_keyerror():
    """musicgen-large takes embeddings (``input_mode="embeds"``) and the
    token batches have none: the reference's loss raises ``KeyError``;
    the port's driver refuses the arch up front, naming the field."""
    jm = j_build_model(dataclasses.replace(j_get_smoke("musicgen-large"),
                                           dtype=jnp.float32))
    jp = j_init_params(jax.random.PRNGKey(0), jm.param_defs(), jnp.float32)
    jb, _ = _batch(jm.cfg.vocab_size, 2, 16)
    with pytest.raises(KeyError, match="embeds"):
        jm.loss_fn(jp, jb)
    with pytest.raises(ValueError, match="input_mode"):
        t_train.train_config(get_smoke("musicgen-large"))
    with pytest.raises(ValueError, match="input_mode"):
        _cli("unused", "musicgen-large")


def test_unknown_strategy_and_a_wider_world_are_refused(tmp_path):
    """An unknown ``--strategy`` still raises, as the reference's lookup
    does. A world of four ranks is no longer refused: four processes with
    torchrun's environment (``RANK``, ``WORLD_SIZE``, a localhost
    rendezvous; gloo on the CPU) train ``fsdp_tp`` over a (data=4) mesh,
    rank 0 alone prints and commits the checkpoint."""
    assert set(t_train.STRATEGIES) == set(J_STRATEGIES)
    with pytest.raises(KeyError, match="bogus"):
        _cli(tmp_path, "starcoder2-3b", "--strategy", "bogus")
    import signal
    import socket
    import subprocess
    import sys
    import time
    with socket.socket() as s:  # a free port for the rendezvous
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(_EXAMPLE), os.pardir, "src")
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.abspath(src), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "2", "--batch", "4", "--seq", "32", "--device", "cpu",
         "--strategy", "fsdp_tp", "--ckpt", str(tmp_path / "w4")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        start_new_session=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(4)]
    end = time.monotonic() + 180
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            os.killpg(p.pid, signal.SIGKILL)
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    assert not late, "ranks past the 180 s deadline"
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-3000:]}"
        assert ("final loss" in log) == (r == 0), (r, log[-500:])
    assert os.listdir(tmp_path / "w4") == ["step_00000002"]


def test_driver_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        t_train.main(["--smoke", "--steps", "1"])


def test_example_runs_end_to_end_on_the_cpu(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location("torch_lm_train_resume",
                                                  _EXAMPLE)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--steps", "12", "--fail-at", "8",
                   "--save-every", "5", "--ckpt", str(tmp_path / "c")])
    assert out["resumed_from"] == 5 and len(out["losses"]) == 7
    assert out["retrained_steps"] == [5, 6, 7] and out["retrained_exact"]
    printed = capsys.readouterr().out
    assert "injected failure at step 8" in printed
    assert "recovered and finished" in printed
