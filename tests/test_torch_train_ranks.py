"""``launch.train`` over four gloo ranks on the CPU, against one process.

Each test spawns four ranks (``tests/torch_ranks.py``: ``OMP_NUM_THREADS=1``,
a file store in ``tmp_path``, the group killed at its deadline) that run
the driver's ``train`` on a ``("data",)`` mesh of the four: the parameters
DTensors placed by ``specs_for(defs, strategy, mesh)``, the batches
sharded over ``data``, the loop inside ``activation_sharding``. The one
process it is held against runs the driver's own init and step (nothing
placed) over the global batch, which is the four ranks' host batches
concatenated in rank order. Bar: every loss within 1e-5 (relative) and
every parameter leaf after 2 steps within 1e-5 max(1, max|leaf|) of the
one process (the repo's kernel bars' form: a norm weight drawn as zeros
is ~LR after two steps, and its relative error there is the float32
noise of the gradients themselves, ~3e-5 of the one-process gradients
against float64 at smoke width). Each leaf moves only ~3e-5 in the two
warm-up steps, under that bar, so each leaf's change is also held
against the one process's change: within 5% of its largest element (at
most 1.2% measured over the families and strategies; a step that
applied no update is 100% off). For each family the driver takes
(dense, MoE, MLA with MTP, RWKV6, Zamba2) under all four strategies,
and ``fsdp_tp`` again under ``remat="full"``. And ``--fail-at`` over
the ranks: the run stopped at a step, then resumed from the checkpoint
rank 0 wrote, is bit for bit the uninterrupted run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
from repro_torch.launch import train as t_train
from repro_torch.models import build_model
from repro_torch.tree import paths_and_leaves
from torch_ranks import PRELUDE, spawn

STRATEGIES = ("dp", "tp", "fsdp_tp", "serve_2d")
WORLD, BATCH, SEQ, STEPS, LR = 4, 8, 32, 2, 3e-4
#: each leaf's change over the steps against one process's change:
#: max|delta got - delta want| <= MOVE_LIMIT max|delta want|
MOVE_LIMIT = 0.05

CHILD = PRELUDE + '''
import dataclasses
from repro_torch.configs import get_smoke
from repro_torch.launch import train as t_train
from repro_torch.runtime import InjectedFailure


def run(strategy, ckpt, *extra):
    args = t_train.parse_args([
        "--arch", inp["arch"], "--smoke", "--steps", str(inp["steps"]),
        "--batch", str(inp["batch"]), "--seq", str(inp["seq"]), "--lr",
        str(inp["lr"]), "--device", "cpu", "--ckpt", ckpt, "--strategy",
        strategy, *extra])
    cfg = dataclasses.replace(get_smoke(inp["arch"]), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, remat=inp.get("remat", cfg.remat))
    state, hist, _ = t_train.train(cfg, args, torch.device("cpu"), log=None)
    params = {k: v.full_tensor() for k, v in
              __import__("repro_torch.tree", fromlist=["x"])
              .paths_and_leaves(state["params"])}
    return {"hist": hist, "params": params, "step": int(state["step"]),
            "placements": {k: str(v.placements) for k, v in
                           __import__("repro_torch.tree", fromlist=["x"])
                           .paths_and_leaves(state["params"])}}


out = {}
if job == "strategies":
    for s in inp["strategies"]:
        out[s] = run(s, os.path.join(d, f"ckpt_{s}"), "--save-every", "100")
elif job == "fail_at":
    ckpt = os.path.join(d, "ckpt_b")
    out["whole"] = run("fsdp_tp", os.path.join(d, "ckpt_a"),
                       "--save-every", "2")
    try:
        run("fsdp_tp", ckpt, "--save-every", "2", "--fail-at", "3")
        out["failed"] = False
    except InjectedFailure:
        out["failed"] = True
    out["resumed"] = run("fsdp_tp", ckpt, "--save-every", "2",
                         "--resume", "auto")
torch.save(out if rank == 0 else {}, os.path.join(d, f"out{rank}.pt"))
dist.destroy_process_group()
'''


def one_process(arch: str, steps: int = STEPS, remat: str = "none"):
    """The driver's init and step in one process (nothing placed) over
    the four hosts' batches concatenated: losses, final parameters and
    initial parameters."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=torch.float32,
                              remat=remat)
    model = build_model(t_train.train_config(cfg))
    opt = t_train.make_optimizer(LR, steps)
    state = t_train.make_init_state(model, opt, torch.device("cpu"))()
    init = {k: v.clone() for k, v in paths_and_leaves(state["params"])}
    step = t_train.make_train_step(model, opt)
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=SEQ)
    losses = []
    for s in range(steps):
        parts = [synthetic_lm_batch(task, BATCH // WORLD, s, h)
                 for h in range(WORLD)]
        batch = {k: torch.as_tensor(np.concatenate([p[k] for p in parts]))
                 for k in parts[0]}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, dict(paths_and_leaves(state["params"])), init


def assert_close_to(got: dict, losses, params, init, label: str):
    assert [h["loss"] for h in got["hist"]] == pytest.approx(
        losses, rel=1e-5, abs=0), label
    assert got["params"].keys() == params.keys()
    for k, want in params.items():
        scale = max(1.0, float(want.abs().max()))
        err = float((got["params"][k] - want).abs().max())
        assert err <= 1e-5 * scale, (label, k, err, scale)
        # the update itself, against its own size: a step that applied
        # no update, or one rank's gradient, is ~1 off here
        moved = want - init[k]
        peak = float(moved.abs().max())
        off = float((got["params"][k] - init[k] - moved).abs().max())
        assert peak > 0 and off <= MOVE_LIMIT * peak, (label, k, off, peak)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "dbrx-132b",
                                  "deepseek-v3-671b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_train_over_4_ranks_matches_one_process(tmp_path, arch):
    """Dense, MoE, MLA with MTP, RWKV6 and Zamba2, under dp, tp, fsdp_tp
    and serve_2d on a (data=4) mesh: losses and parameters after 2 steps
    within 1e-5 of one process. ``fsdp_tp`` shards the ``embed`` dims and
    ``serve_2d`` the ``mlp`` dims over data (``tp`` finds no ``model``
    axis and places like ``dp``)."""
    ranks = spawn(tmp_path, CHILD, "strategies", {
        "arch": arch, "steps": STEPS, "batch": BATCH, "seq": SEQ, "lr": LR,
        "strategies": STRATEGIES}, world=WORLD)
    losses, params, init = one_process(arch)
    got = ranks[0]
    for s in STRATEGIES:
        assert got[s]["step"] == STEPS
        assert_close_to(got[s], losses, params, init, s)
    assert any("Shard" in p for p in got["fsdp_tp"]["placements"].values())
    assert all(p == "(Replicate(),)"
               for p in got["dp"]["placements"].values())


@pytest.mark.parametrize("arch", ["starcoder2-3b", "dbrx-132b",
                                  "deepseek-v3-671b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_fsdp_tp_under_remat_over_4_ranks_matches_one_process(tmp_path,
                                                              arch):
    """``fsdp_tp`` with ``remat="full"`` (the published configs' setting):
    each layer's shards gathered inside its checkpointed block and
    gathered again in the backward; losses and parameters after 2 steps
    within 1e-5 of one process under the same remat."""
    ranks = spawn(tmp_path, CHILD, "strategies", {
        "arch": arch, "steps": STEPS, "batch": BATCH, "seq": SEQ, "lr": LR,
        "strategies": ("fsdp_tp",), "remat": "full"}, world=WORLD)
    losses, params, init = one_process(arch, remat="full")
    got = ranks[0]["fsdp_tp"]
    assert got["step"] == STEPS
    assert any("Shard" in p for p in got["placements"].values())
    assert_close_to(got, losses, params, init, "fsdp_tp remat=full")


def test_fail_at_and_resume_over_4_ranks_is_bitwise(tmp_path):
    """starcoder2-3b under fsdp_tp over 4 ranks, 4 steps, a checkpoint
    every 2: stopped by ``--fail-at 3``, then resumed from step 2 (the
    sharded state gathered and written by rank 0, restored into each
    rank's shards), the losses and parameters are bit for bit the
    uninterrupted run's."""
    ranks = spawn(tmp_path, CHILD, "fail_at", {
        "arch": "starcoder2-3b", "steps": 4, "batch": BATCH, "seq": SEQ,
        "lr": LR}, world=WORLD)
    got = ranks[0]
    assert got["failed"]
    whole, resumed = got["whole"], got["resumed"]
    assert resumed["step"] == whole["step"] == 4
    assert resumed["hist"] == whole["hist"][2:]
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k
