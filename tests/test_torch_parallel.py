"""The port's distribution layer over gloo ranks on the CPU, against the
reference.

Spawned four (or two) gloo ranks a test (``tests/torch_ranks.py``); the
reference's side runs as its own tests run it, in a subprocess over fake
XLA devices:

- ``compressed_psum`` on 4 ranks within 1 ulp of the reference's on 4
  fake devices (``tests/test_parallel.py``'s check), and within its 0.02
  bar of the exact all-reduce;
- ``pipeline_apply`` at 4 stages within 1e-5 of the reference's on the
  reference test's inputs (and of the sequential stack); the same
  4-stage pipe over microbatches that carry a conditioning tensor beside
  the activation, against the stack in order;
- the reference's ``test_distributed_loss_equals_single_device``:
  starcoder2-3b smoke (float32), ``fsdp_tp`` on a (2, 2) mesh under
  activation sharding with sequence parallelism over ``model``: the
  port's loss on the reference's parameters, converted, within 2e-4 of
  the reference's one-device loss;
- ``ShardedBatchIterator`` over a mesh: the global batch is the ranks'
  host batches concatenated in rank order;
- elastic restore: a sharded state saved over (data=2) restores over
  (data=4) and (data=2, model=2), each rank's shard the matching slice of
  the global array; the port's file set restores in the reference.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import checkpoint as j_ckpt
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro_torch.convert import params_from_jax
from torch_ranks import PRELUDE, SRC, spawn

CHILD = PRELUDE + '''
from repro_torch.launch.mesh import make_test_mesh
out = {}
if job == "psum":
    from repro_torch.parallel import compressed_psum
    x = inp["x"][rank:rank + 1]
    out["compressed"] = compressed_psum(x)
    exact = x.clone()
    dist.all_reduce(exact)
    out["exact"] = exact
elif job == "pipeline":
    from repro_torch.parallel import pipeline_apply
    mesh = make_test_mesh((world,), ("stage",), device="cpu")
    Ws = inp["Ws"]

    def block_fn(params, x):
        for i in range(params.shape[0]):
            x = torch.tanh(x @ params[i])
        return x
    out["out"] = pipeline_apply(block_fn, Ws, inp["x_micro"], mesh)

    def cond_fn(params, xc):  # the conditioning travels with the batch
        x, c = xc["x"], xc["c"]
        for i in range(params.shape[0]):
            x = torch.tanh(x @ params[i] + c[:, None, :])
        return {"x": x, "c": c}
    out["cond"] = pipeline_apply(cond_fn, Ws, {"x": inp["xc"],
                                              "c": inp["c"]}, mesh)
elif job == "loss22":
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.models.common import (NamedSharding, activation_sharding,
                                           batch_spec, distribute,
                                           distribute_tree, specs_for)
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = make_test_mesh((2, 2), ("data", "model"), device="cpu")
    model = build_model(dataclasses.replace(get_smoke("starcoder2-3b"),
                                            dtype=torch.float32))
    specs = specs_for(model.param_defs(), "fsdp_tp", mesh)
    params = distribute_tree(inp["params"], specs, mesh)
    bs = NamedSharding(mesh, batch_spec(mesh.mesh_dim_names, None))
    batch = {k: distribute(v, mesh, bs.placements)
             for k, v in inp["batch"].items()}
    with activation_sharding(("data",), seq_axes=("model",),
                             seq_divisor=2), implicit_replication():
        loss = model.loss_fn(params, batch)
    out["loss"] = float(loss.full_tensor())
    out["placements"] = sorted({str(p.placements) for p in
                                __import__("repro_torch.tree", fromlist=["x"])
                                .tree_leaves(params)})
elif job == "batches":
    from repro_torch.data import (ShardedBatchIterator, TokenTaskConfig,
                                  synthetic_lm_batch)
    task = TokenTaskConfig(vocab_size=64, seq_len=8)
    for shape, axes in (((world,), ("data",)), ((2, 2), ("data", "model"))):
        mesh = make_test_mesh(shape, axes, device="cpu")
        it = ShardedBatchIterator(
            lambda rows, step, host: synthetic_lm_batch(task, rows, step,
                                                        host), 8, mesh=mesh)
        it.step = 3
        b = next(it)
        out[axes] = {k: v.full_tensor() for k, v in b.items()}
        out[axes, "placements"] = str(b["tokens"].placements)
elif job in ("save2", "restore4"):
    from repro_torch import checkpoint as ckpt
    from repro_torch.models.common import (NamedSharding, distribute_tree,
                                           specs_for)
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.tree import paths_and_leaves, tree_map
    defs = build_model(get_smoke("starcoder2-3b")).param_defs()
    full = inp["params"]
    if job == "save2":
        mesh = make_test_mesh((world,), ("data",), device="cpu")
        tree = {"params": distribute_tree(full, specs_for(defs, "fsdp_tp",
                                                          mesh), mesh),
                "step": torch.tensor(7, dtype=torch.int32)}
        out["dir"] = ckpt.save(os.path.join(d, "ck"), 7, tree)
        out["committed"] = os.path.isdir(out["dir"])
    else:
        for shape, axes in (((4,), ("data",)), ((2, 2), ("data", "model"))):
            mesh = make_test_mesh(shape, axes, device="cpu")
            specs = specs_for(defs, "fsdp_tp", mesh)
            shard = tree_map(lambda s: NamedSharding(mesh, s), specs)
            got, step = ckpt.restore(inp["dir"], {"params": full},
                                     shardings={"params": shard})
            want = distribute_tree(full, specs, mesh)
            local = {k: (v.to_local(), str(v.placements)) for k, v in
                     paths_and_leaves(got["params"])}
            expect = {k: v.to_local() for k, v in paths_and_leaves(want)}
            out[axes] = {"step": step, "equal": all(
                torch.equal(local[k][0], expect[k]) for k in expect),
                "sharded": any("Shard" in p for _, p in local.values())}
torch.save(out, os.path.join(d, f"out{rank}.pt"))
dist.destroy_process_group()
'''


def run_reference(code: str, n_dev: int) -> None:
    """``code`` in a subprocess of the reference over ``n_dev`` fake XLA
    devices (as ``tests/test_parallel.py`` runs it)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               f"count={n_dev}", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([SRC, os.environ.get(
                   "PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr


def ulps(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b) / np.spacing(np.abs(b))))


def test_compressed_psum_on_4_ranks_matches_the_reference(tmp_path):
    x = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    run_reference(f'''
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.parallel.compression import compressed_psum
mesh = jax.make_mesh((4,), ("d",), devices=jax.devices())
x = jnp.asarray(np.load("{tmp_path}/x.npy"))
f = shard_map(lambda v: compressed_psum(v, "d"), mesh=mesh,
              in_specs=P("d"), out_specs=P("d"))
np.save("{tmp_path}/ref.npy", np.asarray(f(x)))
''', 4)
    ref = np.load(tmp_path / "ref.npy")
    ranks = spawn(tmp_path, CHILD, "psum", {"x": torch.from_numpy(x)})
    for r, res in enumerate(ranks):
        got = res["compressed"].numpy()
        assert got.dtype == np.float32 and got.shape == (1, 64)
        assert ulps(got, ref[r:r + 1]) <= 1.0, r
        exact = res["exact"].numpy()
        assert np.max(np.abs(got - exact)) / np.max(np.abs(exact)) < 0.02


def test_pipeline_at_4_stages_matches_the_reference(tmp_path):
    run_reference(f'''
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import pipeline_apply
mesh = jax.make_mesh((4,), ("stage",), devices=jax.devices()[:4])
n_stages, layers_per, d = 4, 2, 8
Ws = jax.random.normal(jax.random.PRNGKey(0), (n_stages, layers_per, d, d)) * 0.1
def block_fn(params, x):
    for i in range(layers_per):
        x = jnp.tanh(x @ params[i])
    return x
x_micro = jax.random.normal(jax.random.PRNGKey(1), (6, 3, d))
out = pipeline_apply(block_fn, Ws, x_micro, mesh)
ref = x_micro
for s in range(n_stages):
    ref = jax.vmap(lambda xm: block_fn(Ws[s], xm))(ref)
np.savez("{tmp_path}/ref.npz", Ws=np.asarray(Ws), x=np.asarray(x_micro),
         out=np.asarray(out), seq=np.asarray(ref))
''', 4)
    ref = np.load(tmp_path / "ref.npz")
    rng = np.random.default_rng(2)
    xc = rng.normal(size=(5, 2, 3, 8)).astype(np.float32)
    c = rng.normal(size=(5, 2, 8)).astype(np.float32) * 0.1
    ranks = spawn(tmp_path, CHILD, "pipeline", {
        "Ws": torch.from_numpy(ref["Ws"]), "x_micro": torch.from_numpy(
            ref["x"]), "xc": torch.from_numpy(xc), "c": torch.from_numpy(c)})
    # the conditioned stack in order, in one process
    Ws = torch.from_numpy(ref["Ws"])
    seq = torch.from_numpy(xc)
    for s in range(4):
        for i in range(Ws.shape[1]):
            seq = torch.tanh(seq @ Ws[s, i] + torch.from_numpy(c)[:, :, None])
    for r, res in enumerate(ranks):
        out = res["out"].numpy()
        assert np.max(np.abs(out - ref["out"])) < 1e-5, r
        assert np.max(np.abs(out - ref["seq"])) < 1e-5, r
        assert torch.allclose(res["cond"]["x"], seq, atol=1e-5, rtol=0), r
        assert torch.equal(res["cond"]["c"], torch.from_numpy(c)), r


def test_distributed_loss_equals_the_references_single_device(tmp_path):
    """The reference's ``test_distributed_loss_equals_single_device`` held
    across the packages: fsdp_tp on (data=2, model=2) with activation
    sharding (SP over model, divisor 2), float32."""
    jcfg = dataclasses.replace(j_get_smoke("starcoder2-3b"),
                               dtype=jnp.float32)
    jm = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      jm.param_defs(), jnp.float32))
    batch = {"tokens": np.arange(128).reshape(4, 32) % jcfg.vocab_size,
             "labels": np.ones((4, 32), np.int32)}
    ref = float(jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in
                                batch.items()}))
    ranks = spawn(tmp_path, CHILD, "loss22", {
        "params": params_from_jax(jp, config=jcfg),
        "batch": {k: torch.from_numpy(v.astype(np.int64))
                  for k, v in batch.items()}})
    for r, res in enumerate(ranks):
        assert abs(res["loss"] - ref) < 2e-4, (r, res["loss"], ref)
    assert any("Shard" in p for p in ranks[0]["placements"])


def test_sharded_batches_are_the_host_batches_in_rank_order(tmp_path):
    from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
    task = TokenTaskConfig(vocab_size=64, seq_len=8)
    ranks = spawn(tmp_path, CHILD, "batches", {})
    four = [synthetic_lm_batch(task, 2, 3, h) for h in range(4)]
    two = [synthetic_lm_batch(task, 4, 3, h) for h in range(2)]
    for res in ranks:
        for axes, hosts in ((("data",), four), (("data", "model"), two)):
            for k in ("tokens", "labels"):
                want = np.concatenate([h[k] for h in hosts])
                assert np.array_equal(res[axes][k].numpy(), want), (axes, k)
        assert res[("data",), "placements"] == "(Shard(dim=0),)"
        assert res[("data", "model"), "placements"] == \
            "(Shard(dim=0), Replicate())"


def test_elastic_restore_saved_over_2_restored_over_4(tmp_path):
    """fsdp_tp state of starcoder2-3b smoke saved over (data=2): one
    committed directory of global arrays (rank 0 wrote it); restored over
    (data=4) and (data=2, model=2) under ``shardings=``, each rank's shards
    equal those of the global arrays placed there directly; the reference's
    ``restore`` reads the same files."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model, init_params
    from repro_torch.tree import paths_and_leaves
    model = build_model(get_smoke("starcoder2-3b"))
    full = init_params(torch.Generator().manual_seed(3), model.param_defs())
    saved = spawn(tmp_path, CHILD, "save2", {"params": full}, world=2)
    d = saved[0]["dir"]
    assert all(r["committed"] for r in saved)
    restore_dir = tmp_path / "r"
    restore_dir.mkdir()
    ranks = spawn(restore_dir, CHILD, "restore4",
                  {"params": full, "dir": os.path.dirname(d)}, world=4)
    for r, res in enumerate(ranks):
        for axes in (("data",), ("data", "model")):
            assert res[axes]["step"] == 7
            assert res[axes]["equal"] and res[axes]["sharded"], (r, axes)
    # the reference reads the port's sharded save as global arrays
    target = {"params": jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                                     {k: v for k, v in full.items()}),
              "step": np.zeros((), np.int32)}
    jtree, step = j_ckpt.restore(os.path.dirname(d), target)
    assert step == 7 and int(jtree["step"]) == 7
    flat = dict(paths_and_leaves(full))
    for k, v in paths_and_leaves(jax.device_get(jtree["params"])):
        assert np.array_equal(np.asarray(v), flat[k].numpy()), k
