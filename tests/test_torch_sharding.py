"""The port's sharded path (``sample_sharded``, ``serve/sharding.py``,
sharded classifier-free guidance, ``ServeEngine(mesh=)``,
``launch.sample --cfg-shard``) over ``torch.distributed`` on the CPU.

Mirrors the reference's mesh tests (``tests/test_serve.py``:
``align_bucket_sizes``, the one-device mesh engine, the refusals of
``sample_sharded``, the 8-device equivalence; ``tests/test_e2e_dit.py``:
sharded CFG). In process, at one gloo rank: the bucket arithmetic, the
``auto_*`` meshes, the refusals with the reference's messages, the cache
keys, and the engine on a (1, 1) mesh, bitwise the unsharded engine (the
same shapes). Spawned, four gloo ranks a test (``OMP_NUM_THREADS=1``, a
file store in ``tmp_path``, the whole group killed at a 120 s deadline):

- (a) on meshes (4, 1) and (2, 2) (data by model), every rank's shard is
  bitwise ``sample_batched`` of that shard alone, and the gathered batch is
  within 1e-6 (max abs, the reference test's bar) of the port's unsharded
  solve and within 1e-5 (relative in norm) of the reference's one-device
  ``sample_batched`` fed its own draws (``split(key, M)``);
- (b) the engine on (4, 1) serves 5 requests within 1e-6 of the unsharded
  engine, with 3 padded slots;
- (c) a DiT-S smoke (4 layers, ``denoiser_cond`` 4) on a (cfg=2, data=2)
  mesh. On the reference's tame weights, converted: the guided solve at
  2.5 and its interval-2 cached twin within 1e-5 relative of the
  reference's one-device guided ``sample_batched`` fed its own draws. On
  weights nudged as in ``tests/test_e2e_dit.py``: the guided solve within
  1e-5 relative of the one-call CFG ``sample_batched``; at scale 1 each
  data shard bitwise the unguided ``sample_batched`` of that shard; under
  feature caching (interval 2, and ``residual:0.05``) within 1e-5 of the
  unsharded cached solve, both cfg ranks seeing the same refresh flags at
  every call and firing the gate alike.

Bitwise holds only where the shapes match: a shard has fewer rows than the
batch, a cfg branch half the rows of the one-call pair, and torch's
products are not bitwise across row counts.
"""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

try:  # the JAX reference; absent on a card machine without JAX
    import jax
    import jax.numpy as jnp
    from repro.core import GMM as JGMM
    from repro.core import Denoiser as JDenoiser
    from repro.core import get_schedule as j_get_schedule
    from repro.core import samplers as jsamplers
    from repro.core.denoiser import CachedNetwork as JCachedNetwork
    from test_torch_guidance import dit_pair as guidance_dit_pair
except ImportError:  # pragma: no cover - exercised on the card machine
    jax = None
from repro_torch.core import get_schedule
from repro_torch.core import samplers as tsamplers
from repro_torch.core.denoiser import lane_view
from repro_torch.launch import sample as tlaunch
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.serve import (ServeEngine, align_bucket_sizes, auto_mesh,
                               data_axis_size)
from repro_torch.serve.sharding import auto_cfg_mesh
import torch_ranks

TS = get_schedule("vp_linear")
JS = None if jax is None else j_get_schedule("vp_linear")
SPEC = tsamplers.SamplerSpec(name="sa", schedule=TS, n_steps=6, tau=0.7)
SHAPE = (64, 2)
DEADLINE_S = 120.0


@pytest.fixture
def reference():
    if jax is None:
        pytest.skip("the JAX reference is not installed here")


def STABLE(x, t):
    """Lane-batched fusion-stable model: one t per lane."""
    return 0.3 * x * lane_view(torch.cos(t), x)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo process group of one rank (a file store in ``tmp_path``)
    for the test's duration; the compile cache cleared before."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    tsamplers.clear_compile_cache()
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh11(axes=("data", "model")):
    return make_test_mesh((1, 1), axes, device="cpu")


def fake_mesh(shape, axes, device_type="cpu"):
    """A stand-in mesh of more ranks than the test has, for the checks that
    run before any process group is touched."""
    return types.SimpleNamespace(
        mesh_dim_names=axes, device_type=device_type,
        mesh=torch.arange(int(np.prod(shape))).reshape(shape))


def serve_rids(eng, rids, spec=SPEC, shape=SHAPE):
    for r in rids:
        eng.submit(spec, shape, rid=r)
    return {res.rid: res.x0 for res in eng.run()}


# ------------------------------------------------------ bucket arithmetic
@pytest.mark.parametrize("sizes,n_data,want", [
    ((1, 2, 4, 8), 4, (4, 8)), ((3,), 2, (4,)), ((1, 2), 1, (1, 2)),
    ((8, 5, 6), 4, (8,)), ((1,), 3, (3,))])
def test_align_bucket_sizes_rounds_up_to_data_multiples(sizes, n_data,
                                                        want):
    assert align_bucket_sizes(sizes, n_data) == want


def test_align_bucket_sizes_refuses_an_empty_axis():
    with pytest.raises(ValueError, match="must be >= 1"):
        align_bucket_sizes((1, 2), 0)


@pytest.mark.parametrize("shape,axes,axis,want", [
    ((2, 4), ("data", "model"), "data", 2),
    ((2, 4), ("data", "model"), "model", 4),
    ((2, 3), ("cfg", "data"), "data", 3)])
def test_data_axis_size(shape, axes, axis, want):
    assert data_axis_size(fake_mesh(shape, axes), axis) == want
    with pytest.raises(ValueError, match="mesh has no axis 'nope'"):
        data_axis_size(fake_mesh(shape, axes), "nope")


@pytest.mark.parametrize("group", [False, True])
@pytest.mark.parametrize("auto", [auto_mesh, auto_cfg_mesh])
def test_auto_meshes_are_none_at_one_rank(tmp_path, group, auto):
    """No process group, or one of one rank: the engine stays unsharded
    (the reference's one-device ``None``)."""
    assert not dist.is_initialized()
    if group:
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp_path}/store")
    try:
        assert auto(device="cpu") is None
    finally:
        if group:
            dist.destroy_process_group()


def test_production_mesh_names_the_ranks_it_needs():
    with pytest.raises(RuntimeError, match=r"needs 256 devices, have 1 .* "
                       "torchrun"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


# ------------------------------------------------------------- refusals
def _plan():
    return tsamplers.build_plan(SPEC)


REFUSALS = {
    "no_axis": (lambda: mesh11(), dict(data_axis="nope"), "no axis 'nope'"),
    "ragged": (lambda: fake_mesh((4, 1), ("data", "model")), {},
               r"request batch 2 is not divisible by mesh axis 'data' "
               r"\(size 4\); pad the bucket first"),
    "cfg_missing": (lambda: mesh11(), dict(cfg_axis="cfg"),
                    "cfg_axis='cfg' needs a mesh with that axis"),
    "cfg_size": (lambda: mesh11(("cfg", "data")), dict(cfg_axis="cfg"),
                 "cfg_axis 'cfg' has size 1; sharded CFG splits exactly"),
    "cfg_unguided": (lambda: fake_mesh((2, 1), ("cfg", "data")),
                     dict(cfg_axis="cfg"),
                     "cfg_axis only applies to a guidance-enabled "
                     "Denoiser"),
    "device": (lambda: fake_mesh((1, 1), ("data", "model"), "cuda"), {},
               "'cuda' mesh cannot place a batch on cpu"),
}


@pytest.mark.parametrize("entry", ["sample_sharded", "Sampler",
                                   "warmup"])
@pytest.mark.parametrize("case", list(REFUSALS))
def test_sharded_entry_points_refuse_like_the_reference(one_rank, entry,
                                                        case):
    make_mesh, kw, match = REFUSALS[case]
    mesh = make_mesh()
    xT = torch.zeros((2,) + SHAPE)
    noise = torch.zeros((2, SPEC.n_steps) + SHAPE)
    with pytest.raises(ValueError, match=match):
        if entry == "warmup":
            tsamplers.warmup(_plan(), STABLE, SHAPE, device="cpu", batch=2,
                             mesh=mesh, **kw)
        elif entry == "Sampler":
            tsamplers.Sampler(SPEC).sample_sharded(STABLE, xT, noise=noise,
                                                   mesh=mesh, **kw)
        else:
            tsamplers.sample_sharded(_plan(), STABLE, xT, noise=noise,
                                     mesh=mesh, **kw)
    assert tsamplers.compile_cache_stats()["size"] == 0


def test_sample_sharded_rejects_mismatched_leading_axes(one_rank):
    xT = torch.zeros((2,) + SHAPE)
    with pytest.raises(ValueError, match="leading axes must match: x_T 2 "
                       "vs noise 1"):
        tsamplers.sample_sharded(_plan(), STABLE, xT, mesh=mesh11(),
                                 noise=torch.zeros((1, 6) + SHAPE))
    with pytest.raises(ValueError, match="leading axes must match: x_T 2 "
                       "vs generators 3"):
        tsamplers.sample_sharded(_plan(), STABLE, xT, mesh=mesh11(),
                                 generators=[torch.Generator()] * 3)
    with pytest.raises(ValueError, match="pass its global lane count"):
        tsamplers.warmup(_plan(), STABLE, SHAPE, device="cpu", mesh=mesh11())


def test_engine_refuses_like_the_reference(one_rank):
    with pytest.raises(ValueError, match="step scheduler is single-device"):
        ServeEngine(STABLE, device="cpu", scheduler="step", mesh=mesh11())
    with pytest.raises(ValueError, match="cfg_axis needs a mesh"):
        ServeEngine(STABLE, device="cpu", cfg_axis="cfg")
    with pytest.raises(ValueError, match="mesh has no axis 'rows'"):
        ServeEngine(STABLE, device="cpu", mesh=mesh11(), data_axis="rows")
    with pytest.raises(ValueError, match="'cuda' mesh cannot serve on cpu"):
        ServeEngine(STABLE, device="cpu",
                    mesh=fake_mesh((1, 1), ("data", "model"), "cuda"))
    eng = ServeEngine(STABLE, device="cpu", bucket_sizes=(1, 3, 8),
                      mesh=fake_mesh((4, 1), ("data", "model")))
    assert eng.bucket_sizes == (4, 8)


# ------------------------------------------------- one rank, one device
def test_engine_on_a_one_rank_mesh_is_bitwise_unsharded(one_rank):
    plain = serve_rids(ServeEngine(STABLE, bucket_sizes=(4,), device="cpu"),
                       [0, 1, 2])
    eng = ServeEngine(STABLE, bucket_sizes=(4,), device="cpu",
                      mesh=mesh11())
    shard = serve_rids(eng, [0, 1, 2])
    for r in (0, 1, 2):
        assert torch.equal(plain[r], shard[r]), r
    assert eng.stats()["padded_slots"] == 1


def test_sharded_and_unsharded_entries_are_distinct(one_rank):
    """The mesh joins the key: sharded, unsharded and a second layout over
    the same rank are three entries; ``donate`` (ignored: nothing to
    donate) does not split the cache; a tau re-plan on the sharded one is
    a hit in the same entry and graph signature."""
    plan = _plan()
    g = torch.Generator().manual_seed(0)
    xT = torch.randn((2,) + SHAPE, generator=g)
    noise = torch.randn((2, SPEC.n_steps) + SHAPE, generator=g)
    ref = tsamplers.sample_batched(plan, STABLE, xT, noise=noise)
    out = tsamplers.sample_sharded(plan, STABLE, xT, noise=noise,
                                   mesh=mesh11())
    assert torch.equal(out, ref)
    st = tsamplers.compile_cache_stats()
    assert (st["misses"], st["hits"], st["size"]) == (2, 0, 2)
    tsamplers.sample_sharded(plan, STABLE, xT, noise=noise,
                             mesh=mesh11(("model", "data")))
    st = tsamplers.compile_cache_stats()
    assert (st["misses"], st["hits"], st["size"]) == (3, 0, 3)
    for donate in (True, False):
        d = tsamplers.sample_sharded(plan, STABLE, xT, noise=noise,
                                     mesh=mesh11(), donate=donate)
        assert torch.equal(d, out)
    st = tsamplers.compile_cache_stats()
    assert (st["misses"], st["hits"], st["size"]) == (3, 2, 3)
    replan = tsamplers.build_plan(SPEC.replace(tau=0.3))
    again = tsamplers.sample_sharded(replan, STABLE, xT, noise=noise,
                                     mesh=mesh11())
    st = tsamplers.compile_cache_stats()
    assert (st["misses"], st["hits"], st["graphs"]) == (3, 3, 0)
    assert not torch.equal(again, out)
    entries = [e for k, e in tsamplers.base._COMPILE_CACHE.items()
               if k[-1] is not None]
    assert all(len(e.runs) == 1 for e in entries)
    assert st["eager_entries"] == 0


def test_sharded_trajectory_and_generators_follow_sample_batched(one_rank):
    plan = _plan()
    xT = torch.randn((2,) + SHAPE, generator=torch.Generator().manual_seed(1))

    def gens():
        return [torch.Generator().manual_seed(s) for s in (5, 6)]

    ref = tsamplers.sample_batched(plan, STABLE, xT, gens(), trajectory=True)
    out = tsamplers.sample_sharded(plan, STABLE, xT, gens(), mesh=mesh11(),
                                   trajectory=True)
    assert torch.equal(out[0], ref[0])
    assert all(torch.equal(out[1][k], ref[1][k]) for k in ("x", "x0"))
    assert out[1]["x"].shape == (2, SPEC.n_steps) + SHAPE


# -------------------------------------------------------- launch.sample
@pytest.mark.parametrize("group", [False, True])
def test_launch_sample_cfg_shard_refusals(tmp_path, group):
    base = ["--arch", "dit-s", "--smoke", "--batch", "2", "--seq", "16",
            "--nfe", "9", "--device", "cpu", "--cfg-shard"]
    with pytest.raises(SystemExit, match="--cfg-shard needs "
                       "--guidance-scale"):
        tlaunch.main(base)
    assert not dist.is_initialized()
    if group:
        dist.init_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp_path}/store")
    try:
        with pytest.raises(SystemExit, match=r"needs an even device count "
                           r">= 2 \(have 1\)"):
            tlaunch.main(base + ["--guidance-scale", "1.5"])
    finally:
        if group:
            dist.destroy_process_group()


# ------------------------------------------------------ spawned 4 ranks
CHILD = r'''
import os, sys, dataclasses
import torch, torch.distributed as dist
job, rank, world, d = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{d}/store",
                        rank=rank, world_size=world)
from repro_torch.core import GMM, CachedNetwork, Denoiser, get_schedule
from repro_torch.core import samplers as S
from repro_torch.core.denoiser import lane_view
from repro_torch.kernels import graph_gate
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serve import ServeEngine, auto_mesh
from repro_torch.serve.sharding import auto_cfg_mesh
TS = get_schedule("vp_linear")
inp = torch.load(os.path.join(d, "inputs.pt"))
res = {}
gmm = GMM.default_2d().model_fn(TS, "data")


def model(x, t):  # the GMM oracle per lane (it takes one t)
    return torch.stack([gmm(x[l], t[l]) for l in range(x.shape[0])])


def shard_of(mesh, axis, K):
    g = mesh.get_group(axis)
    k = K // dist.get_world_size(g)
    return dist.get_rank(g) * k, (dist.get_rank(g) + 1) * k


if job == "gmm":
    spec = S.SamplerSpec(name="sa", schedule=TS, n_steps=6, tau=0.7)
    plan = S.build_plan(spec)
    xT, noise = inp["xT"], inp["noise"]
    res["unsharded"] = S.sample_batched(plan, model, xT, noise=noise)
    for shape in [(4, 1), (2, 2)]:
        mesh = make_test_mesh(shape, ("data", "model"), device="cpu")
        out = S.sample_sharded(plan, model, xT, noise=noise, mesh=mesh)
        lo, hi = shard_of(mesh, "data", xT.shape[0])
        alone = S.sample_batched(plan, model, xT[lo:hi], noise=noise[lo:hi])
        res[shape] = {"out": out, "shard": (lo, hi),
                      "bitwise": torch.equal(out[lo:hi], alone)}
    res["auto_mesh"] = (tuple(auto_mesh(device="cpu").mesh.shape),
                        auto_mesh(device="cpu").mesh_dim_names)
    m = auto_cfg_mesh(device="cpu")
    res["auto_cfg_mesh"] = (tuple(m.mesh.shape), m.mesh_dim_names)
    res["stats"] = S.compile_cache_stats()
elif job == "engine":
    spec = S.SamplerSpec(name="sa", schedule=TS, n_steps=6, tau=0.7)
    mesh = make_test_mesh((4, 1), ("data", "model"), device="cpu")
    e1 = ServeEngine(model, bucket_sizes=(8,), device="cpu")
    e2 = ServeEngine(model, bucket_sizes=(8,), device="cpu", mesh=mesh)
    for r in range(5):
        e1.submit(spec, (64, 2), rid=r)
        e2.submit(spec, (64, 2), rid=r)
    res["plain"] = {x.rid: x.x0 for x in e1.run()}
    res["sharded"] = {x.rid: x.x0 for x in e2.run()}
    res["padded_slots"] = e2.stats()["padded_slots"]
    res["microbatches"] = e2.stats()["microbatches"]
elif job == "cfg":
    from repro_torch.configs import get_smoke
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.models.tame import tame_networks
    cfg = dataclasses.replace(get_smoke("dit-s"), n_layers=4,
                              denoiser_cond=4, dtype=torch.float32)
    dit = TransformerLM(cfg)
    # adaLN-zero init makes blocks identity: nudge so cond != uncond
    g = torch.Generator().manual_seed(0)
    params = init_params(g, dit.param_defs(), torch.float32, "cpu")
    params = torch.utils._pytree.tree_map(
        lambda p: p + 0.02 * torch.randn(p.shape, generator=g), params)
    seen = []

    def denoisers(params, mu):
        """(unguided, guided and cached) Denoisers over ``params``; the
        cached network records its refresh flags in ``seen``."""
        net, cached = tame_networks(dit, params, lambda seq: mu)

        def call(x, t, c, feats, refresh):
            seen.append(refresh.clone() if isinstance(refresh, torch.Tensor)
                        else refresh)
            return cached.call(x, t, c, feats, refresh)

        rec = CachedNetwork(call=call, init=cached.init)
        return (Denoiser(net, TS, prediction="x0"),
                Denoiser(net, TS, prediction="x0", guidance=True,
                         cond_rank=1, cached=rec))

    den_u, den_g = denoisers(params, 0.0)
    spec_u = S.SamplerSpec.from_nfe("sa", 8, schedule=TS, tau=0.0,
                                    combine="fused")
    spec_g = spec_u.replace(guidance=True)
    xT, noise, cond = inp["xT"], inp["noise"], inp["cond"]
    K = xT.shape[0]
    mesh = auto_cfg_mesh(device="cpu")
    kw = dict(noise=noise, cond=cond)
    s25 = torch.full((K,), 2.5)
    res["mesh"] = (tuple(mesh.mesh.shape), mesh.mesh_dim_names)
    res["sharded"] = S.Sampler(spec_g).sample_sharded(
        den_g, xT, mesh=mesh, cfg_axis="cfg", guidance_scale=s25, **kw)
    s1 = S.Sampler(spec_g).sample_sharded(
        den_g, xT, mesh=mesh, cfg_axis="cfg", guidance_scale=torch.ones(K),
        **kw)
    lo, hi = shard_of(mesh, "data", K)
    alone = S.sample_batched(S.build_plan(spec_u), den_u, xT[lo:hi],
                             noise=noise[lo:hi], cond=cond[lo:hi])
    res["s1_shard_bitwise"] = torch.equal(s1[lo:hi], alone)
    res["cfg_rank"] = dist.get_rank(mesh.get_group("cfg"))
    for name, fc in [("interval_2", 2), ("residual", ("residual", 0.05))]:
        plan = S.build_plan(spec_g.replace(feature_cache=fc))
        seen.clear()
        graph_gate.reset_fires()
        res[name] = {"sharded": S.sample_sharded(
            plan, den_g, xT, mesh=mesh, cfg_axis="cfg", guidance_scale=s25,
            **kw)}
        res[name]["refresh"] = list(seen)
        res[name]["fires"] = graph_gate.fires("cpu")
    res["stats"] = S.compile_cache_stats()
    # the same solve on one process with each branch its own backbone call
    # at this rank's lanes: the batch each call of sharded guidance has
    # (the one-call pair runs the backbone at four times that batch, and
    # the host's GEMMs may round the adaLN projection's M = 2 unlike M = 8)
    net = tame_networks(dit, params, lambda seq: 0.0)[0]

    def split(x, t, c):
        h = x.shape[0] // 2
        t0, t1 = (t[:h], t[h:]) if t.dim() else (t, t)
        return torch.cat([net(x[:h], t0, c[:h]), net(x[h:], t1, c[h:])])

    den_split = Denoiser(split, TS, prediction="x0", guidance=True,
                         cond_rank=1)
    res["split_bitwise"] = torch.equal(res["sharded"][lo:hi], S.sample_batched(
        S.build_plan(spec_g), den_split, xT[lo:hi], noise=noise[lo:hi],
        cond=cond[lo:hi], guidance_scale=s25[lo:hi]))
    # the solve's first evaluation (x_T at the plan's first time), before
    # the solve amplifies any difference
    t0 = torch.full((K,), float(S.build_plan(spec_g).ts[0]))
    first = den_g.evaluate(xT[lo:hi], t0[lo:hi], cond[lo:hi], s25[lo:hi],
                           cfg_group=mesh.get_group("cfg"))
    res["first_eval"] = {
        "sharded": first,
        "split": den_split.evaluate(xT[lo:hi], t0[lo:hi], cond[lo:hi],
                                    s25[lo:hi]),
        "one_call": den_g.evaluate(xT, t0, cond, s25)[lo:hi]}
    # the reference's tame weights and anchor, converted by the parent:
    # sharded against unsharded solves, each policy
    _, tame_g = denoisers(inp["params"], inp["mu"])
    res["tame"], res["tame_unsharded"] = {}, {}
    for name, fc in [("guided", None), ("interval_2", 2),
                     ("residual", ("residual", 0.05))]:
        plan = S.build_plan(spec_g.replace(feature_cache=fc))
        res["tame"][name] = S.sample_sharded(
            plan, tame_g, xT, mesh=mesh, cfg_axis="cfg", guidance_scale=s25,
            **kw)
        res["tame_unsharded"][name] = S.sample_batched(
            plan, tame_g, xT, guidance_scale=s25, **kw)
torch.save(res, os.path.join(d, f"out{rank}.pt"))
dist.destroy_process_group()
'''


def spawn(tmp_path, job: str, inputs: dict, world: int = 4) -> list:
    """Run ``job`` of CHILD on ``world`` gloo ranks (one process each, in
    a session of its own); every rank's result. The whole group is killed
    at the deadline."""
    return torch_ranks.spawn(tmp_path, CHILD, job, inputs, world,
                             DEADLINE_S)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def ref_noise(solve_keys, M, shape):
    """The reference's per-step draws of each request, [n, M, *shape]:
    ``split(key, M)`` and one f32 normal per step."""
    draw = jax.vmap(lambda sk: jax.vmap(
        lambda k: jax.random.normal(k, shape, jnp.float32))(
            jax.random.split(sk, M)))
    return np.array(draw(solve_keys))


def test_sharded_gmm_equals_batched_on_4_ranks(reference, tmp_path):
    """(a) The reference's ``test_sharded_equivalence_on_8_fake_devices`` at
    four gloo ranks, held against the reference's one-device solve."""
    jmodel = JGMM.default_2d().model_fn(JS, "data")
    jplan = jsamplers.build_plan(jsamplers.SamplerSpec(
        name="sa", schedule=JS, n_steps=6, tau=0.7))
    xT = jax.random.normal(jax.random.PRNGKey(0), (8,) + SHAPE)
    keys = jax.random.split(jax.random.PRNGKey(1), 8)
    ref = np.array(jsamplers.sample_batched(jplan, jmodel, xT, keys))
    noise = torch.from_numpy(ref_noise(keys, 6, SHAPE))
    ranks = spawn(tmp_path, "gmm", {"xT": torch.from_numpy(np.array(xT)),
                                    "noise": noise})
    for r, res in enumerate(ranks):
        assert res["auto_mesh"] == ((4, 1), ("data", "model"))
        assert res["auto_cfg_mesh"] == ((2, 2), ("cfg", "data"))
        for shape in [(4, 1), (2, 2)]:
            got = res[shape]
            assert got["bitwise"], (r, shape)
            assert torch.equal(got["out"], ranks[0][shape]["out"])
            gap = float((got["out"] - res["unsharded"]).abs().max())
            assert gap < 1e-6, (r, shape, gap)
            assert rel(got["out"], ref) < 1e-5, (r, shape)
        # lanes by data coordinate; the model axis replicates them
        assert ranks[r][(2, 2)]["shard"] == [(0, 4), (0, 4), (4, 8),
                                             (4, 8)][r]
        assert res["stats"]["eager_entries"] == 0


def test_sharded_engine_on_4_ranks(tmp_path):
    """(b) The engine on (data=4, model=1): 5 requests pad to 8 lanes, each
    result within 1e-6 of the unsharded engine's, on every rank."""
    ranks = spawn(tmp_path, "engine", {})
    for res in ranks:
        assert res["padded_slots"] == 3 and res["microbatches"] == 1
        assert sorted(res["sharded"]) == list(range(5))
        for r in range(5):
            gap = float((res["sharded"][r] - res["plain"][r]).abs().max())
            assert gap < 1e-6, (r, gap)
            assert torch.equal(res["sharded"][r], ranks[0]["sharded"][r])


def reference_cfg_dit():
    """The class-conditional tame DiT-S smoke of
    ``tests/test_torch_guidance.py`` (4 layers, ``denoiser_cond`` 4, f32,
    a random ``y_proj`` so cond and uncond differ) as the reference's
    network and cached companion per lane, with the port's parameters
    converted from the same tree and the mean anchor ``mu`` [16, 8]. The
    tame weights keep the solve contractive, so two implementations can
    agree on it."""
    jmodel, jparams, mu, _, tparams = guidance_dit_pair(4, n_layers=4)

    def lane(x, c):
        one = x.ndim == 2
        if c is not None and one and c.ndim == 1:
            c = c[None]
        return one, (x[None] if one else x), c

    def net(x, t, c):
        one, h, c = lane(x, c)
        x0 = jmodel.denoise(jparams, h, t, c)
        return (x0[0] if one else x0) + mu(x.shape[-2])

    def call(x, t, c, feats, refresh):
        one, h, c = lane(x, c)
        x0, new = jmodel.denoise_cached(
            jparams, h, t, c, feats=feats[None] if one else feats,
            refresh=refresh)
        x0, new = (x0[0], new[0]) if one else (x0, new)
        return x0 + mu(x.shape[-2]), new

    def init(x):
        one = x.ndim == 2
        aval = jmodel.feature_shape(1 if one else x.shape[0], x.shape[-2])
        f = jnp.zeros(aval.shape, aval.dtype)
        return f[0] if one else f

    return (net, JCachedNetwork(call=call, init=init), tparams,
            torch.from_numpy(np.array(mu(16))))


def _cfg_ranks(tmp_path):
    """(every rank's result of the cfg job, the reference's guided and
    interval-2 solves) on the test's inputs."""
    jnet, jcached, tparams, mu = reference_cfg_dit()
    K, M = 4, 7
    rng = np.random.default_rng(5)
    xT = rng.standard_normal((K, 16, 8)).astype(np.float32)
    cond = np.eye(K, 4, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(6), K)
    jden = JDenoiser(jnet, JS, prediction="x0", guidance=True,
                     cached=jcached)
    refs = {}
    for name, fc in [("guided", None), ("interval_2", 2)]:
        spec = jsamplers.SamplerSpec.from_nfe(
            "sa", 8, schedule=JS, tau=0.0, combine="fused", guidance=True,
            feature_cache=fc)
        assert spec.n_steps == M
        refs[name] = np.asarray(jsamplers.sample_batched(
            jsamplers.build_plan(spec), jden, jnp.asarray(xT), keys,
            cond=jnp.asarray(cond), guidance_scale=jnp.full((K,), 2.5)))
    ranks = spawn(tmp_path, "cfg", {
        "xT": torch.from_numpy(xT), "cond": torch.from_numpy(cond),
        "noise": torch.from_numpy(ref_noise(keys, M, (16, 8))),
        "params": tparams, "mu": mu})
    return ranks, refs


def test_sharded_cfg_on_4_ranks(reference, tmp_path):
    """(c) Sharded CFG on (cfg=2, data=2) over a DiT-S smoke. On the
    reference's tame weights: the guided solve at 2.5 and its interval-2
    feature-cached twin against the reference's one-device guided
    ``sample_batched`` fed its own draws, and the guided, interval-2 and
    residual solves against the port's own one-device solves. On nudged
    random weights (whose backbone turns a last-bit change of one GEMM
    into 5e-5 of an evaluation, and whose solve turns that into an O(1)
    change, so only a solve that runs the same calls is a fit oracle):
    the solve's first evaluation and the whole solve bit for bit against
    one process that calls the backbone on each branch at the rank's
    lanes, scale 1 against the unguided shard, and the refresh alike on
    both cfg ranks."""
    ranks, refs = _cfg_ranks(tmp_path)
    for res in ranks:
        assert res["mesh"] == ((2, 2), ("cfg", "data"))
        for name in ("guided", "interval_2"):
            assert rel(res["tame"][name], refs[name]) < 1e-5, name
        for name in ("guided", "interval_2", "residual"):
            assert rel(res["tame"][name], res["tame_unsharded"][name]) \
                < 1e-5, name
        first = res["first_eval"]
        assert torch.equal(first["sharded"], first["split"])
        assert rel(first["sharded"], first["one_call"]) < 1e-3
        assert res["split_bitwise"]
        assert torch.equal(res["sharded"], ranks[0]["sharded"])
        assert res["s1_shard_bitwise"]
        # the guided entry (its scale-1 call a hit) and the cached one
        # (interval and residual policies are plan data of one entry)
        assert res["stats"]["eager_entries"] == 2
    # the two cfg ranks of each data coordinate (ranks 0 and 2, 1 and 3)
    assert [res["cfg_rank"] for res in ranks] == [0, 0, 1, 1]
    for a, b in ((0, 2), (1, 3)):
        for name in ("interval_2", "residual"):
            fa, fb = ranks[a][name], ranks[b][name]
            assert len(fa["refresh"]) == len(fb["refresh"]) > 0
            for x, y in zip(fa["refresh"], fb["refresh"]):
                assert type(x) is type(y)
                assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                        else x == y)
            assert fa["fires"] == fb["fires"]
    assert ranks[0]["residual"]["fires"] > 0
    assert all(isinstance(f, bool) for f in ranks[0]["interval_2"]["refresh"])


def _batch_rounding() -> dict:
    """On this host, one process: the cfg job's nudged DiT-S backbone on
    rows of a batch of 2 against the same rows of a batch of 4 (relative
    norm, per half), and a [M, 64] x [64, 384] GEMM's first two rows at
    M = 2 against M = 4 (max abs)."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.models.tame import tame_networks
    cfg = dataclasses.replace(get_smoke("dit-s"), n_layers=4,
                              denoiser_cond=4, dtype=torch.float32)
    dit = TransformerLM(cfg)
    g = torch.Generator().manual_seed(0)
    params = init_params(g, dit.param_defs(), torch.float32, "cpu")
    params = torch.utils._pytree.tree_map(
        lambda p: p + 0.02 * torch.randn(p.shape, generator=g), params)
    net = tame_networks(dit, params, lambda seq: 0.0)[0]
    xT = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 16, 8)).astype(np.float32))
    cond, t = torch.eye(4, 4), torch.tensor(0.999)
    whole = net(xT, t, cond)
    out = {f"backbone rows {lo}:{lo + 2}, batch 2 vs 4": rel(
        net(xT[lo:lo + 2], t, cond[lo:lo + 2]), whole[lo:lo + 2])
        for lo in (0, 2)}
    a, w = torch.randn(4, 64, generator=g), torch.randn(64, 384, generator=g)
    out["gemm [M, 64] x [64, 384], M 2 vs 4"] = float(
        (a[:2] @ w - (a @ w)[:2]).abs().max())
    return out


if __name__ == "__main__":
    # the numbers behind the cfg test's oracle (ROADMAP C7):
    #   PYTHONPATH=src python tests/test_torch_sharding.py
    import tempfile
    from pathlib import Path
    for k, v in _batch_rounding().items():
        print(f"{k}: {v:.3g}")
    ranks, refs = _cfg_ranks(Path(tempfile.mkdtemp()))
    for r, res in enumerate(ranks):
        first = res["first_eval"]
        print(f"rank {r}: first evaluation, sharded vs the one-call pair "
              f"{rel(first['sharded'], first['one_call']):.3g}; tame, "
              "sharded vs unsharded " + ", ".join(
                  f"{n} {rel(res['tame'][n], res['tame_unsharded'][n]):.3g}"
                  for n in ("guided", "interval_2", "residual")))
