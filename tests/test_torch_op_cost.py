"""The port's op counter (``repro_torch.launch.op_cost``) and the kernels'
cost formulas and abstract branch (``repro_torch.kernels.ops``), on the
CPU.

Held against the reference: the matmul FLOPs of one DiT-S smoke
evaluation and of one starcoder2-3b smoke train step equal the
reference's ``launch.hlo_cost.analyze_hlo(...).flops`` of the same call
(tolerance 2%, the gap printed). The kernels' ``cost`` reproduces
PERF.md section 6's figures. The per-device counts on a fake mesh run in
a subprocess of their own (a fake process group is process-wide).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv6_scan as wkv
from repro_torch.kernels import sa_fused, sa_update
from repro_torch.launch.op_cost import CountingFakeMode, OpCost, count_ops

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
#: the port's FLOPs against the reference's HLO count
FLOP_TOL = 0.02


# ---------------------------------------------------------------- formulas
@pytest.mark.parametrize("name,got,want", [
    ("sa_update P3 n32768 f32 bytes", lambda: sa_update.cost(32768, 3, 4)[1],
     786_452),
    ("sa_fused P3 n32768 f32 bytes", lambda: sa_fused.cost(32768, 3, 4)[1],
     917_544),
    ("flash (8, 16, 256, 72) GFLOP",
     lambda: round(flash.cost(8, 16, 16, 256, 256, 72, False, 4)[0] / 1e9, 3),
     2.416),
    ("WKV (8, 256, 40, 64) C64 G operations",
     lambda: round(wkv.cost(8, 256, 40, 64, 64)[0] / 1e9, 2), 2.58),
    ("flash LM causal GFLOP",
     lambda: round(flash.cost(8, 24, 2, 512, 512, 128, True, 4)[0] / 1e9, 1),
     12.9),
])
def test_kernel_costs_reproduce_the_perf_figures(name, got, want):
    assert got() == want, name


def test_causal_flash_counts_the_scores_it_needs():
    """Query s sees keys 0..s: S (S + 1) / 2 scores a head at S == T."""
    full = flash.cost(1, 1, 1, 64, 64, 16, False, 4)[0]
    causal = flash.cost(1, 1, 1, 64, 64, 16, True, 4)[0]
    assert causal * 2 * 64 == full * 65


# ------------------------------------------------------ the abstract branch
def _fake_operands(device):
    with CountingFakeMode() as mode:
        x = torch.empty(2, 8, 4, device=device)
        buf = torch.empty(3, 2, 8, 4, device=device)
        c1 = torch.empty(5, device=device)
        c2 = torch.empty(2, 5, device=device)
        q = torch.empty(2, 4, 16, 8, device=device)
        kv = torch.empty(2, 2, 16, 8, device=device)
        r = torch.empty(2, 32, 3, 16, device=device)
        u = torch.empty(3, 16, device=device)
        s0 = torch.empty(2, 3, 16, 16, device=device)
        lane_buf = torch.empty(2, 3, 8, 4, device=device)
        lane_c = torch.empty(2, 2, 5, device=device)
    return mode, x, buf, c1, c2, q, kv, r, u, s0, lane_buf, lane_c


@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
@pytest.mark.parametrize("mode_arg", ["auto", "plain"])
def test_fake_tensors_never_reach_a_plain_version_or_a_launch(
        monkeypatch, device, mode_arg):
    def refuse(*a, **k):
        raise AssertionError("a fake tensor reached a plain version or a "
                             "kernel launch")
    for mod, names in ((sa_update, ("sa_update", "sa_update_plain",
                                    "sa_update_lanes",
                                    "sa_update_lanes_plain")),
                       (sa_fused, ("sa_fused_update", "sa_fused_update_plain",
                                   "sa_fused_update_lanes",
                                   "sa_fused_update_lanes_plain")),
                       (flash, ("flash_attention", "flash_attention_plain")),
                       (wkv, ("rwkv6_wkv", "rwkv6_wkv_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, refuse)
    mode, x, buf, c1, c2, q, kv, r, u, s0, lane_buf, lane_c = \
        _fake_operands(device)
    launches = ops.launch_counts()
    with mode, mode.counting() as cost:
        out = ops.sa_update(x, buf, x, c1, mode=mode_arg)
        p, c = ops.sa_fused_update(x, buf, x, c2, mode=mode_arg)
        lane = ops.sa_fused_update_lanes(x, lane_buf, x, lane_c,
                                         mode=mode_arg)
        o = ops.flash_attention(q, kv, kv, causal=True, mode=mode_arg)
        y, st = ops.wkv(r, r, r, r, u, s0, chunk=16, mode=mode_arg)
    assert tuple(out.shape) == (2, 8, 4) and tuple(p.shape) == (2, 8, 4)
    assert tuple(c.shape) == (2, 8, 4) and tuple(lane[0].shape) == (2, 8, 4)
    assert tuple(o.shape) == tuple(q.shape) and o.dtype == q.dtype
    assert tuple(y.shape) == (2, 32, 3, 16) and y.dtype == torch.float32
    assert tuple(st.shape) == (2, 3, 16, 16)
    assert ops.launch_counts() == launches
    # each call charged its own formula
    assert cost.kernels["sa_update"]["flops"] == sa_update.cost(64, 3, 4)[0]
    assert cost.kernels["sa_fused"]["calls"] == 2
    assert cost.kernels["flash_attention"]["flops"] == flash.cost(
        2, 4, 2, 16, 16, 8, True, 4)[0]
    assert cost.kernels["rwkv6_wkv"]["bytes"] == wkv.cost(
        2, 32, 3, 16, 16)[1]
    assert cost.flops == sum(k["flops"] for k in cost.kernels.values())


def test_a_real_cpu_tensor_still_takes_the_plain_version(monkeypatch):
    calls = []
    plain = flash.flash_attention_plain
    monkeypatch.setattr(flash, "flash_attention_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(flash, "flash_attention", lambda *a, **k: 1 / 0)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 16, generator=g)
    out = ops.flash_attention(q, q, q, causal=False)
    assert calls == [1] and torch.isfinite(out).all()


# ------------------------------------------------------------------ counts
def test_a_python_loop_counts_once_per_iteration():
    a = torch.randn(16, 32)
    b = torch.randn(32, 8)

    def run(n):
        with count_ops() as m:
            for _ in range(n):
                torch.tanh(a @ b)
        return m.cost
    one, ten = run(1), run(10)
    assert one.flops == 2 * 16 * 32 * 8
    assert ten.flops == 10 * one.flops
    assert ten.bytes == 10 * one.bytes
    assert ten.transcendentals == 10 * 16 * 8


def test_a_ring_history_row_write_charges_one_row():
    """A row written into a [P, N] history costs the row read and the
    row written, not the buffer (the reference's dynamic-update-slice
    rule)."""
    P, N = 4, 4096
    with CountingFakeMode() as mode:
        buf = torch.zeros(P, N)
        row = torch.empty(N)
        with mode.counting() as cost:
            buf[2] = row
            buf[1].copy_(row)
            buf.index_copy_(0, torch.tensor([3]), row[None])
    one_row = N * 4
    assert cost.bytes == 2 * one_row + 2 * one_row + (2 * one_row + 8)


def test_views_and_allocations_move_nothing():
    x = torch.randn(8, 8)
    with count_ops() as m:
        x.view(64)
        x.transpose(0, 1)
        torch.empty(1000)
    assert m.cost.bytes == 0 and m.cost.ops == 0


def test_fake_peak_equals_the_tracked_peak_of_real_tensors():
    """The peak of live storages of one smoke train step counted on fake
    tensors is the same count on real CPU tensors (one code path)."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import build_model, init_params
    from repro_torch.models.common import abstract_params
    cfg = dataclasses.replace(get_smoke("starcoder2-3b"), use_flash=False)
    model = build_model(cfg)
    batch = {"tokens": torch.zeros(2, 32, dtype=torch.int32),
             "labels": torch.zeros(2, 32, dtype=torch.int32)}
    params = init_params(torch.Generator().manual_seed(0),
                         model.param_defs())
    real = OpCost()
    real.track((params, batch))
    with count_ops(real):
        loss_and_grads(model, params, batch)
    with CountingFakeMode() as mode:
        fparams = abstract_params(model.param_defs(), torch.float32, "cpu")
        fbatch = {k: torch.zeros(2, 32, dtype=torch.int32) for k in batch}
        mode.cost.track((fparams, fbatch))
        with mode.counting() as fake:
            loss_and_grads(model, fparams, fbatch)
    assert fake.flops == real.flops
    # a fake run makes its scalar constants without copying them from the
    # host (one 8-byte op fewer); within 0.1% of the real run's peak
    assert real.peak_bytes > 0
    assert abs(fake.peak_bytes / real.peak_bytes - 1) <= 1e-3


def test_region_bytes_sum_to_bytes_and_a_solve_reads_its_backbone():
    from repro_torch.configs import get_smoke
    from repro_torch.core import Denoiser, get_schedule, make_sampler
    from repro_torch.models import build_model, init_params
    cfg = get_smoke("dit-s")
    model = build_model(cfg)
    params = init_params(torch.Generator().manual_seed(0),
                         model.param_defs())
    den = Denoiser(lambda x, t, c: model.denoise(params, x, t),
                   get_schedule("vp_linear"), prediction="x0")
    s = make_sampler("sa", nfe=6, predictor_order=2, corrector_order=2,
                     combine="fused", schedule=get_schedule("vp_linear"),
                     prediction="x0")
    x = torch.randn(2, 16, cfg.denoiser_latent,
                    generator=torch.Generator().manual_seed(1))
    from repro_torch.core import samplers
    with samplers.eager(), count_ops() as m:
        s.sample(den, x, torch.Generator().manual_seed(2))
    c = m.cost
    assert c.region_bytes["backbone"] + c.region_bytes["solver"] == c.bytes
    assert c.region_bytes["backbone"] > 0 and c.region_bytes["solver"] > 0
    assert 0.5 < c.region_bytes["backbone"] / c.bytes < 1


# ------------------------------------------- the reference's HLO FLOP count
def _reference_flops(fn, *args) -> float:
    import jax
    from repro.launch.hlo_cost import analyze_hlo
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def test_dit_s_evaluation_flops_match_the_reference_hlo():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke as ref_smoke
    from repro.models import build_model as ref_build
    from repro.models.common import init_params as ref_init
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model, init_params
    B, S = 2, 16
    rc = ref_smoke("dit-s")
    rm = ref_build(rc)
    rp = ref_init(jax.random.PRNGKey(0), rm.param_defs(), jnp.float32)
    want = _reference_flops(lambda p, z, t: rm.denoise(p, z, t), rp,
                            jnp.zeros((B, S, rc.denoiser_latent)),
                            jnp.float32(0.5))
    cfg = get_smoke("dit-s")
    model = build_model(cfg)
    params = init_params(torch.Generator().manual_seed(0),
                         model.param_defs())
    with torch.no_grad(), count_ops() as m:
        model.denoise(params, torch.zeros(B, S, cfg.denoiser_latent),
                      torch.tensor(0.5))
    gap = m.cost.flops / want - 1
    print(f"DiT-S evaluation: port {m.cost.flops:.0f} FLOPs, reference "
          f"{want:.0f}, gap {gap:+.2e}")
    assert abs(gap) <= FLOP_TOL


def test_starcoder2_smoke_train_step_flops_match_the_reference_hlo():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke as ref_smoke
    from repro.models import build_model as ref_build
    from repro.models.common import init_params as ref_init
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models import build_model, init_params
    B, S = 2, 32
    rm = ref_build(ref_smoke("starcoder2-3b"))
    rp = ref_init(jax.random.PRNGKey(0), rm.param_defs(), jnp.float32)
    rb = {"tokens": jnp.zeros((B, S), jnp.int32),
          "labels": jnp.zeros((B, S), jnp.int32)}
    want = _reference_flops(jax.value_and_grad(rm.loss_fn), rp, rb)
    model = build_model(dataclasses.replace(get_smoke("starcoder2-3b"),
                                            use_flash=False))
    params = init_params(torch.Generator().manual_seed(0),
                         model.param_defs())
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in rb.items()}
    with count_ops() as m:
        loss_and_grads(model, params, batch)
    gap = m.cost.flops / want - 1
    print(f"starcoder2-3b smoke train step: port {m.cost.flops:.0f} FLOPs, "
          f"reference {want:.0f}, gap {gap:+.2e}")
    assert abs(gap) <= FLOP_TOL


# --------------------------------------------------- counts on a fake mesh
_MESH_CHILD = r'''
import json, torch
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.op_cost import CountingFakeMode
from torch.distributed.tensor import DTensor, Replicate, Shard
init_fake_world(8)
mesh = make_test_mesh((2, 4), ("data", "model"), device="cpu")
M, K, N = 256, 512, 1024
out = {}
mode = CountingFakeMode()
with mode:
    # rows over data, columns over model: a local [M/2, K] @ [K, N/4]
    a = DTensor.from_local(torch.empty(M // 2, K), mesh,
                           [Shard(0), Replicate()], run_check=False)
    b = DTensor.from_local(torch.empty(K, N // 4), mesh,
                           [Replicate(), Shard(1)], run_check=False)
    with mode.counting() as c:
        y = a @ b
    out["matmul"] = {"flops": c.flops, "coll": c.coll_bytes,
                     "local": list(y.to_local().shape)}
    # the contraction over model: a partial [M/2, N] summed over 4 ranks
    a2 = DTensor.from_local(torch.empty(M // 2, K // 4), mesh,
                            [Shard(0), Shard(1)], run_check=False)
    b2 = DTensor.from_local(torch.empty(K // 4, N), mesh,
                            [Replicate(), Shard(0)], run_check=False)
    mode.cost = type(mode.cost)()
    with mode.counting() as c:
        z = (a2 @ b2).redistribute(mesh, [Shard(0), Replicate()])
    out["contraction"] = {"flops": c.flops, "coll": c.coll_bytes,
                          "by_group": len(c.coll_by_group)}
print("JSON" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def mesh_counts():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _MESH_CHILD], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


def test_a_sharded_matmul_counts_its_shard(mesh_counts):
    M, K, N = 256, 512, 1024
    got = mesh_counts["matmul"]
    assert got["local"] == [M // 2, N // 4]
    # the global count over the 8 shards, not the global matmul
    assert got["flops"] == 2 * M * K * N / 8
    assert got["coll"] == {}


def test_a_sharded_contraction_all_reduces_its_partial_result(mesh_counts):
    M, K, N = 256, 512, 1024
    got = mesh_counts["contraction"]
    assert got["flops"] == 2 * (M // 2) * (K // 4) * N
    # one all-reduce of the [M/2, N] float32 partial over the model axis
    assert got["coll"] == {"all-reduce": (M // 2) * N * 4}
    assert got["by_group"] == 1
