"""The port's dry run (``repro_torch.launch.cells``, ``launch.dryrun``)
against the reference's (``repro.launch.cells``, ``launch.dryrun``), on the
CPU.

Held against the reference: the shape cells and every arch's meta; the
specs of the parameters, the optimiser state (AdamW and adafactor), the
caches and the inputs that ``build_cell`` places on a (2, 4) and a
(2, 2, 2) mesh, against the reference's ``NamedSharding.spec`` s (the
reference on 8 forced host devices, the port on a fake group of 8 ranks,
each in a subprocess of its own: both are process-wide). The cells the
reference lowers in ``tests/test_dryrun_cells.py``, dit-xl-2's sample
cell and a multi-pod cell run through ``run_cell`` on fake meshes: at
smoke width here, at full width under ``slow``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

#: (arch, shape) whose specs are compared: AdamW and adafactor training,
#: GQA / MQA / MLA / RWKV / Zamba2 caches, the embeddings and M-RoPE
#: inputs, the sample cell
SPEC_CELLS = [
    ("starcoder2-3b", "train_4k"), ("deepseek-v3-671b", "train_4k"),
    ("qwen2-vl-2b", "train_4k"), ("musicgen-large", "prefill_32k"),
    ("granite-34b", "decode_32k"), ("gemma-7b", "decode_32k"),
    ("deepseek-v3-671b", "decode_32k"), ("rwkv6-3b", "long_500k"),
    ("zamba2-7b", "decode_32k"), ("zamba2-7b", "long_500k"),
    ("dit-xl-2", "sample_256"),
]
MESHES = [(2, 4), (2, 2, 2)]

_NORM = r'''
def norm(spec):
    out = []
    for d in spec:
        if d is None:
            out.append(None)
        elif isinstance(d, str):
            out.append([d])
        else:
            out.append(list(d) if len(d) else None)
    while out and out[-1] is None:
        out.pop()
    return out
'''

_REF = _NORM + r'''
import json, jax
from jax.sharding import NamedSharding
from repro.launch.cells import build_cell
from repro.launch.mesh import make_test_mesh
CELLS, MESHES = json.loads(sys.argv[1]), json.loads(sys.argv[2])

def key(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))

out = {}
for arch, shape in CELLS:
    for ms in MESHES:
        mesh = make_test_mesh(tuple(ms), ("pod", "data", "model")[-len(ms):])
        cell = build_cell(arch, shape, mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            cell.in_shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        out[f"{arch}|{shape}|{ms}"] = {
            "/".join(key(k) for k in kp): norm(s.spec) for kp, s in flat}
print("JSON" + json.dumps(out))
'''

_PORT = _NORM + r'''
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.cells import build_cell
from repro_torch.launch.dryrun import init_fake_world
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.tree import paths_and_leaves
CELLS, MESHES = json.loads(sys.argv[1]), json.loads(sys.argv[2])
init_fake_world(8)
meshes = {tuple(ms): make_test_mesh(tuple(ms),
                                    ("pod", "data", "model")[-len(ms):],
                                    device="cpu") for ms in MESHES}
out = {}
with FakeTensorMode(allow_non_fake_inputs=True):
    for arch, shape in CELLS:
        for ms in MESHES:
            cell = build_cell(arch, shape, meshes[tuple(ms)], device="cpu")
            out[f"{arch}|{shape}|{ms}"] = {
                k: norm(s.spec)
                for k, s in paths_and_leaves(cell.in_shardings)}
print("JSON" + json.dumps(out))
'''


def _run(code: str, env_extra: dict, *args, timeout: int = 600) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               **env_extra)
    r = subprocess.run([sys.executable, "-c", "import sys\n" + code, *args],
                       env=env, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][-1]
    return json.loads(line[4:])


@pytest.fixture(scope="module")
def specs():
    args = (json.dumps(SPEC_CELLS), json.dumps(MESHES))
    ref = _run(_REF, {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
                      "JAX_PLATFORMS": "cpu"}, *args)
    port = _run(_PORT, {}, *args)
    return ref, port


def test_shapes_and_metas_equal_the_reference():
    import dataclasses
    from repro import configs as ref
    from repro_torch import configs as port
    assert {k: dataclasses.asdict(v) for k, v in port.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}
    assert port.ARCHS == ref.ARCHS
    for arch in ref.ARCHS:
        assert dataclasses.asdict(port.get_meta(arch)) == \
            dataclasses.asdict(ref.get_meta(arch)), arch


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_cell_specs_equal_the_reference(specs, arch, shape, mesh):
    ref, port = specs
    key = f"{arch}|{shape}|{list(mesh)}"
    want, got = ref[key], port[key]
    assert set(got) == set(want), (sorted(set(got) ^ set(want)))[:10]
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, dict(list(bad.items())[:10])


# ------------------------------------------------------------ run_cell
#: (arch, shape, mesh): the reference's three lowered cells, the sample
#: cell, a multi-pod cell
RUN_CELLS = [("starcoder2-3b", "train_4k", (2, 4)),
             ("rwkv6-3b", "long_500k", (2, 4)),
             ("deepseek-v3-671b", "decode_32k", (2, 4)),
             ("dit-xl-2", "sample_256", (2, 4)),
             ("starcoder2-3b", "decode_32k", (2, 2, 2))]

_CELLS_CHILD = r'''
import json, sys
from repro_torch.launch.dryrun import init_fake_world, run_cell
cells, smoke = json.loads(sys.argv[1]), sys.argv[2] == "1"
init_fake_world(8)
out = {}
for arch, shape, ms in cells:
    out[f"{arch}|{shape}"] = run_cell(arch, shape, multi_pod=len(ms) == 3,
                                      strategy=None, mesh_shape=tuple(ms),
                                      smoke=smoke, verbose=False)
print("JSON" + json.dumps(out))
'''


def _check_record(arch, shape, rec, smoke: bool):
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    c = rec["cost"]
    assert c["flops_per_device"] > 0 and c["bytes_per_device"] > 0
    assert sum(c["region_bytes"].values()) == pytest.approx(
        c["bytes_per_device"])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    if shape.startswith("sample"):
        # pure DP: no collective; 19 fused combines and 20 evaluations of
        # every layer through flash
        from repro_torch.configs import get_config, get_smoke
        layers = (get_smoke if smoke else get_config)(arch).n_layers
        assert rec["collectives"] == {}
        assert c["kernels"]["sa_fused"]["calls"] == 19
        assert c["kernels"]["flash_attention"]["calls"] == 20 * layers
        assert c["region_bytes"]["backbone"] > 0
    else:
        assert rec["collective_bytes_per_device"] > 0
    if arch == "rwkv6-3b" and shape == "long_500k":
        assert "rwkv6_wkv" not in c["kernels"]  # decode: the recurrence


@pytest.fixture(scope="module")
def smoke_cells():
    return _run(_CELLS_CHILD, {}, json.dumps(RUN_CELLS), "1")


@pytest.mark.parametrize("arch,shape,mesh", RUN_CELLS)
def test_smoke_cells_run_on_fake_meshes(smoke_cells, arch, shape, mesh):
    _check_record(arch, shape, smoke_cells[f"{arch}|{shape}"], smoke=True)


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,mesh", RUN_CELLS)
def test_full_size_cells_run_on_fake_meshes(arch, shape, mesh):
    rec = _run(_CELLS_CHILD, {}, json.dumps([(arch, shape, mesh)]), "0",
               timeout=3000)[f"{arch}|{shape}"]
    _check_record(arch, shape, rec, smoke=False)


def test_cli_prints_a_cell_and_fails_loudly():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dit-s", "--shape", "sample_64"], env=env, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    for what in ("mesh=(16, 16)", "memory/device", "fits80GB=True",
                 "cost/device", "collectives: none", "roofline:",
                 "all cells ran"):
        assert what in r.stdout, (what, r.stdout)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "train_4k"], env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 1 and "!! FAIL no-such-arch x train_4k" in r.stdout
