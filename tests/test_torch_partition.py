"""The port's partition specs, ZeRO-1 specs and gradient compression
against the reference, in one process.

- ``specs_for`` (``resolve_spec`` over the reference's ``STRATEGIES``) on
  every arch's smoke and full ``param_defs``, under every strategy, on the
  production meshes (2, 2), (16, 16) and (2, 16, 16) given as shape
  dicts: equal to the reference's specs, leaf by leaf. ``zero1_specs`` on
  the same input equal to the reference's.
- ``placements_for``: a dim over ("pod", "data") is ``Shard`` on both mesh
  dims, pod first; ``batch_spec`` as the reference's.
- The activation pins are the identity on plain tensors, inside
  ``activation_sharding`` too: with no mesh every path is what it was.
- ``quantize_int8``'s round trip and error feedback, ported from
  ``tests/test_parallel.py``; the grad transform bitwise the reference's
  over 5 steps of the same gradients.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import models as j_models
from repro import optim as j_optim
from repro.models import common as jc
from repro.parallel import compression as jcomp
from repro_torch import configs as t_configs
from repro_torch import models as t_models
from repro_torch import optim as t_optim
from repro_torch.models import common as tc
from repro_torch.parallel import compression as tcomp

ARCHS = t_configs.ARCHS
MESHES = ({"data": 2, "model": 2}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16})


def _defs(mod, arch: str, smoke: bool):
    cfg = mod.configs.get_smoke(arch) if smoke else mod.configs.get_config(
        arch)
    return mod.models.build_model(cfg).param_defs()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tree}


def _jspec(p) -> tuple:
    return tuple(p)


J = types.SimpleNamespace(configs=j_configs, models=j_models)
T = types.SimpleNamespace(configs=t_configs, models=t_models)


def test_strategies_are_the_reference_table():
    assert tc.STRATEGIES == jc.STRATEGIES


@pytest.mark.parametrize("strategy", sorted(jc.STRATEGIES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_for_matches_the_reference(arch, smoke, strategy):
    jdefs, tdefs = _defs(J, arch, smoke), _defs(T, arch, smoke)
    jflat = _flat(jdefs)
    tflat = _flat(tdefs)
    assert jflat.keys() == tflat.keys()
    for mesh in MESHES:
        jspecs = _flat(jc.specs_for(jdefs, strategy,
                                    types.SimpleNamespace(shape=mesh)))
        tspecs = _flat(tc.specs_for(tdefs, strategy, mesh))
        for k, js in jspecs.items():
            assert isinstance(tspecs[k], tc.PartitionSpec)
            assert tuple(tspecs[k]) == _jspec(js), (k, mesh)


@pytest.mark.parametrize("strategy", ["fsdp_tp", "tp", "serve_2d"])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_the_reference(arch, strategy):
    mesh = {"data": 16, "model": 16}
    jdefs, tdefs = _defs(J, arch, False), _defs(T, arch, False)
    jspecs = jc.specs_for(jdefs, strategy, types.SimpleNamespace(shape=mesh))
    tspecs = tc.specs_for(tdefs, strategy, mesh)
    jshapes = jc.tree_defs_map(lambda d: d.shape, jdefs)
    tshapes = tc.tree_defs_map(lambda d: d.shape, tdefs)
    jz = _flat(j_optim.zero1_specs(jspecs, types.SimpleNamespace(
        shape=mesh))(jshapes))
    tz = _flat(t_optim.zero1_specs(tspecs, mesh)(tshapes))
    assert jz.keys() == tz.keys()
    for k, js in jz.items():
        assert tuple(tz[k]) == _jspec(js), k
    # a one-rank axis keeps every spec
    one = t_optim.zero1_specs(tspecs, {"data": 1, "model": 16})(tshapes)
    assert _flat(one) == _flat(tspecs)


@pytest.mark.parametrize("axes,rules,mesh,shape", [
    (("experts", "embed"), {"experts": ("data", "model")},
     {"data": 16, "model": 16}, (256, 64)),   # both axes
    (("experts", "embed"), {"experts": ("data", "model")},
     {"data": 16, "model": 16}, (16, 64)),    # falls back to one
    (("embed", "mlp"), {"embed": ("pod", "data"), "mlp": "data"},
     {"pod": 2, "data": 16}, (64, 32)),       # data consumed once
    (("embed", "mlp"), {"embed": ("pod", "data"), "mlp": "model"},
     {"pod": 2, "data": 16, "model": 16}, (24, 32)),  # 24 % 32: pod only
    (("vocab", None), {"vocab": "model"}, {"model": 16}, (100, 8)),
    (("vocab", None), {"vocab": "model"}, {"model": 16}, None),
])
def test_resolve_spec_rules(axes, rules, mesh, shape):
    want = jc.resolve_spec(axes, rules, mesh, shape)
    assert tuple(tc.resolve_spec(axes, rules, mesh, shape)) == tuple(want)


@pytest.mark.parametrize("axes", [("data",), ("pod", "data", "model"),
                                  ("model",), ("data", "model")])
def test_batch_spec(axes):
    assert tuple(tc.batch_spec(axes, None)) == tuple(jc.batch_spec(axes,
                                                                    None))


def test_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    P = tc.PartitionSpec
    assert tc.placements_for(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tc.placements_for(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    # an axis the mesh lacks is dropped (the ("data",) mesh of launch.train)
    data = types.SimpleNamespace(mesh_dim_names=("data",))
    assert tc.placements_for(P("model", ("pod", "data")), data) == (
        Shard(1),)
    with pytest.raises(ValueError, match="order"):
        tc.placements_for(P(("data", "pod")), mesh)


def test_activation_pins_leave_plain_tensors_alone():
    x = torch.randn(4, 8, 6, 5)
    logits = torch.randn(4, 8, 16)
    for ctx in (None, tc.activation_sharding(("data",), seq_axes=("model",),
                                             seq_divisor=2)):
        if ctx is not None:
            ctx.__enter__()
        try:
            assert tc.shard_batch_dim(x) is x
            assert tc.shard_heads_dim(x) is x
            assert tc.shard_moe_dispatch(x) is x
            assert tc.shard_moe_dispatch(x, group_dim=1, expert_dim=0) is x
            h, lg = tc.shard_logits_path(x, logits)
            assert h is x and lg is logits
            assert tc.constrain(x, tc.PartitionSpec("data")) is x
            assert tc.replicated(x) is x and tc.replicated(x, 0) is x
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
    assert tc._BATCH_AXES is None and tc._SEQ_AXES is None


def test_quantize_roundtrip_error_bound():
    x = torch.linspace(-3, 3, 1000)
    q, s = tcomp.quantize_int8(x)
    assert q.dtype == torch.int8
    err = float(torch.max(torch.abs(tcomp.dequantize_int8(q, s) - x)))
    assert err <= float(s) * 0.5 + 1e-7
    jq, js = jcomp.quantize_int8(jnp.asarray(x.numpy()))
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert float(js) == float(s)


def test_error_feedback_converges_where_naive_quant_stalls():
    """EF-quantized gradient descent reaches the optimum of a quadratic."""
    w = {"w": torch.tensor([2.0, -1.5, 0.5, 3.0])}
    t = tcomp.make_compressed_grad_transform()
    st = t.init(w)
    for _ in range(400):
        g = {"w": w["w"].clone()}  # grad of 0.5 |w|^2
        gq, st = t.update(g, st, w)
        w = {"w": w["w"] - 0.1 * gq["w"]}
    assert float(torch.max(torch.abs(w["w"]))) < 1e-2


def test_grad_transform_is_bitwise_the_reference():
    """Five steps of the same gradients (numpy draws, a dict of three
    leaves of mixed scales) through both transforms: the compressed
    gradients and the float32 residuals equal bit for bit; disabled, it
    passes the gradients through with an empty state."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 32), "b": (17,), "c": (3, 5, 7)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    jt, tt = jcomp.make_compressed_grad_transform(), \
        tcomp.make_compressed_grad_transform()
    js = jt.init({k: jnp.asarray(v) for k, v in params.items()})
    ts = tt.init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in range(5):
        g = {k: (rng.normal(size=s) * 10.0 ** (i - 2)).astype(np.float32)
             for i, (k, s) in enumerate(shapes.items())}
        jg, js = jt.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        tg, ts = tt.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts)
        for k in shapes:
            assert np.array_equal(np.asarray(jg[k]), tg[k].numpy()), (step, k)
            assert np.array_equal(np.asarray(js[k]), ts[k].numpy()), (step, k)
    off = tcomp.make_compressed_grad_transform(enabled=False)
    g = {"a": torch.ones(3)}
    assert off.init(g) == () and off.update(g, ())[0] is g


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "dbrx-132b",
                                  "deepseek-v3-671b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_layer_stacks_are_gathered_a_layer_at_a_time(arch, remat):
    """``loss_and_grads`` with an ``unshard`` that records what it is
    given (and returns it): each leaf of a layer stack (``LAYER_STACKS``)
    is handed over one layer at a time, L times a pass (twice under
    ``remat="full"``: the backward makes it again), never whole; every
    other leaf at least once; the loss and gradients bitwise those of no
    ``unshard``."""
    import dataclasses

    from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
    from repro_torch.launch import train as t_train
    from repro_torch.tree import paths_and_leaves

    cfg = dataclasses.replace(t_configs.get_smoke(arch), remat=remat,
                              dtype=torch.float32)
    model = t_models.build_model(t_train.train_config(cfg))
    params = t_models.init_params(torch.Generator().manual_seed(0),
                                  model.param_defs(), torch.float32)
    task = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=16)
    batch = {k: torch.as_tensor(v)
             for k, v in synthetic_lm_batch(task, 2, 0).items()}
    seen = []

    def record(t):
        seen.append((t.data_ptr(), tuple(t.shape)))
        return t

    loss, grads = t_train.loss_and_grads(model, params, batch, record)
    want_loss, want_grads = t_train.loss_and_grads(model, params, batch)
    assert torch.equal(loss, want_loss)
    for (k, g), (_, w) in zip(paths_and_leaves(grads),
                              paths_and_leaves(want_grads)):
        assert torch.equal(g, w), k
    passes = 2 if remat == "full" else 1
    for path, leaf in paths_and_leaves(params):
        lo = leaf.data_ptr()
        hi = lo + leaf.numel() * leaf.element_size()
        shapes = [s for p, s in seen if lo <= p < hi]
        if path.split("/")[0] in tc.LAYER_STACKS:
            assert shapes == [tuple(leaf.shape[1:])] * (
                leaf.shape[0] * passes), path
        else:
            assert tuple(leaf.shape) in shapes, path
