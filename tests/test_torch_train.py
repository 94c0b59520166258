"""Training the port's DiT denoiser against the JAX reference, at smoke
width in float32: the denoising loss and every parameter leaf's gradient
(autograd against ``jax.value_and_grad``), whole train steps through the
optimiser chain, the remat policies, the checkpointed ``TrainLoop``'s
resume after an injected failure, the kernels' refusal of autograd, and
``examples/torch_train_denoiser.py`` end to end on the CPU.

The noise times ``t`` and the noise ``eps`` are drawn with numpy and fed
to both packages; the reference's weights are carried across with
``params_from_jax``. Tolerances: 1e-5 relative per leaf (max |diff| over
max |reference|) for the loss, the gradients and the state after three
train steps, and in 2-norm for each leaf's change over them (float32,
other rounding orders); bitwise where both sides are the port (remat
policies, resume).
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.core import get_schedule as j_get_schedule
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import _dit_from_config, params_from_jax
from repro_torch.core import Denoiser, get_schedule, make_sampler
from repro_torch.data import ShardedBatchIterator, latent_batch
from repro_torch.kernels import flash_attention, rwkv6_scan, sa_fused, \
    sa_update
from repro_torch.models import TransformerLM
from repro_torch.models.common import init_params
from repro_torch.optim import (adamw, chain, clip_by_global_norm,
                               linear_warmup_cosine)
from repro_torch.runtime import InjectedFailure, TrainLoop
from repro_torch.tree import paths_and_leaves, tree_map

_EXAMPLE = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                        "torch_train_denoiser.py")


def _load_example():
    spec = importlib.util.spec_from_file_location("torch_train_denoiser",
                                                  _EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ex = _load_example()
B, S = 4, 16


def _pair(arch: str, n_layers: int = 2, qk_scale: float = 0.3):
    """The reference model and the port's, on the same float32 weights:
    the reference's init with every leaf nudged off zero (adaLN-zero would
    leave the blocks without a gradient), as numpy, and ``wq``/``wk``
    scaled by ``qk_scale``. At 0.3 the attention logits are of unit
    scale; at 1 (the reference's init: fan-in of a [d, H, hd] projection
    is H) their std is ~30, a saturated softmax whose float32 gradient
    both packages compute only to ~1e-4 of a float64 evaluation
    (``test_saturated_attention_gradients_are_as_close_as_the_references``)."""
    jcfg = dataclasses.replace(j_get_smoke(arch), n_layers=n_layers,
                               dtype=jnp.float32)
    jmodel = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      jmodel.param_defs(), jnp.float32))
    rng = np.random.default_rng(1)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(
        np.shape(a))).astype(np.float32), jp)
    for k in ("wq", "wk"):
        jp["blocks"]["attn"][k] *= np.float32(qk_scale)
    model = TransformerLM(dataclasses.replace(
        get_smoke(arch), n_layers=n_layers, dtype=torch.float32,
        use_flash=False))
    return jmodel, jp, model, params_from_jax(jp, model)


def _draws(step: int, dz: int):
    """(x0, t, eps) of one step, numpy float32."""
    rng = np.random.default_rng(np.random.SeedSequence([5, step]))
    x0 = latent_batch(dz, S, B, step)["x0"]
    t = rng.uniform(1e-3, 1.0, B).astype(np.float32)
    eps = rng.standard_normal((B, S, dz)).astype(np.float32)
    return x0, t, eps


def _j_loss(jmodel, sched):
    def loss(params, x0, t, eps):
        a = sched.alpha_j(t)[:, None, None]
        s = sched.sigma_j(t)[:, None, None]
        pred = jmodel.denoise(params, a * x0 + s * eps, t)
        return jnp.mean((pred - x0) ** 2)
    return loss


def _port_value_and_grad(model, params, x0, t, eps):
    """The port's loss and gradient tree on numpy draws."""
    return ex.loss_and_grads(model, params, torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(eps),
                             get_schedule("vp_linear"))


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


@pytest.mark.parametrize("arch", ["dit-xl-2", "dit-s"])
def test_loss_and_gradients_match_the_reference(arch):
    jmodel, jp, model, params = _pair(arch)
    dz = model.cfg.denoiser_latent
    x0, t, eps = _draws(0, dz)
    j_loss, j_grads = jax.value_and_grad(
        _j_loss(jmodel, j_get_schedule("vp_linear")))(
        jax.tree.map(jnp.asarray, jp), x0, t, eps)
    loss, grads = _port_value_and_grad(model, params, x0, t, eps)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    rel = _rel_per_leaf(grads, j_grads)
    assert max(rel.values()) <= 1e-5, rel
    # every block leaf is trained (the unused LM embedding and head are not)
    zero = {k for k, g in paths_and_leaves(grads) if not bool(g.any())}
    assert zero == {"embed", "lm_head"}


@pytest.mark.parametrize("arch", ["dit-xl-2", "dit-s"])
def test_saturated_attention_gradients_are_as_close_as_the_references(arch):
    """At the reference's own init (attention logits of std ~30) float32
    gradients are ill-conditioned in both packages: per leaf, the port's
    distance to a float64 evaluation of the port is within 3x the
    reference's (plus 1e-7 of the leaf's scale)."""
    jmodel, jp, model, params = _pair(arch, qk_scale=1.0)
    dz = model.cfg.denoiser_latent
    x0, t, eps = _draws(0, dz)
    _, j_grads = jax.value_and_grad(
        _j_loss(jmodel, j_get_schedule("vp_linear")))(
        jax.tree.map(jnp.asarray, jp), x0, t, eps)
    _, grads = _port_value_and_grad(model, params, x0, t, eps)
    m64 = TransformerLM(dataclasses.replace(model.cfg, dtype=torch.float64))
    _, g64 = _port_value_and_grad(
        m64, tree_map(torch.Tensor.double, params), x0.astype(np.float64),
        t.astype(np.float64), eps.astype(np.float64))
    truth = tree_map(lambda g: g.numpy(), g64)
    port = _rel_per_leaf(grads, truth)
    ref = _rel_per_leaf(tree_map(lambda g: torch.from_numpy(np.asarray(
        g, np.float64)), j_grads), truth)
    assert all(port[k] <= 3 * ref[k] + 1e-7 for k in ref), (port, ref)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_bitwise_the_same_gradients(remat):
    _, _, plain, params = _pair("dit-xl-2")
    remat_model = TransformerLM(dataclasses.replace(plain.cfg, remat=remat))
    x0, t, eps = _draws(3, plain.cfg.denoiser_latent)
    loss0, g0 = _port_value_and_grad(plain, params, x0, t, eps)
    loss1, g1 = _port_value_and_grad(remat_model, params, x0, t, eps)
    assert torch.equal(loss0, loss1)
    for (k, a), (_, b) in zip(paths_and_leaves(g0), paths_and_leaves(g1)):
        assert torch.equal(a, b), k


def test_remat_is_the_references_and_refuses_other_values():
    assert get_config("dit-xl-2").remat == "full"
    assert _dit_from_config(j_get_config("dit-xl-2")).cfg.remat == "full"
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(dataclasses.replace(get_smoke("dit-s"), remat="some"))


def test_three_train_steps_match_the_reference():
    """Three steps of clip -> AdamW (warmup-cosine LR, weight decay) from
    the same weights and draws: the losses, the state after them and each
    leaf's change."""
    jmodel, jp, model, params = _pair("dit-xl-2")
    dz = model.cfg.denoiser_latent
    j_opt = j_optim.chain(j_optim.clip_by_global_norm(1.0), j_optim.adamw(
        j_optim.linear_warmup_cosine(2e-3, 2, 10), weight_decay=0.05))
    opt = chain(clip_by_global_norm(1.0), adamw(
        linear_warmup_cosine(2e-3, 2, 10), weight_decay=0.05))
    j_loss = _j_loss(jmodel, j_get_schedule("vp_linear"))

    @jax.jit
    def j_step(state, x0, t, eps):
        loss, grads = jax.value_and_grad(j_loss)(state["params"], x0, t, eps)
        upd, o = j_opt.update(grads, state["opt"], state["params"],
                              state["step"])
        return ({"params": j_optim.apply_updates(state["params"], upd),
                 "opt": o, "step": state["step"] + 1}, loss)

    j0 = jax.tree.map(jnp.asarray, jp)
    j_state = {"params": j0, "opt": j_opt.init(j0),
               "step": jnp.zeros((), jnp.int32)}

    def draw(step, x0):
        _, t, eps = _draws(step, dz)
        return torch.from_numpy(t), torch.from_numpy(eps)

    step_fn = ex.make_train_step(model, opt, get_schedule("vp_linear"), draw)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    for k in range(3):
        x0, t, eps = _draws(k, dz)
        j_state, j_l = j_step(j_state, x0, t, eps)
        state, m = step_fn(state, {"x0": torch.from_numpy(x0)})
        assert abs(float(m["loss"]) - float(j_l)) <= 1e-5 * float(j_l)
    assert int(state["step"]) == 3
    for part in ("params", "opt"):
        rel = _rel_per_leaf(state[part], j_state[part])
        assert max(rel.values()) <= 1e-5, (part, rel)
    # each leaf's change in 2-norm: AdamW normalises every element, so an
    # element of near-zero gradient moves by O(lr) with a sign the
    # rounding picks, and the change's max-abs error is no measure
    got = dict(paths_and_leaves(state["params"]))
    for k, p0 in paths_and_leaves(jp):
        ref = np.asarray(dict(paths_and_leaves(j_state["params"]))[k]) - p0
        err = np.linalg.norm(got[k].numpy() - p0 - ref)
        assert err <= 1e-5 * np.linalg.norm(ref), k


def test_trainloop_resumes_bitwise_after_an_injected_failure(tmp_path):
    """Killed at step 6 of 10 (after the step-5 checkpoint) and resumed:
    the metric stream and the final state are an uninterrupted run's, bit
    for bit (the async saver, the data position and the per-step draws
    seeded by (42, step) all resume)."""
    model = TransformerLM(dataclasses.replace(
        get_smoke("dit-xl-2"), n_layers=2, dtype=torch.float32,
        use_flash=False, remat="full"))
    dz = model.cfg.denoiser_latent
    opt = chain(clip_by_global_norm(1.0),
                adamw(linear_warmup_cosine(2e-3, 2, 10), weight_decay=0.0))
    step_fn = ex.make_train_step(model, opt, get_schedule("vp_linear"),
                                 ex.seeded_draw)

    def init_state():
        p = init_params(torch.Generator().manual_seed(0), model.param_defs())
        return {"params": p, "opt": opt.init(p),
                "step": torch.zeros((), dtype=torch.int32)}

    def batches():
        return ShardedBatchIterator(
            lambda rows, step, host: latent_batch(dz, S, rows, step, host), B)

    def loop(d):
        return TrainLoop(step_fn, init_state, str(d), save_every=5)

    ref_state, ref_hist = loop(tmp_path / "a").run(batches(), 10, log=None)
    with pytest.raises(InjectedFailure):
        loop(tmp_path / "b").run(batches(), 10, fail_at=6, log=None)
    state, hist = loop(tmp_path / "b").run(batches(), 10, log=None)
    assert hist == ref_hist[5:]
    assert ref_hist[-1]["loss"] < ref_hist[0]["loss"]
    for (k, a), (_, b) in zip(paths_and_leaves(state),
                              paths_and_leaves(ref_state)):
        assert torch.equal(a, b), k


def _kernel_calls():
    """Each kernel wrapper on small CPU operands, its first input
    requiring grad."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=g)
    q, k, v = r(1, 2, 8, 16).requires_grad_(), r(1, 2, 8, 16), r(1, 2, 8, 16)
    x = r(2, 32).requires_grad_()
    buf, xi = r(3, 2, 32), r(2, 32)
    xl, bufl, xil = r(2, 32).requires_grad_(), r(2, 3, 32), r(2, 32)
    wr = r(1, 64, 2, 64).requires_grad_()
    return {
        "flash_attention": lambda: flash_attention.flash_attention(q, k, v),
        "sa_update": lambda: sa_update.sa_update(x, buf, xi, r(5)),
        "sa_update_lanes": lambda: sa_update.sa_update_lanes(
            xl, bufl, xil, r(2, 5)),
        "sa_fused_update": lambda: sa_fused.sa_fused_update(
            x, buf, xi, r(2, 5)),
        "sa_fused_update_lanes": lambda: sa_fused.sa_fused_update_lanes(
            xl, bufl, xil, r(2, 2, 5)),
        "rwkv6_wkv": lambda: rwkv6_scan.rwkv6_wkv(
            wr, r(1, 64, 2, 64), r(1, 64, 2, 64), -r(1, 64, 2, 64).abs(),
            r(2, 64), r(1, 2, 64, 64)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    """Under grad mode an input that requires grad is refused before any
    other check (a launch would cut the output off the graph); without
    grad mode the same call reaches the wrapper's device check."""
    call = _kernel_calls()[name]
    with pytest.raises(RuntimeError, match="no backward.*use_flash=False"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()


def test_sampling_runs_outside_autograd():
    """Parameters that require grad (a model mid-training) sample as
    detached ones: the entry points run under ``torch.no_grad()``, so on
    the card the kernels see no input that requires grad."""
    _, _, model, params = _pair("dit-xl-2")
    params = tree_map(lambda p: p.requires_grad_(), params)
    s = make_sampler("sa", nfe=6, combine="fused", prediction="x0",
                     schedule=get_schedule("vp_linear"))
    den = Denoiser(lambda x, t, c: model.denoise(params, x, t),
                   get_schedule("vp_linear"), prediction="x0")
    g = torch.Generator().manual_seed(0)
    x = s.init_noise(g, (2, S, model.cfg.denoiser_latent))
    out = s.sample(den, x, g)
    lanes = s.sample_batched(den, x, [g, g])
    assert not out.requires_grad and not lanes.requires_grad
    assert bool(torch.isfinite(out).all())


def test_example_runs_end_to_end_on_the_cpu(tmp_path):
    out = ex.main(["--device", "cpu", "--steps", "4", "--ckpt",
                   str(tmp_path / "ckpt"), "--samples", "32"])
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert set(out["sliced_w2"]) == {"tau=0.0,nfe=10", "tau=0.4,nfe=10",
                                     "tau=0.0,nfe=30", "tau=1.0,nfe=30"}
    assert all(np.isfinite(list(out["sliced_w2"].values())))
    assert os.listdir(tmp_path / "ckpt") == ["step_00000004"]
