"""The port's data / optim / checkpoint / runtime substrate: the reference's
``tests/test_substrate.py`` mirrored on ``repro_torch``, plus parity with
the reference on the same inputs.

Tolerances: the data pipelines and checkpoints bitwise, in both
directions; one optimiser update within 1e-6 relative (float32 step
arithmetic in both, with other rounding orders: XLA fuses, PyTorch rounds
after each op); the LR schedules within 1e-7 and one float32 ulp of
their unit-scale factor.
"""

import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro import data as j_data
from repro import optim as j_optim
from repro_torch import checkpoint as ckpt
from repro_torch.data import (ShardedBatchIterator, TokenTaskConfig,
                              latent_batch, pack_documents, synthetic_lm_batch)
from repro_torch.optim import (adafactor, adamw, apply_updates, chain,
                               clip_by_global_norm, cosine_schedule,
                               global_norm, linear_warmup_cosine)
from repro_torch.runtime import InjectedFailure, StragglerMonitor, TrainLoop
from repro_torch.tree import paths_and_leaves, tree_leaves, tree_map


# ---------------------------------------------------------------- data
def test_batches_deterministic_and_distinct():
    tc = TokenTaskConfig(vocab_size=101, seq_len=16)
    a = synthetic_lm_batch(tc, 4, step=3)
    b = synthetic_lm_batch(tc, 4, step=3)
    c = synthetic_lm_batch(tc, 4, step=4)
    assert np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].max() < 101
    # labels are next-token shifted
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


def test_copy_structure_is_learnable_signal():
    tc = TokenTaskConfig(vocab_size=101, seq_len=64, copy_period=8)
    b = synthetic_lm_batch(tc, 8, step=0)
    t = b["tokens"]
    assert np.array_equal(t[:, 8::16], t[:, 0:-8:16][:, : t[:, 8::16].shape[1]])


def test_pack_documents():
    toks, segs = pack_documents([np.arange(5), np.arange(7)], 4, pad_id=0)
    assert toks.shape == (3, 4)
    flat = toks.reshape(-1)[:12]
    assert np.array_equal(flat, np.concatenate([np.arange(5), np.arange(7)]))
    assert segs.max() == 2 and (segs == 0).sum() == 0  # 12 toks exactly fill


def test_sharded_iterator_resume():
    tc = TokenTaskConfig(vocab_size=31, seq_len=8)
    make = lambda rows, step, host: synthetic_lm_batch(tc, rows, step, host)
    it1 = ShardedBatchIterator(make, 4)
    seq1 = [next(it1)["tokens"] for _ in range(5)]
    it2 = ShardedBatchIterator(make, 4, start_step=3)
    seq2 = [next(it2)["tokens"] for _ in range(2)]
    assert torch.equal(seq1[3], seq2[0]) and torch.equal(seq1[4], seq2[1])
    assert seq1[0].dtype == torch.int32 and seq1[0].device.type == "cpu"


def test_sharded_iterator_takes_the_host_from_the_process_group(monkeypatch):
    """Rank 1 of a two-process group makes rows [2, 4) of each global
    batch of 4: host 1's rows."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    tc = TokenTaskConfig(vocab_size=31, seq_len=8)
    it = ShardedBatchIterator(
        lambda rows, step, host: synthetic_lm_batch(tc, rows, step, host), 4)
    assert (it.host, it.n_hosts) == (1, 2)
    got = next(it)["tokens"]
    assert np.array_equal(got.numpy(),
                          synthetic_lm_batch(tc, 2, 0, host=1)["tokens"])
    with pytest.raises(ValueError, match="divide"):
        ShardedBatchIterator(lambda *a: {}, 3)


def test_latent_batch_shape():
    b = latent_batch(8, 16, 4, step=0)
    assert b["x0"].shape == (4, 16, 8)


@pytest.mark.parametrize("step,host", [(0, 0), (5, 0), (3, 2)])
def test_data_bitwise_the_reference(step, host):
    tc = TokenTaskConfig(vocab_size=97, seq_len=24, copy_period=4)
    jtc = j_data.TokenTaskConfig(vocab_size=97, seq_len=24, copy_period=4)
    got = synthetic_lm_batch(tc, 3, step, host)
    ref = j_data.synthetic_lm_batch(jtc, 3, step, host)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    got_l = latent_batch(8, 16, 4, step, host)["x0"]
    ref_l = j_data.latent_batch(8, 16, 4, step, host)["x0"]
    assert got_l.dtype == ref_l.dtype
    assert got_l.tobytes() == ref_l.tobytes()
    docs = [np.arange(5 + step), np.arange(3) + 7, np.arange(11 + host)]
    for g, r in zip(pack_documents(docs, 4, pad_id=9),
                    j_data.pack_documents(docs, 4, pad_id=9)):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


# --------------------------------------------------------------- optim
def _grad_sq(w):
    """d/dp sum(p ** 2) of every leaf."""
    return tree_map(lambda p: 2.0 * p, w)


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([3.0, -2.0])}
    opt = chain(clip_by_global_norm(10.0), adamw(0.1, weight_decay=0.0))
    st = opt.init(w)
    for i in range(200):
        upd, st = opt.update(_grad_sq(w), st, w, torch.tensor(i))
        w = apply_updates(w, upd)
    assert float(torch.max(torch.abs(w["w"]))) < 1e-2


def test_adafactor_reduces_quadratic_matrix():
    w = {"w": torch.ones((8, 4)) * 2.0}
    # sign-SGD-like updates oscillate at the lr scale; decay it
    opt = adafactor(lambda s: 0.3 / (1.0 + 0.05 * s))
    st = opt.init(w)
    for i in range(300):
        upd, st = opt.update(_grad_sq(w), st, w, torch.tensor(i))
        w = apply_updates(w, upd)
    assert float(torch.max(torch.abs(w["w"]))) < 0.05
    # factored state, not full
    assert st["w"]["vr"].shape == (8,)
    assert st["w"]["vc"].shape == (4,)


def test_clipping():
    opt = clip_by_global_norm(1.0)
    g = {"a": torch.full((4,), 10.0)}
    out, _ = opt.update(g, (), None, None)
    assert float(global_norm(out)) == pytest.approx(1.0, rel=1e-5)


def test_schedules_shape():
    f = linear_warmup_cosine(1e-3, 10, 100)
    assert float(f(torch.tensor(0))) == 0.0
    assert float(f(torch.tensor(10))) == pytest.approx(1e-3, rel=1e-5)
    assert float(f(torch.tensor(100))) < 1e-3
    g = cosine_schedule(1.0, 100, final_frac=0.1)
    assert float(g(torch.tensor(100))) == pytest.approx(0.1, rel=1e-5)


def _np_tree(seed):
    """Params and grads, numpy float32: a matrix, a 3-D stack, a vector."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "blocks": {"k": (3, 4, 2), "b": (7,)}}

    def draw(scale):
        return {"w": (scale * rng.standard_normal(shapes["w"])).astype("f4"),
                "blocks": {k: (scale * rng.standard_normal(s)).astype("f4")
                           for k, s in shapes["blocks"].items()}}
    return draw(1.0), draw(3.0)


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, ref, rtol):
    """Leaf by leaf path (jax orders dict keys, the port keeps insertion
    order): max |got - ref| <= rtol max |ref|."""
    got = dict(paths_and_leaves(got))
    ref = dict(paths_and_leaves(jax.tree.map(np.asarray, ref)))
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k].float().numpy()
        r = r.astype(np.float32)
        assert g.shape == r.shape, k
        scale = max(float(np.max(np.abs(r))), 1e-30)
        assert float(np.max(np.abs(g - r))) <= rtol * scale, (k, g, r)


_OPTS = {
    "adamw": (lambda: adamw(1e-2, weight_decay=0.1),
              lambda: j_optim.adamw(1e-2, weight_decay=0.1)),
    "adamw_schedule": (
        lambda: adamw(linear_warmup_cosine(2e-3, 4, 20), weight_decay=0.0),
        lambda: j_optim.adamw(j_optim.linear_warmup_cosine(2e-3, 4, 20),
                              weight_decay=0.0)),
    "adafactor": (lambda: adafactor(1e-2, weight_decay=0.01),
                  lambda: j_optim.adafactor(1e-2, weight_decay=0.01)),
    "clip_then_adamw": (
        lambda: chain(clip_by_global_norm(1.0), adamw(1e-3)),
        lambda: j_optim.chain(j_optim.clip_by_global_norm(1.0),
                              j_optim.adamw(1e-3))),
}


@pytest.mark.parametrize("name", sorted(_OPTS))
@pytest.mark.parametrize("step", [0, 7])
def test_one_update_matches_the_reference(name, step):
    """One update from a nonzero state (the reference's own first update
    seeds it) on the same numpy params and grads, within 1e-6."""
    make, j_make = _OPTS[name]
    params, grads = _np_tree(step)
    _, grads0 = _np_tree(100 + step)
    jopt, opt = j_make(), make()
    jp = jax.tree.map(jnp.asarray, params)
    jst = jopt.init(jp)
    _, jst = jopt.update(jax.tree.map(jnp.asarray, grads0), jst, jp,
                         jnp.asarray(step))
    j_upd, j_new = jopt.update(jax.tree.map(jnp.asarray, grads), jst, jp,
                               jnp.asarray(step))
    # the port starts from the reference's state, carried as numpy
    st = _to_torch(jax.tree.map(np.asarray, jst))
    upd, new = opt.update(_to_torch(grads), st, _to_torch(params),
                          torch.tensor(step))
    _close(upd, j_upd, 1e-6)
    _close(new, j_new, 1e-6)
    _close(apply_updates(_to_torch(params), upd),
           j_optim.apply_updates(jp, j_upd), 1e-6)


def test_adamw_state_tree_and_dtype_follow_the_reference():
    params, grads = _np_tree(3)
    opt = chain(clip_by_global_norm(1.0),
                adamw(1e-3, state_dtype=torch.bfloat16))
    st = opt.init(_to_torch(params))
    assert isinstance(st, tuple) and st[0] == () and set(st[1]) == {"m", "v"}
    _, st = opt.update(_to_torch(grads), st, _to_torch(params), 0)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(st))
    jst = j_optim.chain(j_optim.clip_by_global_norm(1.0),
                        j_optim.adamw(1e-3)).init(params)
    # the same leaves under the same checkpoint keys
    assert sorted(k for k, _ in j_ckpt._paths_and_leaves(jst)) == \
        sorted(k for k, _ in paths_and_leaves(st))


def test_clip_matches_the_reference():
    _, grads = _np_tree(5)
    out, _ = clip_by_global_norm(1.0).update(_to_torch(grads), ())
    j_out, _ = j_optim.clip_by_global_norm(1.0).update(
        jax.tree.map(jnp.asarray, grads), ())
    _close(out, j_out, 1e-6)
    assert float(global_norm(_to_torch(grads))) == pytest.approx(
        float(j_optim.global_norm(grads)), rel=1e-6)


@pytest.mark.parametrize("which", ["cosine", "warmup_cosine"])
def test_schedules_match_the_reference(which):
    """At steps 0..N+20, within 1e-7 and within one float32 ulp of the
    unit-scale schedule (base_lr 2^-23): XLA's and PyTorch's float32 cos
    round apart by an ulp."""
    if which == "cosine":
        base = 3e-3
        fn, j_fn = cosine_schedule(base, 50), j_optim.cosine_schedule(base, 50)
    else:
        base = 2e-3
        fn = linear_warmup_cosine(base, 20, 300)
        j_fn = j_optim.linear_warmup_cosine(base, 20, 300)
    steps = np.arange(0, 320)
    got = np.array([float(fn(torch.tensor(int(s)))) for s in steps])
    ref = np.asarray(jax.vmap(j_fn)(jnp.asarray(steps)))
    err = float(np.max(np.abs(got - ref)))
    assert err <= 1e-7 and err <= base * 2.0**-23


# ---------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_prune():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "n": {"b": torch.ones(4, dtype=torch.bfloat16)}}
        for s in (5, 10, 15, 20):
            ckpt.save(d, s, tree, keep=2)
        assert ckpt.all_steps(d) == [15, 20]
        restored, step = ckpt.restore(d, tree)
        assert step == 20
        assert torch.equal(restored["a"], tree["a"])
        assert restored["n"]["b"].dtype == torch.bfloat16


def test_checkpoint_atomicity_ignores_tmp():
    with tempfile.TemporaryDirectory() as d:
        tree = {"a": torch.ones(3)}
        ckpt.save(d, 1, tree)
        # simulate a crashed writer
        os.makedirs(os.path.join(d, "step_00000002.tmp"))
        assert ckpt.latest_step(d) == 1
        restored, step = ckpt.restore(d, tree)
        assert step == 1


def test_checkpoint_shape_mismatch_raises():
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 1, {"a": torch.ones(3)})
        with pytest.raises(ValueError):
            ckpt.restore(d, {"a": torch.ones(4)})


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as d:
        ac = ckpt.AsyncCheckpointer(d, keep=3)
        for s in (1, 2, 3):
            ac.save(s, {"a": torch.full((2,), float(s))})
        ac.wait()
        ac.close()
        restored, step = ckpt.restore(d, {"a": torch.zeros(2)})
        assert step == 3 and float(restored["a"][0]) == 3.0


def test_async_save_is_a_copy_taken_before_it_returns(tmp_path):
    """An in-place update right after ``save`` returns does not reach the
    checkpoint (the optimiser may update the same tensors)."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    w = torch.full((1000,), 1.0)
    ac.save(1, {"w": w})
    w.add_(5.0)
    ac.wait()
    ac.close()
    restored, _ = ckpt.restore(str(tmp_path), {"w": torch.zeros(1000)})
    assert torch.equal(restored["w"], torch.full((1000,), 1.0))


def _state_np(seed):
    """A train state: a tuple (chain's), float32 and bfloat16 leaves, an
    int32 step; bf16 as its raw bits (uint16), so both sides build it."""
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf_bits = (rng.standard_normal(5).astype(np.float32).view(np.uint32)
               >> 16).astype(np.uint16)
    return f32, bf_bits, np.int32(17 + seed)


def _torch_state(f32, bf_bits, step):
    bf = torch.from_numpy(bf_bits.view(np.int16).copy()).view(torch.bfloat16)
    return {"params": {"w": torch.from_numpy(f32.copy()), "b": bf},
            "opt": ((), {"m": {"w": torch.from_numpy(2 * f32)}}),
            "step": torch.tensor(int(step), dtype=torch.int32)}


def _jax_state(f32, bf_bits, step):
    import ml_dtypes
    bf = jnp.asarray(bf_bits.view(ml_dtypes.bfloat16))
    return {"params": {"w": jnp.asarray(f32), "b": bf},
            "opt": ((), {"m": {"w": jnp.asarray(2 * f32)}}),
            "step": jnp.asarray(step, jnp.int32)}


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_crosses_packages_bitwise(writer, tmp_path):
    """A state written by either package restores bitwise in the other:
    same keys, files, dtypes (bf16 as raw bytes) and step."""
    f32, bf_bits, step = _state_np(1)
    t_state, j_state = _torch_state(f32, bf_bits, step), \
        _jax_state(f32, bf_bits, step)
    d = str(tmp_path)
    zeros_t = tree_map(torch.zeros_like, t_state)
    zeros_j = jax.tree.map(jnp.zeros_like, j_state)
    if writer == "reference":
        j_ckpt.save(d, 4, j_state)
        got, s = ckpt.restore(d, zeros_t)
        want = t_state
    else:
        ckpt.save(d, 4, t_state)
        got, s = j_ckpt.restore(d, zeros_j)
        want = j_state
        got = jax.tree.map(np.asarray, got)
    assert s == 4
    g_leaves = tree_leaves(got) if writer == "reference" \
        else jax.tree.leaves(got)
    w_leaves = tree_leaves(want) if writer == "reference" \
        else jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves) == 4
    for g, w in zip(g_leaves, w_leaves):
        assert str(g.dtype).removeprefix("torch.") == \
            str(w.dtype).removeprefix("torch.")
        assert _bits(g) == _bits(w)
    with open(os.path.join(d, "step_00000004", "index.json")) as f:
        index = __import__("json").load(f)
    assert set(index["leaves"]) == {"params/w", "params/b", "opt/1/m/w",
                                    "step"}
    assert index["leaves"]["params/b"]["raw_bytes"] is True
    assert index["leaves"]["params/b"]["dtype"] == "bfloat16"


# ------------------------------------------------------------- runtime
def test_straggler_monitor_flags_sustained_slowness():
    mon = StragglerMonitor(warmup_steps=3, z_thresh=3.0, patience=2)
    flagged = []
    for i in range(30):
        dt = 0.1 + (1.0 if 20 <= i < 24 else 0.0)
        if mon.observe(i, dt):
            flagged.append(i)
    assert mon.events, "sustained slow steps must produce an event"
    assert all(20 <= e[0] < 25 for e in mon.events)


def test_trainloop_failure_injection_and_resume():
    """Kill at step 6, resume, and verify the metric stream equals an
    uninterrupted run (checkpoint + deterministic data => exact recovery)."""
    def train_step(state, batch):
        w = state["params"].detach().requires_grad_()
        loss = torch.mean((w * batch["x"] - 1.0) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        w = (w - 0.1 * g).detach()
        return ({"params": w, "step": state["step"] + 1},
                {"loss": torch.mean((w * batch["x"] - 1.0) ** 2)})

    def init_state():
        return {"params": torch.zeros(4),
                "step": torch.zeros((), dtype=torch.int32)}

    class Batches:
        def __init__(self):
            self.step = 0

        def __iter__(self):
            return self

        def __next__(self):
            x = torch.full((4,), 1.0 + 0.1 * (self.step % 3))
            self.step += 1
            return {"x": x}

    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        # uninterrupted reference
        loop_ref = TrainLoop(train_step, init_state, d1, save_every=5,
                             async_save=False)
        _, hist_ref = loop_ref.run(Batches(), 12, log=None)

        # interrupted at 6 (after the step-5 checkpoint), then resumed
        loop = TrainLoop(train_step, init_state, d2, save_every=5,
                         async_save=False)
        with pytest.raises(InjectedFailure):
            loop.run(Batches(), 12, fail_at=6, log=None)
        loop2 = TrainLoop(train_step, init_state, d2, save_every=5,
                          async_save=False)
        _, hist2 = loop2.run(Batches(), 12, log=None)

        assert hist2[-1]["loss"] == pytest.approx(hist_ref[-1]["loss"],
                                                  rel=1e-6)
        assert hist2 == hist_ref[5:]


def test_trainloop_drains_its_saver_before_raising(tmp_path, monkeypatch):
    """A slow async write handed over before an injected failure is
    committed when ``run`` raises, so a resume in the same process starts
    from it (not from an older checkpoint)."""
    real_save = ckpt.save

    def slow_save(*a, **k):
        time.sleep(0.3)
        return real_save(*a, **k)

    monkeypatch.setattr(ckpt, "save", slow_save)

    def train_step(state, batch):
        return {"w": state["w"] + 1.0}, {"loss": state["w"].sum()}

    loop = TrainLoop(train_step, lambda: {"w": torch.zeros(2)},
                     str(tmp_path), save_every=2)
    with pytest.raises(InjectedFailure):
        loop.run(iter(lambda: {}, None), 6, fail_at=3, log=None)
    assert ckpt.latest_step(str(tmp_path)) == 2
    _, hist = loop.run(iter(lambda: {}, None), 6, log=None)
    assert [h["loss"] for h in hist] == [4.0, 6.0, 8.0, 10.0]
