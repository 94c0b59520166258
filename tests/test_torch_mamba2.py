"""The port's Mamba2 block and Zamba2 hybrid against the JAX reference:
the SSD's two paths (``ssd_sequential``, ``ssd_chunked``) from a nonzero
state, with their final states, ``_segsum``, the causal conv from a
nonzero conv state, ``mamba2_apply`` on both paths; the Zamba2 smoke
model (4 Mamba blocks, the shared block after every 2): ``forward``,
``loss_fn`` and its gradients, ``prefill`` and ``decode_step`` with every
cache leaf, ``denoise`` at two t, the cache layouts, a stack with Mamba
blocks left over (5 at period 2); the configs, param counts, the
converter, the tame weights and the drivers (``launch.sample``,
``launch.serve`` in both modes, ``launch.train``).

Inputs are drawn with numpy from a seed; the reference's parameters come
across leaf by leaf (``params_from_jax`` with the reference's config). The
shared attention's ``wq``/``wk`` are scaled by 0.1 after the reference's
init: at smoke width its logits have std ~64 (the head dim), where a
float32 forward is ~2e-5 from another float32 rounding order in either
package. Tolerances, against the output's scale max(1, max|ref|): 1e-5 on
a float32 stream (gradients: 1e-5 of each leaf's max |ref|); 1e-2 on the
bfloat16 stream for the conv and the Mamba block (the frameworks round
bf16 at other places). The whole Zamba2 stack amplifies bf16 rounding
past that: the reference's own bf16 forward sits 2.9% (of the logits'
peak) from its float32 forward at smoke width, and one Mamba block
already 1.8%, through the SSD's sums over bf16-rounded x, B, C and dt. So
a bf16 result of the whole model is held to the reference's float32 one,
no farther from it than 1.25x the reference's own bf16 result
(``_bf16_close``).
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.sample as j_sample
from repro import optim as j_optim
from repro.configs import ARCHS as j_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.models import mamba2 as J
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import (cache_from_jax, model_from_config,
                                 params_from_jax)
from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
from repro_torch.launch import sample as t_sample
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import Mamba2Config, Zamba2, Zamba2Config, init_params
from repro_torch.models import mamba2 as T
from repro_torch.models.tame import (ensure_contractive, tame_networks,
                                     tame_zamba2)
from repro_torch.tree import paths_and_leaves

ARCH = "zamba2-7b"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
QK_SCALE = 0.1
#: a bf16 decode's logits at any one step no farther than this from the
#: reference's float32 ones (scale error): over model seeds 0-7 at smoke
#: width the port's worst step is 0.0528, the reference's own bf16 0.0494
BF16_STEP_CAP = 0.06


def scale_err(got, ref) -> float:
    """max |got - ref| over max(1, max|ref|)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _bf16_close(got, ref_bf16, ref_f32) -> bool:
    """A bf16 result of the port no farther from the reference's float32
    result than 1.25x the reference's own bf16 result (module
    docstring)."""
    return scale_err(_np(got), ref_f32) <= \
        1.25 * scale_err(ref_bf16, ref_f32) + 1e-6


def _leaf_errs(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| per leaf path."""
    got = dict(paths_and_leaves(got))
    ref = dict(paths_and_leaves(jax.tree.map(np.asarray, ref)))
    assert set(got) == set(ref)
    out = {}
    for k, r in ref.items():
        g = _np(got[k])
        assert g.shape == r.shape, k
        s = float(np.abs(r.astype(np.float32)).max())
        e = float(np.abs(g - r.astype(np.float32)).max())
        out[k] = e / s if s else (0.0 if e == 0 else math.inf)
    return out


# ------------------------------------------------------------ the SSD
def _ssd_inputs(seed, B=2, Tn=64, H=8, P=16, G=2, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Tn, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(0.5 * rng.standard_normal((B, Tn, H)) - 1.0)
                  ).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bv = rng.standard_normal((B, Tn, G, N)).astype(np.float32)
    Cv = rng.standard_normal((B, Tn, G, N)).astype(np.float32)
    D = rng.standard_normal(H).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return [x, dt, A, Bv, Cv, D, h0]


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_sequential_matches_reference(G):
    """From a nonzero h0, B/C shared over H/G heads: y and the final
    state."""
    args = _ssd_inputs(G, Tn=24, G=G)
    jy, jh = jax.jit(J.ssd_sequential)(*map(jnp.asarray, args))
    ty, th = T.ssd_sequential(*map(torch.from_numpy, args))
    assert scale_err(_np(ty), jy) <= 1e-5
    assert scale_err(_np(th), jh) <= 1e-5


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_ssd_chunked_matches_reference_and_the_sequential_path(chunk):
    """The chunked path against the reference's chunked path, from a
    nonzero h0 (y and the final state), and against the sequential one."""
    args = _ssd_inputs(chunk)
    jy, jh = jax.jit(J.ssd_chunked, static_argnums=7)(
        *map(jnp.asarray, args), chunk)
    ty, th = T.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk)
    assert scale_err(_np(ty), jy) <= 1e-5
    assert scale_err(_np(th), jh) <= 1e-5
    sy, sh = T.ssd_sequential(*map(torch.from_numpy, args))
    assert scale_err(_np(ty), _np(sy)) <= 1e-5
    assert scale_err(_np(th), _np(sh)) <= 1e-5
    with pytest.raises(ValueError, match="divisible"):
        T.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk + 1)


def test_segsum_matches_reference():
    logd = -np.abs(np.random.default_rng(3).standard_normal((2, 3, 12))
                   ).astype(np.float32)
    ref = np.asarray(J._segsum(jnp.asarray(logd)))
    got = T._segsum(torch.from_numpy(logd)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    assert np.abs(got[fin] - ref[fin]).max() <= 1e-5


def test_ssd_chunked_gradients_match_the_sequential_path():
    """Under autograd the chunked path's gradients are the sequential
    path's."""
    args = [torch.from_numpy(a).requires_grad_() for a in _ssd_inputs(5)]
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 64, 8, 16)).astype(np.float32))
    grads = []
    for fn in (lambda *a: T.ssd_chunked(*a, chunk=16), T.ssd_sequential):
        y, h = fn(*args)
        g = torch.autograd.grad((y * w).sum() + h.sum(), args)
        grads.append(g)
    for a, b in zip(*grads):
        assert scale_err(_np(a), _np(b)) <= 1e-5


# ------------------------------------------------------------ conv / block
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv_from_a_nonzero_state_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(7)
    u = rng.standard_normal((2, 10, 12)).astype(np.float32)
    w = 0.5 * rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jo, js = J._causal_conv(jnp.asarray(u, jdt), jnp.asarray(w),
                            jnp.asarray(b), jnp.asarray(st, jdt))
    to, ts = T._causal_conv(torch.from_numpy(u).to(tdt), torch.from_numpy(w),
                            torch.from_numpy(b), torch.from_numpy(st).to(tdt))
    assert to.dtype == ts.dtype == tdt
    assert scale_err(_np(to), jo) <= tol
    assert np.array_equal(_np(ts), _np(js))  # the last K-1 inputs, exact


def _mamba_case(seed, dtype, T_len):
    m = Mamba2Config(d_inner=64, head_dim=16, n_groups=2, d_state=8,
                     conv_width=4, chunk_size=16)
    jm = J.Mamba2Config(**dataclasses.asdict(m))
    d = 32
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(seed),
                                      J.mamba2_defs(d, jm), jnp.float32))
    jp["norm"] = 0.1 * np.random.default_rng(seed).standard_normal(64)
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((2, T_len, d)).astype(np.float32)
    cache = {"conv": rng.standard_normal((2, 3, 64 + 32)).astype(np.float32),
             "h": rng.standard_normal((2, 4, 16, 8)).astype(np.float32)}
    jdt, tdt, tol = DTYPES[dtype]
    jc = {"conv": jnp.asarray(cache["conv"], jdt), "h": jnp.asarray(
        cache["h"])}
    tc = {"conv": torch.from_numpy(cache["conv"]).to(tdt),
          "h": torch.from_numpy(cache["h"])}
    return m, jm, jp, tp, jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt), \
        jc, tc, tol


@pytest.mark.parametrize("T_len,chunked", [(64, True), (40, True),
                                           (64, False), (1, False)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_apply_matches_reference(T_len, chunked, dtype):
    """Both SSD paths (T 64 at chunk 16 takes the chunked one; T 40, not a
    multiple, and ``chunked=False`` the sequential one; T 1 is a decode
    step) from nonzero conv and SSM states: the output and the new
    states."""
    m, jm, jp, tp, jx, tx, jc, tc, tol = _mamba_case(T_len, dtype, T_len)
    jo, jn = J.mamba2_apply(jp, jm, jx, jc, chunked=chunked)
    to, tn = T.mamba2_apply(tp, m, tx, tc, chunked=chunked)
    assert to.dtype == tx.dtype and tn["conv"].dtype == tc["conv"].dtype
    assert tn["h"].dtype == torch.float32
    assert scale_err(_np(to), jo) <= tol
    assert scale_err(_np(tn["h"]), jn["h"]) <= tol
    assert scale_err(_np(tn["conv"]), jn["conv"]) <= tol


def test_mamba2_apply_without_a_cache_starts_from_zero_states():
    m, _, _, tp, _, tx, _, tc, _ = _mamba_case(3, "f32", 32)
    zero = {k: torch.zeros_like(v) for k, v in tc.items()}
    a, na = T.mamba2_apply(tp, m, tx, None, chunked=True)
    b, nb = T.mamba2_apply(tp, m, tx, zero, chunked=True)
    assert torch.equal(a, b)
    for k in na:
        assert torch.equal(na[k], nb[k])


# ------------------------------------------------------------ Zamba2 smoke
class _Compiled:
    """A reference model's entry points, each compiled once; ``grad`` is
    ``loss_fn``'s gradient."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.init_cache = model.init_cache
        self.cache_shapes = model.cache_shapes
        for name in ("forward", "loss_fn", "prefill", "decode_step",
                     "denoise"):
            setattr(self, name, jax.jit(getattr(model, name)))
        self.grad = jax.jit(jax.grad(model.loss_fn))


def _temper(jp):
    jp["shared"]["attn"]["wq"] = QK_SCALE * jp["shared"]["attn"]["wq"]
    jp["shared"]["attn"]["wk"] = QK_SCALE * jp["shared"]["attn"]["wk"]
    return jp


def _model_pair(dtype="f32", seed=0, **over):
    """(reference model (compiled), its tempered params, port model, the
    params converted by ``params_from_jax(config=)``)."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jdt, cache_dtype=jdt,
                               **over)
    jm = j_build_model(jcfg)
    jp = _temper(jax.device_get(jax.jit(lambda k: j_init_params(
        k, jm.param_defs(), jnp.float32))(jax.random.PRNGKey(seed))))
    tp = params_from_jax(jp, config=jcfg)
    tm = Zamba2(dataclasses.replace(model_from_config(jcfg).cfg, dtype=tdt,
                                    cache_dtype=tdt))
    return _Compiled(jm), jp, tm, tp


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module")
def z_pair():
    return _model_pair()


@pytest.mark.parametrize("dtype,S", [("f32", 32), ("f32", 24),
                                     ("bf16", 32)])
def test_forward_matches_reference(dtype, S):
    """S 32 runs the chunked SSD (chunk 16), S 24 the sequential one; the
    bf16 stream is held by ``_bf16_close``."""
    jm, jp, tm, tp = _model_pair(dtype)
    toks = _tokens(tm.cfg.vocab_size, 2, S, seed=S)
    ref, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    assert got.dtype == torch.float32
    assert float(aux) == float(jaux) == 0.0
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    if dtype == "f32":
        assert scale_err(_np(got), ref) <= 1e-5
    else:
        j32, jp32, _, _ = _model_pair("f32")
        ref32, _ = j32.forward(jp32, {"tokens": jnp.asarray(toks)})
        assert _bf16_close(got, ref, ref32)


def test_loss_and_gradients_match_reference(z_pair):
    """``loss_fn`` with a mask, and every leaf's gradient against
    ``jax.grad``, under remat "none" and "full"."""
    jm, jp, tm, tp = z_pair
    b = synthetic_lm_batch(TokenTaskConfig(vocab_size=tm.cfg.vocab_size,
                                           seq_len=32), 2, 0)
    mask = (np.random.default_rng(1).random((2, 32)) > 0.3).astype(
        np.float32)
    jb = {k: jnp.asarray(b[k]) for k in ("tokens", "labels")}
    tb = {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")}
    ref = float(jm.loss_fn(jp, dict(jb, mask=jnp.asarray(mask))))
    got = float(tm.loss_fn(tp, dict(tb, mask=torch.from_numpy(mask))))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    jg = jm.grad(jp, jb)
    for remat in ("none", "full"):
        model = Zamba2(dataclasses.replace(tm.cfg, remat=remat))
        _, grads = t_train.loss_and_grads(model, tp, tb)
        errs = _leaf_errs(grads, jg)
        assert max(errs.values()) <= 1e-5, (remat, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    """prefill(16) (the chunked SSD) into a cache of 20, then decode steps
    16..19: logits at each step and every cache leaf (the Mamba conv and
    SSM states, the shared KV cache), from a cache in the config's dtype.
    The bf16 stream and cache are held against the reference's float32
    run: the cache leaves by ``_bf16_close``; the logits by its bar on
    the worst step over prefill and decode together (each step's error is
    a draw of bf16 rounding: the port and the reference round at the same
    points, not alike), and every step under ``BF16_STEP_CAP``."""
    jm, jp, tm, tp = _model_pair(dtype)
    j32 = _model_pair("f32")[0] if dtype == "bf16" else None
    toks = _tokens(tm.cfg.vocab_size, 2, 20, seed=4)
    tt = torch.from_numpy(toks.astype(np.int64))
    P, S = 16, 20
    steps = {}  # bf16: position -> (port's error, reference's own)

    def check(got, ref, ref32, what):
        if j32 is None:
            assert scale_err(_np(got), ref) <= 1e-5, what
        else:
            steps[what] = (scale_err(_np(got), ref32), scale_err(ref, ref32))

    def leaves(tree):
        return dict(paths_and_leaves(jax.tree.map(np.asarray, tree)))

    def check_cache(cache, jcache, jcache32):
        ref, ref32 = leaves(jcache), leaves(jcache32 or jcache)
        for k, v in paths_and_leaves(cache):
            ref_k, ref32_k = ref[k].astype(np.float32), \
                ref32[k].astype(np.float32)
            if j32 is None:
                assert scale_err(_np(v), ref_k) <= 1e-5, k
            else:
                assert _bf16_close(v, ref_k, ref32_k), k

    batch = {"tokens": jnp.asarray(toks[:, :P])}
    jlg, jcache = jm.prefill(jp, batch, jm.init_cache(2, S))
    jlg32, jcache32 = (None, None) if j32 is None else \
        j32.prefill(jp, batch, j32.init_cache(2, S))
    lg, cache = tm.prefill(tp, {"tokens": tt[:, :P]}, tm.init_cache(2, S))
    check(lg, jlg, jlg32, "prefill")
    check_cache(cache, jcache, jcache32)
    for i in range(P, S):
        step = jnp.asarray(toks[:, i:i + 1])
        jlg, jcache = jm.decode_step(jp, step, jcache, i)
        if j32 is not None:
            jlg32, jcache32 = j32.decode_step(jp, step, jcache32, i)
        lg, cache = tm.decode_step(tp, tt[:, i:i + 1], cache, i)
        check(lg, jlg, jlg32, i)
    check_cache(cache, jcache, jcache32)
    if j32 is not None:
        port = max(e for e, _ in steps.values())
        own = max(e for _, e in steps.values())
        assert port <= 1.25 * own + 1e-6, steps
        assert all(e <= BF16_STEP_CAP for e, _ in steps.values()), steps
    assert cache["mamba"]["h"].dtype == torch.float32
    assert cache["shared_kv"]["k"].dtype == tm.cfg.cache_dtype


def test_decode_matches_forward_token_by_token(z_pair):
    """prefill(16) + decode steps to 24 against the forward's logits at
    each position, in both packages."""
    jm, jp, tm, tp = z_pair
    B, S, k = 2, 24, 16
    toks = _tokens(tm.cfg.vocab_size, B, S, seed=5)
    tt = torch.from_numpy(toks.astype(np.int64))
    jfw, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    fw, _ = tm.forward(tp, {"tokens": tt})
    lg, cache = tm.prefill(tp, {"tokens": tt[:, :k]}, tm.init_cache(B, S))
    assert scale_err(_np(lg[:, 0]), _np(fw[:, k - 1])) <= 1e-5
    for i in range(k, S):
        lg, cache = tm.decode_step(tp, tt[:, i:i + 1], cache, i)
        assert scale_err(_np(lg[:, 0]), _np(fw[:, i])) <= 1e-5, i
    assert scale_err(_np(fw), jfw) <= 1e-5


@pytest.mark.parametrize("layers,period", [(5, 2), (3, 4)])
def test_stacks_with_mamba_blocks_left_over_match_reference(layers, period):
    """5 blocks at period 2 (two shared applications, one block left
    over) and 3 at period 4 (no shared application, no shared KV cache):
    forward, prefill and a decode step."""
    jm, jp, tm, tp = _model_pair(n_layers=layers, shared_period=period)
    assert tm.cfg.n_shared_apps == layers // period
    toks = _tokens(tm.cfg.vocab_size, 2, 17, seed=layers)
    tt = torch.from_numpy(toks.astype(np.int64))
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks[:, :16])})
    got, _ = tm.forward(tp, {"tokens": tt[:, :16]})
    assert scale_err(_np(got), ref) <= 1e-5
    jlg, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])},
                         jm.init_cache(2, 17))
    lg, c = tm.prefill(tp, {"tokens": tt[:, :16]}, tm.init_cache(2, 17))
    assert ("shared_kv" in c) == (layers >= period) == ("shared_kv" in jc)
    jlg, jc = jm.decode_step(jp, jnp.asarray(toks[:, 16:]), jc, 16)
    lg, c = tm.decode_step(tp, tt[:, 16:], c, 16)
    assert scale_err(_np(lg), jlg) <= 1e-5
    assert max(_leaf_errs(c, jc).values()) <= 1e-5


@pytest.mark.parametrize("t", [0.9, 0.2])
def test_denoise_matches_reference(t):
    """Denoiser mode (forward and time-reversed passes averaged, the
    shared attention causal in both) at two t, with a random output head
    (the init's is zero)."""
    jcfg = dataclasses.replace(j_get_smoke(ARCH), denoiser_latent=8,
                               dtype=jnp.float32)
    jm = j_build_model(jcfg)
    jp = _temper(jax.device_get(j_init_params(
        jax.random.PRNGKey(1), jm.param_defs(), jnp.float32)))
    rng = np.random.default_rng(2)
    jp["denoiser"]["out_proj"] = 0.05 * rng.standard_normal(
        jp["denoiser"]["out_proj"].shape).astype(np.float32)
    tm = model_from_config(jcfg)
    tm = Zamba2(dataclasses.replace(tm.cfg, dtype=torch.float32))
    tp = params_from_jax(jp, tm)
    z = rng.standard_normal((2, 32, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.denoise)(jp, jnp.asarray(z), t))
    got = tm.denoise(tp, torch.from_numpy(z), t)
    assert got.dtype == torch.float32 and got.shape == z.shape
    assert float(np.abs(ref).max()) > 0.05
    assert scale_err(_np(got), ref) <= 1e-5
    with pytest.raises(ValueError, match="denoiser_latent"):
        Zamba2(get_smoke(ARCH)).denoise(tp, torch.from_numpy(z), t)


@pytest.mark.parametrize("s_max", [0, 24])
def test_cache_shapes_and_init_cache_are_the_reference(z_pair, s_max):
    """Without positions (s_max 0) the cache is the Mamba states alone;
    with them the shared KV cache [n_shared_apps, B, s_max, K, hd] joins
    it. Shapes and dtypes are the reference's, zeros on the device
    asked."""
    jm, _, tm, _ = z_pair
    ref = jm.cache_shapes(3, s_max)
    got = tm.cache_shapes(3, s_max)
    flat = lambda tree, pre="": {
        pre + k: v for kk, vv in tree.items() for k, v in (
            flat(vv, pre + kk + "/").items()
            if isinstance(vv, dict) else [(kk, vv)])}
    rf, gf = flat(ref), flat(got)
    assert set(rf) == set(gf)
    for k, s in rf.items():
        assert tuple(gf[k][0]) == tuple(s.shape), k
        assert str(gf[k][1]).replace("torch.", "") == str(s.dtype), k
    cache = tm.init_cache(3, s_max, device="cpu")
    for k, v in paths_and_leaves(cache):
        assert not v.any() and v.device.type == "cpu"
    assert ("shared_kv" in cache) == (s_max > 0)
    if s_max:
        assert cache["shared_kv"]["k"].shape == (
            tm.cfg.n_shared_apps, 3, s_max, tm.cfg.n_kv_heads,
            tm.acfg.head_dim)


# ------------------------------------------------------------ configs
def test_registry_is_the_references():
    """The port's ``ARCHS`` are the reference's, in order."""
    assert tuple(ARCHS) == tuple(j_ARCHS)


def test_zamba2_configs_are_the_reference():
    """``full()`` and ``smoke()`` field for field the reference's (the
    nested Mamba2Config too); the shared attention's head dim is 224 at
    full width; the param tree's shapes are the reference's."""
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get(ARCH), j_get(ARCH)
        for f in dataclasses.fields(jcfg):
            if f.name in ("dtype", "cache_dtype"):
                continue
            want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
        assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
        assert cfg.n_shared_apps == jcfg.n_shared_apps
    full = get_config(ARCH)
    assert full.shared_attn_config().head_dim == 224
    assert (full.n_shared_apps, full.n_layers % full.shared_period) == (13, 3)
    jdefs = j_build_model(j_get_smoke(ARCH)).param_defs()
    tdefs = Zamba2(get_smoke(ARCH)).param_defs()
    shapes = lambda tree: {k: tuple(v.shape)
                           for k, v in paths_and_leaves(tree)}
    assert shapes(tdefs) == shapes(jdefs)


def test_param_count_is_the_reference():
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        assert get(ARCH).param_count() == tuple(j_get(ARCH).param_count())
    assert get_config(ARCH).param_count()[0] == 7_121_410_640


# ------------------------------------------------------------ converter
def test_converter_takes_a_zamba2_tree_and_cache(z_pair):
    """params_from_jax by config and by model agree, and a Zamba2 tree
    without either is refused; the reference's prefilled cache
    (``mamba/conv``, ``mamba/h``, ``shared_kv``) decodes in the port as in
    the reference."""
    jm, jp, tm, tp = z_pair
    for k, v in paths_and_leaves(params_from_jax(jp, tm)):
        assert torch.equal(v, dict(paths_and_leaves(tp))[k])
    with pytest.raises(ValueError, match="config="):
        params_from_jax(jp)
    toks = _tokens(tm.cfg.vocab_size, 2, 17, seed=6)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :16])},
                           jm.init_cache(2, 17))
    cache = cache_from_jax(jax.device_get(jcache))
    assert set(cache) == {"mamba", "shared_kv"}
    jlg, _ = jm.decode_step(jp, jnp.asarray(toks[:, 16:]), jcache, 16)
    lg, _ = tm.decode_step(tp, torch.from_numpy(
        toks[:, 16:].astype(np.int64)), cache, 16)
    assert scale_err(_np(lg), jlg) <= 1e-5


# ------------------------------------------------------------ tame weights
def test_tame_zamba2_is_contractive_and_has_no_cached_twin():
    model, params, mu = tame_zamba2(smoke=True, device="cpu")
    assert model.cfg.dtype == torch.float32 and model.cfg.denoiser_latent
    net, cached = tame_networks(model, params, mu)
    assert cached is None
    g = torch.Generator().manual_seed(3)
    x = torch.randn((1, 32, model.cfg.denoiser_latent), generator=g)
    report = ensure_contractive(model, params, mu, x, g)
    assert report["damped"] == "out_proj"
    assert max(report["gains"].values()) < 1.0
    x0 = net(x, torch.tensor(0.5), None)
    assert torch.isfinite(x0).all() and x0.shape == x.shape
    # against the seeded init: the branch projections damped, the shared
    # logits brought to unit scale (wq and wk by hd^-1/2 each)
    init = init_params(torch.Generator().manual_seed(0), model.param_defs())
    hd = model.acfg.head_dim
    for got, want in (
            (params["shared"]["attn"]["wq"], init["shared"]["attn"]["wq"]
             * hd ** -0.5),
            (params["shared"]["out_proj"], init["shared"]["out_proj"] * 0.05),
            (params["blocks"]["mamba"]["out_proj"],
             init["blocks"]["mamba"]["out_proj"] * 0.05)):
        assert torch.equal(got, want)


# ------------------------------------------------------------ drivers
def _nfe_words(text: str) -> str:
    """The ``NFE=... steps=N`` words of a sampling driver's first line."""
    line = next(ln for ln in text.splitlines() if ln.startswith("arch="))
    return line[line.index("NFE="):line.index(" tau=")]


def test_launch_sample_matches_the_reference_nfe_accounting(capsys,
                                                             monkeypatch):
    """``launch.sample --arch zamba2-7b --smoke`` on the CPU, tame and
    init weights: finite, with the reference driver's NFE accounting;
    ``--feature-cache`` refused (no cached evaluation)."""
    argv = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
            "--nfe", "7", "--mode", "PECE"]
    monkeypatch.setattr(sys, "argv", ["sample"] + argv)
    j_sample.main()
    ref = capsys.readouterr().out
    t_sample.main(argv + ["--device", "cpu", "--combine", "fused",
                          "--weights", "tame"])
    t_sample.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("arch=zamba2-smoke latent=16") == 2
    assert out.count("finite=True") == 2
    assert _nfe_words(out) == _nfe_words(ref) == \
        "NFE=7 (network NFE=7) (requested 7) steps=3"
    with pytest.raises(SystemExit, match="denoise_cached"):
        t_sample.main(argv + ["--device", "cpu", "--feature-cache", "2"])
    with pytest.raises(SystemExit, match="--wkv-kernel"):
        t_sample.build_denoiser(ARCH, smoke=True, wkv_kernel=True,
                                device="cpu")


def test_launch_serve_smoke_in_both_modes(capsys):
    t_serve.main(["--mode", "lm", "--arch", ARCH, "--smoke", "--device",
                  "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=zamba2-smoke prefill 16 toks x2" in out
    assert "sample token ids:" in out
    t_serve.main(["--mode", "diffusion", "--arch", ARCH, "--device", "cpu",
                  "--requests", "3", "--nfe", "6", "--seq", "16"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "arch=zamba2-smoke" in out


def test_launch_train_trains_through_the_plain_attention(tmp_path):
    """Three driver steps on the CPU: ``train_config`` takes the plain
    attention, the losses are finite, and the first is ``loss_fn`` of the
    initial state on the first batch."""
    cfg = t_train.train_config(get_config(ARCH))
    assert isinstance(cfg, Zamba2Config) and cfg.use_flash is False
    argv = ["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt", str(tmp_path),
            "--resume", "fresh"]
    _, hist = t_train.main(argv)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    args = t_train.parse_args(argv)
    model = Zamba2(t_train.train_config(get_smoke(ARCH)))
    opt = t_train.make_optimizer(args.lr, args.steps)
    p0 = t_train.make_init_state(model, opt, torch.device("cpu"))()["params"]
    b0 = next(t_train.make_batches(get_smoke(ARCH), 2, 32,
                                   torch.device("cpu")))
    with torch.no_grad():
        assert float(model.loss_fn(p0, b0)) == losses[0]


def test_one_driver_step_matches_the_reference():
    """One step of the driver's step (clip -> AdamW) against the
    reference driver's jitted step from the same parameters and batch:
    loss, gradient norm, then the parameters and the AdamW state per
    leaf."""
    jm, jp, model, params = _model_pair()
    model = Zamba2(t_train.train_config(model.cfg))
    j_opt = j_optim.chain(j_optim.clip_by_global_norm(1.0), j_optim.adamw(
        j_optim.linear_warmup_cosine(3e-4, 10, 100)))
    opt = t_train.make_optimizer(3e-4, 100)

    @jax.jit
    def j_step(state, batch):
        loss, grads = jax.value_and_grad(jm.loss_fn.__wrapped__
                                         if hasattr(jm.loss_fn, "__wrapped__")
                                         else jm.loss_fn)(state["params"],
                                                          batch)
        updates, opt_state = j_opt.update(grads, state["opt"],
                                          state["params"], state["step"])
        return ({"params": j_optim.apply_updates(state["params"], updates),
                 "opt": opt_state, "step": state["step"] + 1},
                {"loss": loss, "gnorm": j_optim.global_norm(grads)})

    b = synthetic_lm_batch(TokenTaskConfig(vocab_size=model.cfg.vocab_size,
                                           seq_len=32), 2, 0)
    j0 = jax.tree.map(jnp.asarray, jp)
    j_state, jm_ = j_step({"params": j0, "opt": j_opt.init(j0),
                           "step": jnp.zeros((), jnp.int32)},
                          {k: jnp.asarray(b[k]) for k in ("tokens",
                                                          "labels")})
    state, m = t_train.make_train_step(model, opt)(
        {"params": params, "opt": opt.init(params),
         "step": torch.zeros((), dtype=torch.int32)},
        {k: torch.from_numpy(b[k]) for k in ("tokens", "labels")})
    for key in ("loss", "gnorm"):
        assert abs(float(m[key]) - float(jm_[key])) <= \
            1e-5 * float(jm_[key]), key
    for part in ("params", "opt"):
        errs = _leaf_errs(state[part], j_state[part])
        assert max(errs.values()) <= 1e-5, (part, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3])


def _bf16_step_errors(seed: int) -> dict:
    """{position: (the port's bf16 error, the reference's own)} of
    ``test_prefill_and_decode_match_reference``'s logits (prefill(16),
    then decode steps 16..19) at model seed ``seed``, each the scale
    error against the reference's float32 run."""
    jm, jp, tm, tp = _model_pair("bf16", seed=seed)
    j32 = _model_pair("f32", seed=seed)[0]
    toks = _tokens(tm.cfg.vocab_size, 2, 20, seed=4)
    tt = torch.from_numpy(toks.astype(np.int64))
    P, S = 16, 20
    batch = {"tokens": jnp.asarray(toks[:, :P])}
    jlg, jc = jm.prefill(jp, batch, jm.init_cache(2, S))
    jlg32, jc32 = j32.prefill(jp, batch, j32.init_cache(2, S))
    lg, cache = tm.prefill(tp, {"tokens": tt[:, :P]}, tm.init_cache(2, S))
    out = {"prefill": (scale_err(_np(lg), jlg32), scale_err(jlg, jlg32))}
    for i in range(P, S):
        step = jnp.asarray(toks[:, i:i + 1])
        jlg, jc = jm.decode_step(jp, step, jc, i)
        jlg32, jc32 = j32.decode_step(jp, step, jc32, i)
        lg, cache = tm.decode_step(tp, tt[:, i:i + 1], cache, i)
        out[i] = (scale_err(_np(lg), jlg32), scale_err(jlg, jlg32))
    return out


if __name__ == "__main__":
    # the per-step ratios behind BF16_STEP_CAP and the bar on the worst
    # step (ROADMAP C7): PYTHONPATH=src python tests/test_torch_mamba2.py
    for seed in range(8):
        errs = _bf16_step_errors(seed)
        port = max(e for e, _ in errs.values())
        own = max(e for _, e in errs.values())
        print(f"seed {seed}: " + ", ".join(
            f"{k} {e:.4f}/{o:.4f} ({e / o:.2f})"
            for k, (e, o) in errs.items())
            + f"; worst {port:.4f}/{own:.4f} ({port / own:.3f})")
