"""The port's M-RoPE (Qwen2-VL) against the JAX reference: ``apply_mrope``
with distinct (t, h, w) position streams, at qwen2-vl-2b's smoke and
published sections, the cached GQA attention with M-RoPE, and
qwen2-vl-2b's smoke LM (embeddings in, tied head): ``forward`` and
``loss_fn`` over three-stream positions, ``prefill`` and ``decode_step``
(the text-only positions the reference's decode gives), the decode
consistency, the flash route, the configs field for field, the param
count and ``launch.serve --mode lm``.

Inputs are drawn with numpy from a seed; the reference's parameters come
across leaf by leaf (``params_from_jax`` with the reference's config).
The attention's ``wq``/``wk`` are scaled by 0.3 after the reference's
init, as in ``tests/test_torch_lm.py`` (logits of unit scale).
Tolerances, against the output's scale max(1, max|ref|): 1e-5 on a
float32 stream; 1e-2 on the bfloat16 stream (the frameworks round bf16 at
other places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.models.attention import AttentionConfig as JAttentionConfig
from repro.models.attention import attn_defs as j_attn_defs
from repro.models.attention import gqa_forward as j_gqa_forward
from repro.models.common import apply_mrope as j_apply_mrope
from repro_torch.configs import get_config, get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import TransformerLM
from repro_torch.models.attention import AttentionConfig, gqa_forward
from repro_torch.models.common import apply_mrope, apply_rope

ARCH = "qwen2-vl-2b"
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def scale_err(got, ref) -> float:
    """max |got - ref| over max(1, max|ref|)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _positions3(B, S, seed, grid=(1, 3, 4)):
    """[3, B, S] int32: a (t, h, w) grid of image patches per row at a
    per-row offset, then text counting on in all three streams."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(grid))
    t, h, w = np.meshgrid(*(np.arange(g) for g in grid), indexing="ij")
    img = np.stack([t.reshape(-1), h.reshape(-1), w.reshape(-1)])
    out = np.empty((3, B, S), np.int32)
    for b in range(B):
        off = int(rng.integers(0, 5))
        txt = off + img.max() + 1 + np.arange(S - n)
        out[:, b] = np.concatenate([img + off, np.broadcast_to(
            txt, (3, S - n))], axis=1)
    return out


# ------------------------------------------------------------ apply_mrope
@pytest.mark.parametrize("sections,hd,theta", [((2, 3, 3), 16, 1e4),
                                               ((16, 24, 24), 128, 1e6)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_mrope_matches_reference(sections, hd, theta, dtype):
    """Distinct t/h/w streams (each a random walk of its own) at the smoke
    config's sections and qwen2-vl-2b's (16, 24, 24) at theta 1e6."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(hd)
    B, S, H = 2, 24, 3
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = np.cumsum(rng.integers(0, 3, (3, B, S)), axis=-1).astype(np.int32)
    assert not np.array_equal(pos[0], pos[1])
    assert not np.array_equal(pos[1], pos[2])
    ref = j_apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos), sections,
                        theta)
    got = apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                      sections, theta)
    assert got.dtype == tdt and got.shape == x.shape
    assert scale_err(_np(got), ref) <= tol


def test_apply_mrope_with_equal_streams_is_rope():
    """One position stream in all three sections is plain RoPE; the
    sections must cover hd / 2."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 10, 2, 16)).astype(
        np.float32))
    pos = torch.arange(5, 15)[None].expand(2, 10)
    got = apply_mrope(x, pos[None].expand(3, 2, 10), (2, 3, 3))
    assert torch.equal(got, apply_rope(x, pos))
    with pytest.raises(ValueError, match="sum"):
        apply_mrope(x, pos[None].expand(3, 2, 10), (2, 3, 4))


@pytest.mark.parametrize("with_positions", [True, False])
def test_gqa_forward_with_mrope_and_a_cache_matches_reference(
        with_positions):
    """The cached attention under M-RoPE: a prefill of 8 positions at
    three-stream positions (or the text-only default), then one decode
    step at the default, against the reference's ``gqa_forward``: the
    outputs and both cache leaves."""
    jc = JAttentionConfig(d_model=48, n_heads=6, n_kv_heads=2, head_dim=16,
                          rope_type="mrope", mrope_sections=(2, 3, 3))
    tc = AttentionConfig(d_model=48, n_heads=6, n_kv_heads=2, head_dim=16,
                         rope_type="mrope", mrope_sections=(2, 3, 3))
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      j_attn_defs(jc), jnp.float32))
    for k in ("wq", "wk"):
        jp[k] = 0.3 * jp[k]
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(2)
    B, S, T = 2, 8, 10
    x = rng.standard_normal((B, S + 1, 48)).astype(np.float32)
    pos = _positions3(B, S, seed=3, grid=(1, 2, 3)) if with_positions \
        else None
    jcache = {k: jnp.zeros((B, T, 2, 16)) for k in ("k", "v")}
    tcache = {k: torch.zeros((B, T, 2, 16)) for k in ("k", "v")}
    jy, jcache = j_gqa_forward(
        jp, jc, jnp.asarray(x[:, :S]), cache=jcache, cache_index=0,
        positions=None if pos is None else jnp.asarray(pos))
    ty, tcache = gqa_forward(
        tp, tc, torch.from_numpy(x[:, :S]), cache=tcache, cache_index=0,
        positions=None if pos is None else torch.from_numpy(pos))
    assert scale_err(_np(ty), jy) <= 1e-5
    jy, jcache = j_gqa_forward(jp, jc, jnp.asarray(x[:, S:]), cache=jcache,
                               cache_index=S)
    ty, tcache = gqa_forward(tp, tc, torch.from_numpy(x[:, S:]),
                             cache=tcache, cache_index=S)
    assert scale_err(_np(ty), jy) <= 1e-5
    for k in ("k", "v"):
        assert scale_err(_np(tcache[k]), jcache[k]) <= 1e-5


# ------------------------------------------------------------ the smoke LM
class _Compiled:
    """A reference model's entry points, each compiled once."""

    def __init__(self, model):
        self.init_cache = model.init_cache
        for name in ("forward", "loss_fn", "prefill", "decode_step"):
            setattr(self, name, jax.jit(getattr(model, name)))


def _pair(dtype="f32", **over):
    """(reference model (compiled), its params, port model, the params
    converted by ``params_from_jax(config=)``)."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_smoke(ARCH), dtype=jdt, cache_dtype=jdt,
                               **over)
    jm = j_build_model(jcfg)
    jp = jax.device_get(jax.jit(lambda k: j_init_params(
        k, jm.param_defs(), jnp.float32))(jax.random.PRNGKey(0)))
    for k in ("wq", "wk"):
        jp["blocks"]["attn"][k] = 0.3 * jp["blocks"]["attn"][k]
    tp = params_from_jax(jp, config=jcfg)
    tm = TransformerLM(dataclasses.replace(get_smoke(ARCH), dtype=tdt,
                                           cache_dtype=tdt, **over))
    return _Compiled(jm), jp, tm, tp


def _embeds(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.fixture(scope="module")
def qwen_pair():
    return _pair()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_over_three_streams_matches_reference(dtype):
    jm, jp, tm, tp = _pair(dtype)
    tol = DTYPES[dtype][2]
    B, S = 2, 24
    e = _embeds(B, S, tm.cfg.d_model, seed=1)
    pos = _positions3(B, S, seed=2)
    ref, _ = jm.forward(jp, {"embeds": jnp.asarray(e),
                             "positions": jnp.asarray(pos)})
    got, aux = tm.forward(tp, {"embeds": torch.from_numpy(e),
                               "positions": torch.from_numpy(pos)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    assert scale_err(_np(got), ref) <= tol
    # the positions matter: the text-only default gives other logits
    text, _ = tm.forward(tp, {"embeds": torch.from_numpy(e)})
    assert float((text - got).abs().max()) > 1e-3


def test_loss_over_three_streams_matches_reference(qwen_pair):
    jm, jp, tm, tp = qwen_pair
    B, S = 2, 24
    e = _embeds(B, S, tm.cfg.d_model, seed=3)
    pos = _positions3(B, S, seed=4)
    labels = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, (B, S))
    jb = {"embeds": jnp.asarray(e), "positions": jnp.asarray(pos),
          "labels": jnp.asarray(labels.astype(np.int32))}
    tb = {"embeds": torch.from_numpy(e), "positions": torch.from_numpy(pos),
          "labels": torch.from_numpy(labels)}
    ref = float(jm.loss_fn(jp, jb))
    assert abs(float(tm.loss_fn(tp, tb)) - ref) <= 1e-5 * abs(ref)


def test_prefill_and_decode_match_reference(qwen_pair):
    """prefill(16) at three-stream positions into a cache of 20, then
    decode steps 16..19 (embeddings of the greedy tokens, the text-only
    positions at the step's index, as the reference decodes): logits at
    each step and both cache leaves."""
    jm, jp, tm, tp = qwen_pair
    B, P, T = 2, 16, 20
    e = _embeds(B, P, tm.cfg.d_model, seed=6)
    pos = _positions3(B, P, seed=7)
    jlg, jcache = jm.prefill(jp, {"embeds": jnp.asarray(e),
                                  "positions": jnp.asarray(pos)},
                             jm.init_cache(B, T))
    lg, cache = tm.prefill(tp, {"embeds": torch.from_numpy(e),
                                "positions": torch.from_numpy(pos)},
                           tm.init_cache(B, T))
    assert scale_err(_np(lg), jlg) <= 1e-5
    emb = np.asarray(jp["embed"])
    for i in range(P, T):
        tok = np.asarray(jnp.argmax(jlg[:, -1], axis=-1))
        assert np.array_equal(tok, torch.argmax(lg[:, -1], -1).numpy())
        step = emb[tok][:, None, :]
        jlg, jcache = jm.decode_step(jp, jnp.asarray(step), jcache, i)
        lg, cache = tm.decode_step(tp, torch.from_numpy(step), cache, i)
        assert scale_err(_np(lg), jlg) <= 1e-5, i
    for k in ("k", "v"):
        assert scale_err(_np(cache["blocks"][k]), jcache["blocks"][k]) <= 1e-5


def test_decode_matches_forward_token_by_token(qwen_pair):
    """On text-only positions, prefill(12) + decode steps to 16 give the
    forward's logits at each position, as in the reference."""
    _, _, tm, tp = qwen_pair
    B, S, k = 2, 16, 12
    e = torch.from_numpy(_embeds(B, S, tm.cfg.d_model, seed=8))
    fw, _ = tm.forward(tp, {"embeds": e})
    lg, cache = tm.prefill(tp, {"embeds": e[:, :k]}, tm.init_cache(B, S))
    assert scale_err(_np(lg[:, 0]), _np(fw[:, k - 1])) <= 1e-5
    for i in range(k, S):
        lg, cache = tm.decode_step(tp, e[:, i:i + 1], cache, i)
        assert scale_err(_np(lg[:, 0]), _np(fw[:, i])) <= 1e-5, i


def test_flash_route_matches_the_plain_attention(qwen_pair):
    """``use_flash=True`` on CPU tensors takes the kernel's plain version
    (GQA 3:1, causal) and gives the plain attention's logits."""
    _, _, tm, tp = qwen_pair
    e = torch.from_numpy(_embeds(2, 24, tm.cfg.d_model, seed=9))
    pos = torch.from_numpy(_positions3(2, 24, seed=10))
    flash = TransformerLM(dataclasses.replace(tm.cfg, use_flash=True))
    plain = TransformerLM(dataclasses.replace(tm.cfg, use_flash=False))
    a, _ = flash.forward(tp, {"embeds": e, "positions": pos})
    b, _ = plain.forward(tp, {"embeds": e, "positions": pos})
    assert scale_err(_np(a), _np(b)) <= 1e-5


# ------------------------------------------------------------ configs
def test_qwen2_vl_configs_are_the_reference():
    """``full()`` and ``smoke()`` field for field the reference's; the
    param tree's shapes are the reference's (tied: no ``lm_head``)."""
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get(ARCH), j_get(ARCH)
        for f in dataclasses.fields(jcfg):
            if f.name not in ("dtype", "cache_dtype"):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
        assert cfg.attn_config().mrope_sections == cfg.mrope_sections
    jdefs = j_build_model(j_get_smoke(ARCH)).param_defs()
    tdefs = TransformerLM(get_smoke(ARCH)).param_defs()
    shapes = lambda tree, pre="": {
        pre + k: v for kk, vv in tree.items() for k, v in (
            shapes(vv, pre + kk + "/").items() if isinstance(vv, dict)
            else [(kk, tuple(vv.shape))])}
    assert shapes(tdefs) == shapes(jdefs)
    assert "lm_head" not in tdefs


def test_param_count_is_the_reference():
    got = get_config(ARCH).param_count()
    assert got == tuple(j_get_config(ARCH).param_count())
    assert got[0] == got[1] == 1_543_569_408


# ------------------------------------------------------------ drivers
def test_launch_serve_lm_smoke(capsys):
    """``launch.serve --mode lm --arch qwen2-vl-2b --smoke``: an
    embeddings prompt, decode steps on the chosen tokens' embeddings."""
    t_serve.main(["--mode", "lm", "--arch", ARCH, "--smoke", "--device",
                  "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen2-vl-smoke prefill 16 toks x2" in out
    assert "sample token ids:" in out
