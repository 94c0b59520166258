"""The port's LM path against the JAX reference: the dense transformer
(starcoder2-3b's smoke config: GQA 3:1, RoPE, GELU, ungated) and RWKV6 as
an LM, with the reference's parameters carried across by
``repro_torch.convert.params_from_jax``: ``forward`` logits, ``loss_fn``,
``prefill`` logits and cache, prefill-then-decode against ``forward``
token by token, greedy tokens, a cache prefilled in one package and
decoded in the other, each transformer option (activation, gating, tied
embeddings, embedding scale, logit soft-capping, embedding input, RoPE
theta), the layers (RoPE, the cached attention, the chunked loss), the
WKV dispatch under ``use_kernel=None`` on a CUDA tensor (whole chunks
through the kernel's wrapper, the rest sequential) and M-RoPE, which an
earlier slice refused, against the reference.

Inputs are drawn with numpy from a seed. The transformer's ``wq``/``wk``
are scaled by 0.3 after the reference's init: at its own init the
attention logits have std ~30 at smoke width and a float32 forward is
~3e-5 from another float32 rounding order, in either package (as in
``tests/test_torch_train.py``). Tolerances, each against the output's
scale max(1, max|reference|): 1e-5 on a float32 stream and cache; 1e-2
on the reference's bfloat16 stream and cache (the two frameworks round
bf16 at other places: XLA may keep a fused elementwise chain in float32,
PyTorch rounds after each op).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as j_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.models import build_model as j_build_model
from repro.models import init_params as j_init_params
from repro.models.attention import _sdpa as j_sdpa
from repro.models.common import apply_rope as j_apply_rope
from repro.models.common import chunked_lm_loss as j_chunked_lm_loss
from repro.models.common import rope_frequencies as j_rope_frequencies
from repro.models.common import softmax_cross_entropy as j_xent
from repro.models.rwkv6 import wkv_sequential as j_wkv_sequential
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.models import RWKV6, TransformerLM
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models.attention import _sdpa
from repro_torch.models.common import (apply_rope, chunked_lm_loss,
                                       rope_frequencies,
                                       softmax_cross_entropy)

LM_ARCHS = ["starcoder2-3b", "rwkv6-3b"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def scale_err(got, ref) -> float:
    """max |got - ref| over max(1, max|ref|)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _pair(arch, dtype="f32", jcfg=None, **over):
    """(reference model, its params, port model, the params converted).
    ``over`` replaces config fields on both sides; ``jcfg`` replaces the
    reference config (the port's is converted from it)."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = j_get_smoke(arch) if jcfg is None else jcfg
    jcfg = dataclasses.replace(jcfg, dtype=jdt, **over)
    if hasattr(jcfg, "cache_dtype"):
        jcfg = dataclasses.replace(jcfg, cache_dtype=jdt)
    jm = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      jm.param_defs(), jnp.float32))
    if "attn" in jp["blocks"]:  # logits of unit scale (module docstring)
        for k in ("wq", "wk"):
            jp["blocks"]["attn"][k] = 0.3 * jp["blocks"]["attn"][k]
    if arch == "rwkv6-3b":
        tm = RWKV6(dataclasses.replace(get_smoke(arch), dtype=tdt, **over))
        tp = params_from_jax(jp)  # an RWKV6 LM tree, built from its shapes
        assert tm.param_defs().keys() == tp.keys()
    else:
        tp = params_from_jax(jp, config=jcfg)
        tm = TransformerLM(dataclasses.replace(
            _port_config(jcfg), dtype=tdt, cache_dtype=tdt))
    return jm, jp, tm, tp


def _port_config(jcfg):
    from repro_torch.convert import _dit_from_config
    return _dit_from_config(jcfg).cfg


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(tokens, **extra):
    j = {"tokens": jnp.asarray(tokens)}
    t = {"tokens": torch.from_numpy(tokens.astype(np.int64))}
    for k, v in extra.items():
        j[k] = jnp.asarray(v)
        t[k] = torch.from_numpy(v)
    return j, t


# ------------------------------------------------------------ configs
def test_starcoder2_3b_config_is_the_reference():
    assert "starcoder2-3b" in ARCHS
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get("starcoder2-3b"), j_get("starcoder2-3b")
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab_size", "act",
                  "gated_mlp", "rope_theta", "rope_type", "tie_embeddings",
                  "embed_scale", "attn_logit_softcap", "input_mode",
                  "remat", "denoiser_latent"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
        assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
    cfg = get_config("starcoder2-3b")
    n = sum(int(np.prod(d.shape)) for d in _leaves(
        TransformerLM(cfg).param_defs()))
    # the reference's analytic count leaves out the 2L + 1 norm vectors
    assert n == j_build_model(j_get_config("starcoder2-3b")).cfg \
        .param_count()[0] + 61 * 3072 == 3_180_518_400


@pytest.mark.parametrize("arch", ["starcoder2-15b", "granite-34b",
                                  "gemma-7b", "musicgen-large"])
def test_dense_zoo_configs_are_the_reference(arch):
    """The rest of the dense zoo: ``full()`` and ``smoke()`` field for
    field the reference's, in the reference's order in ``ARCHS``, on the
    port's bfloat16 stream and cache."""
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get(arch), j_get(arch)
        for f in dataclasses.fields(jcfg):
            if f.name not in ("dtype", "cache_dtype"):  # JAX dtypes
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
    order = [a for a in j_ARCHS if a in ARCHS]
    assert list(ARCHS) == order


def _leaves(defs):
    if isinstance(defs, dict):
        for v in defs.values():
            yield from _leaves(v)
    else:
        yield defs


def test_lm_config_defaults_are_the_reference():
    from repro.models import LMConfig as JLMConfig
    from repro_torch.models import LMConfig
    for f in ("act", "gated_mlp", "rope_type", "rope_theta",
              "mrope_sections", "tie_embeddings", "embed_scale",
              "attn_logit_softcap", "n_dense_layers", "mtp", "mtp_weight",
              "input_mode", "remat", "denoiser_latent", "denoiser_cond"):
        assert getattr(LMConfig(), f) == getattr(JLMConfig(), f), f
    assert LMConfig().cache_dtype == torch.bfloat16


# ------------------------------------------------------ forward / loss
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match_reference(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    tol = DTYPES[dtype][2]
    B, S = 2, 96  # RWKV6: chunk 64 does not divide 96 (the plain routing)
    toks = _tokens(tm.cfg, B, S, seed=1)
    labels = _tokens(tm.cfg, B, S, seed=2)
    mask = (np.random.default_rng(3).random((B, S)) > 0.3).astype(np.float32)
    jb, tb = _batch(toks, labels=labels, mask=mask)
    ref, jaux = jm.forward(jp, jb)
    got, aux = tm.forward(tp, tb)
    assert got.dtype == torch.float32 and got.shape == (B, S,
                                                         tm.cfg.vocab_size)
    assert float(aux) == float(jaux) == 0.0
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    assert scale_err(_np(got), ref) <= tol
    for b_j, b_t in ((jb, tb),
                     ({k: v for k, v in jb.items() if k != "mask"},
                      {k: v for k, v in tb.items() if k != "mask"})):
        loss_ref = float(jm.loss_fn(jp, b_j))
        loss = tm.loss_fn(tp, b_t)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        assert abs(float(loss) - loss_ref) <= tol * max(1.0, abs(loss_ref))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_takes_the_chunked_head_like_the_reference(arch, monkeypatch):
    """vocab >= 32,000 and S a multiple of 512 above 512: the transformer's
    loss goes through ``chunked_lm_loss`` (RWKV6 has no chunked head), in
    both packages to 1e-5."""
    over = {"vocab_size": 32000, "n_layers": 1}
    jm, jp, tm, tp = _pair(arch, "f32", **over)
    toks = _tokens(tm.cfg, 1, 1024, seed=4)
    labels = _tokens(tm.cfg, 1, 1024, seed=5)
    jb, tb = _batch(toks, labels=labels)
    from repro_torch.models import transformer as t_transformer
    calls = []
    real = t_transformer.chunked_lm_loss
    monkeypatch.setattr(t_transformer, "chunked_lm_loss",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    loss_ref = float(jm.loss_fn(jp, jb))
    loss = float(tm.loss_fn(tp, tb))
    assert calls == ([1] if arch == "starcoder2-3b" else [])
    assert abs(loss - loss_ref) <= 1e-5 * max(1.0, abs(loss_ref))


# --------------------------------------------------- prefill and decode
@pytest.mark.parametrize("arch,S", [("starcoder2-3b", 40),
                                    ("starcoder2-3b", 512),  # q-chunked
                                    ("rwkv6-3b", 32), ("rwkv6-3b", 128)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_matches_reference(arch, S, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    tol = DTYPES[dtype][2]
    B, s_max = 2, S + 8
    jb, tb = _batch(_tokens(tm.cfg, B, S, seed=S))
    ref, jcache = jm.prefill(jp, jb, jm.init_cache(B, s_max))
    cache = tm.init_cache(B, s_max)
    got, out = tm.prefill(tp, tb, cache)
    assert got.shape == (B, 1, tm.cfg.vocab_size)
    assert scale_err(_np(got), ref) <= tol
    jleaves = jax.tree_util.tree_flatten_with_path(jax.device_get(jcache))[0]
    for path, leaf in jleaves:
        t = out
        for k in path:
            t = t[k.key]
        assert t.dtype == cache_from_jax(leaf).dtype
        assert tuple(t.shape) == leaf.shape
        assert scale_err(_np(t), leaf) <= tol, path


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_forward_token_by_token(arch):
    """The reference's test of the same name, on the port, and each step's
    logits against the reference's decode: forward() over the whole
    sequence and prefill(k) + decode_step x (S - k) give the same last
    logits (float32 stream and cache)."""
    jm, jp, tm, tp = _pair(arch, "f32")
    B, S, k = 2, 16, 12
    toks = _tokens(tm.cfg, B, S, seed=7)
    _, tb = _batch(toks)
    fw, _ = tm.forward(tp, tb)
    cache = tm.init_cache(B, S)
    _, cache = tm.prefill(tp, {"tokens": tb["tokens"][:, :k]}, cache)
    jcache = jm.init_cache(B, S)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :k])}, jcache)
    for i in range(k, S):
        lg, cache = tm.decode_step(tp, tb["tokens"][:, i:i + 1], cache, i)
        jlg, jcache = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                     jcache, i)
        assert scale_err(_np(lg), jlg) <= 1e-5, i
    assert scale_err(_np(lg[:, -1]), _np(fw[:, -1])) <= 1e-5


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cache_crosses_packages(arch):
    """Prefill in the reference, carry its cache across with
    ``cache_from_jax`` and decode in the port: the reference's own decode
    logits, at float32 and at the bfloat16 cache (its bits carried
    exactly)."""
    for dtype in ("f32", "bf16"):
        jm, jp, tm, tp = _pair(arch, dtype)
        B, S = 2, 24
        toks = _tokens(tm.cfg, B, S + 1, seed=11)
        _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])},
                               jm.init_cache(B, S + 1))
        jcache = jax.device_get(jcache)
        cache = cache_from_jax(jcache)
        for path, leaf in jax.tree_util.tree_flatten_with_path(jcache)[0]:
            t = cache
            for k in path:
                t = t[k.key]
            np.testing.assert_array_equal(_np(t), np.asarray(leaf,
                                                             np.float32))
        jlg, _ = jm.decode_step(jp, jnp.asarray(toks[:, S:]), jcache, S)
        lg, _ = tm.decode_step(
            tp, torch.from_numpy(toks[:, S:].astype(np.int64)), cache, S)
        assert scale_err(_np(lg), jlg) <= DTYPES[dtype][2]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_greedy_tokens_match_reference(arch):
    """Greedy decode of 10 tokens after a prompt of 20, float32: the same
    token ids in both packages."""
    jm, jp, tm, tp = _pair(arch, "f32")
    B, S, n = 3, 20, 10
    toks = _tokens(tm.cfg, B, S, seed=13)
    jlg, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                             jm.init_cache(B, S + n))
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))}, tm.init_cache(B, S + n))
    jout, out = [], []
    for i in range(n):
        jtok = jnp.argmax(jlg[:, -1], axis=-1)[:, None]
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        jout.append(np.asarray(jtok))
        out.append(tok.numpy())
        jlg, jcache = jm.decode_step(jp, jtok, jcache, S + i)
        lg, cache = tm.decode_step(tp, tok, cache, S + i)
    np.testing.assert_array_equal(np.concatenate(out, 1),
                                  np.concatenate(jout, 1))


def test_prefill_writes_the_given_cache():
    """The transformer writes its KV cache in place and returns it: a
    caller that keeps the old object sees the prefilled cache, not an
    unchanged one. RWKV6 returns a new state and leaves the given one."""
    _, _, tm, tp = _pair("starcoder2-3b", "f32")
    cache = tm.init_cache(1, 8)
    _, out = tm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                        cache)
    assert out is cache
    assert bool(cache["blocks"]["k"][:, :, :4].abs().sum() > 0)
    assert int(torch.count_nonzero(cache["blocks"]["k"][:, :, 4:])) == 0
    _, _, rm, rp = _pair("rwkv6-3b", "f32")
    state = rm.init_cache(1)
    _, new = rm.prefill(rp, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                        state)
    assert int(torch.count_nonzero(state["S"])) == 0
    assert int(torch.count_nonzero(new["S"])) > 0


# ------------------------------------------------- transformer options
@pytest.mark.parametrize("over", [
    {"act": "silu"}, {"act": "relu"}, {"act": "relu2"},
    {"gated_mlp": True}, {"tie_embeddings": True}, {"embed_scale": True},
    {"attn_logit_softcap": 0.5}, {"rope_theta": 500.0},
    {"rope_type": "none"}], ids=lambda o: "-".join(f"{k}={v}"
                                                   for k, v in o.items()))
def test_transformer_option_matches_reference(over):
    """Each option on starcoder2-3b's smoke config: forward logits and a
    prefill + 3 decode steps against the reference, float32."""
    jm, jp, tm, tp = _pair("starcoder2-3b", "f32", **over)
    assert "lm_head" in tp or over.get("tie_embeddings")
    B, S = 2, 24
    toks = _tokens(tm.cfg, B, S + 3, seed=17)
    jb, tb = _batch(toks[:, :S])
    ref, _ = jm.forward(jp, jb)
    got, _ = tm.forward(tp, tb)
    assert scale_err(_np(got), ref) <= 1e-5
    _, jcache = jm.prefill(jp, jb, jm.init_cache(B, S + 3))
    _, cache = tm.prefill(tp, tb, tm.init_cache(B, S + 3))
    for i in range(S, S + 3):
        jlg, jcache = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                     jcache, i)
        lg, cache = tm.decode_step(
            tp, torch.from_numpy(toks[:, i:i + 1].astype(np.int64)), cache, i)
        assert scale_err(_np(lg), jlg) <= 1e-5


@pytest.mark.parametrize("arch", ["gemma-7b", "musicgen-large"])
def test_reference_zoo_configs_convert_and_match(arch):
    """Two more reference configs through ``params_from_jax(config=)``:
    gemma's tied, scaled embeddings with a gated GELU MLP, and musicgen's
    embedding input (``input_mode="embeds"``, no RoPE). Forward and
    prefill + decode logits within 1e-5 at float32."""
    jm, jp, tm, tp = _pair(arch, "f32", jcfg=j_get_smoke(arch))
    B, S = 2, 16
    cfg = tm.cfg
    if cfg.input_mode == "embeds":
        emb = np.random.default_rng(19).standard_normal(
            (B, S + 1, cfg.d_model)).astype(np.float32)
        jb, tb = {"embeds": jnp.asarray(emb[:, :S])}, \
            {"embeds": torch.from_numpy(emb[:, :S])}
        jstep, tstep = jnp.asarray(emb[:, S:]), torch.from_numpy(emb[:, S:])
    else:
        toks = _tokens(cfg, B, S + 1, seed=19)
        jb, tb = _batch(toks[:, :S])
        jstep = jnp.asarray(toks[:, S:])
        tstep = torch.from_numpy(toks[:, S:].astype(np.int64))
    ref, _ = jm.forward(jp, jb)
    got, _ = tm.forward(tp, tb)
    assert scale_err(_np(got), ref) <= 1e-5
    _, jcache = jm.prefill(jp, jb, jm.init_cache(B, S + 1))
    _, cache = tm.prefill(tp, tb, tm.init_cache(B, S + 1))
    jlg, _ = jm.decode_step(jp, jstep, jcache, S)
    lg, _ = tm.decode_step(tp, tstep, cache, S)
    assert scale_err(_np(lg), jlg) <= 1e-5


@pytest.mark.parametrize("arch,field", [("qwen2-vl-2b", "mrope")])
def test_unported_reference_configs_are_refused(arch, field):
    """The reference configs an earlier slice refused (qwen2-vl-2b's
    M-RoPE) are computed now: the converted config is the reference's
    field for field, and its smoke LM's forward over three position
    streams matches the reference's."""
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jnp.float32)
    cfg = _port_config(jcfg)
    assert cfg.rope_type == field
    for f in dataclasses.fields(jcfg):
        if f.name not in ("dtype", "cache_dtype"):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    jm = j_build_model(jcfg)
    jp = jax.device_get(j_init_params(jax.random.PRNGKey(0),
                                      jm.param_defs(), jnp.float32))
    for k in ("wq", "wk"):
        jp["blocks"]["attn"][k] = 0.3 * jp["blocks"]["attn"][k]
    tm = TransformerLM(dataclasses.replace(cfg, dtype=torch.float32))
    tp = params_from_jax(jp, config=jcfg)
    rng = np.random.default_rng(4)
    e = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.cumsum(rng.integers(0, 3, (3, 2, 12)), axis=-1).astype(np.int32)
    ref, _ = jm.forward(jp, {"embeds": jnp.asarray(e),
                             "positions": jnp.asarray(pos)})
    got, _ = tm.forward(tp, {"embeds": torch.from_numpy(e),
                             "positions": torch.from_numpy(pos)})
    assert scale_err(_np(got), ref) <= 1e-5


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_reference_configs_convert_field_for_field(arch):
    """The MoE family's reference configs (published and smoke) convert
    to the port's, every field equal, the nested MoE and MLA configs
    field for field."""
    for get in (j_get_config, j_get_smoke):
        jcfg = get(arch)
        cfg = _port_config(jcfg)
        for f in dataclasses.fields(jcfg):
            if f.name in ("dtype", "cache_dtype"):
                continue
            want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name


@pytest.mark.parametrize("field,value", [("rope_type", "mrope")])
def test_lm_refuses_what_the_port_does_not_compute(field, value):
    """What an earlier slice refused is computed now: starcoder2-3b's
    smoke LM with M-RoPE (sections (2, 3, 3) of its 8 frequencies) gives
    the reference's logits, at the text-only default positions and over
    three streams, and decodes a step as the reference does."""
    over = {field: value, "mrope_sections": (2, 3, 3)}
    jm, jp, tm, tp = _pair("starcoder2-3b", **over)
    assert tm.cfg.rope_type == "mrope" and tm.acfg.rope_type == "mrope"
    toks = _tokens(tm.cfg, 2, 12, seed=6)
    pos = np.cumsum(np.random.default_rng(7).integers(0, 3, (3, 2, 12)),
                    axis=-1).astype(np.int32)
    for extra in ({}, {"positions": pos}):
        jb, tb = _batch(toks, **extra)
        ref, _ = jm.forward(jp, jb)
        got, _ = tm.forward(tp, tb)
        assert scale_err(_np(got), ref) <= 1e-5
    jb, tb = _batch(toks[:, :11])
    _, jcache = jm.prefill(jp, jb, jm.init_cache(2, 12))
    _, cache = tm.prefill(tp, tb, tm.init_cache(2, 12))
    jlg, _ = jm.decode_step(jp, jnp.asarray(toks[:, 11:]), jcache, 11)
    lg, _ = tm.decode_step(tp, torch.from_numpy(
        toks[:, 11:].astype(np.int64)), cache, 11)
    assert scale_err(_np(lg), jlg) <= 1e-5


def test_lm_and_denoiser_modes_refuse_each_others_entry_points():
    """An LM tree has no denoiser heads and no adaLN weights, and an RWKV6
    LM refuses ``denoise``; a transformer in denoiser mode still runs the
    LM entry points over its token embedding and LM head, as the
    reference's does (its blocks' adaLN weights unused)."""
    tm = TransformerLM(get_smoke("starcoder2-3b"))
    assert "denoiser" not in tm.param_defs()
    assert "adaln" not in tm.param_defs()["blocks"]
    with pytest.raises(ValueError, match="LM"):
        RWKV6(get_smoke("rwkv6-3b")).denoise({}, torch.zeros(1, 4, 8), 0.5)
    jcfg = dataclasses.replace(j_get_smoke("starcoder2-3b"), denoiser_latent=8)
    jm, jp, dm, dp = _pair("starcoder2-3b", "f32", jcfg=jcfg)
    assert "adaln" in dp["blocks"]
    jb, tb = _batch(_tokens(dm.cfg, 2, 16, seed=37))
    ref, _ = jm.forward(jp, jb)
    got, _ = dm.forward(dp, tb)
    assert scale_err(_np(got), ref) <= 1e-5


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("theta", [10000.0, 999999.0])
def test_apply_rope_matches_reference(theta):
    np.testing.assert_array_equal(rope_frequencies(16, theta),
                                  j_rope_frequencies(16, theta))
    rng = np.random.default_rng(23)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = (np.arange(40)[None, :] + 1000).astype(np.int32)
    ref = np.asarray(j_apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert scale_err(got.numpy(), ref) <= 1e-5
    bf = apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                    theta)
    assert bf.dtype == torch.bfloat16


@pytest.mark.parametrize("S,T,q_offset,kv_len,softcap,causal", [
    (1, 48, 30, 31, None, True),      # one decode step into a cache
    (12, 48, 0, 12, None, True),      # a prefill into a longer cache
    (12, 48, 20, 32, 0.7, True),      # capped
    (16, 16, 0, None, 1.5, False),    # bidirectional, capped
    (512, 520, 0, 512, None, True),   # q-chunked at 256, offsets per chunk
])
def test_sdpa_matches_reference(S, T, q_offset, kv_len, softcap, causal):
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((2, S, 6, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, 2, 16)).astype(np.float32)
            for _ in range(2))
    ref = np.asarray(j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_offset=q_offset, kv_len=kv_len,
                            softcap=softcap))
    got = _sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                q_offset=q_offset, kv_len=kv_len, softcap=softcap)
    assert scale_err(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("S,masked", [(1024, True), (1024, False),
                                      (600, True)])
def test_chunked_lm_loss_matches_reference(S, masked):
    rng = np.random.default_rng(S)
    h = rng.standard_normal((2, S, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 700)) / 6).astype(np.float32)
    y = rng.integers(0, 700, (2, S)).astype(np.int32)
    m = (rng.random((2, S)) > 0.4).astype(np.float32) if masked else None
    ref = float(j_chunked_lm_loss(jnp.asarray(h), jnp.asarray(w),
                                  jnp.asarray(y),
                                  None if m is None else jnp.asarray(m)))
    got = chunked_lm_loss(torch.from_numpy(h), torch.from_numpy(w),
                          torch.from_numpy(y.astype(np.int64)),
                          None if m is None else torch.from_numpy(m))
    assert abs(float(got) - ref) <= 1e-5 * max(1.0, abs(ref))
    logits = rng.standard_normal((2, 5, 700)).astype(np.float32)
    ref = float(j_xent(jnp.asarray(logits), jnp.asarray(y[:, :5])))
    got = softmax_cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(y[:, :5].astype(np.int64)))
    assert abs(float(got) - ref) <= 1e-5 * max(1.0, abs(ref))


# ------------------------------------------------------------ WKV split
def _wkv_inputs(T, seed, B=2, H=2, hd=16):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((B, T, H, hd)) - 4.0),
                   -8.0, -1e-5).astype(np.float32)
    u = rng.standard_normal((H, hd)).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_wkv_whole_chunks_matches_sequential(T, monkeypatch):
    """The default route on a CUDA tensor (``use_kernel=None``): the whole
    chunks of T through ``ops.wkv`` (here its plain version: CPU tensors),
    the rest sequential from the state they leave; against the
    reference's ``wkv_sequential`` with a nonzero S0, within 1e-5."""
    arrs = _wkv_inputs(T, seed=T)
    calls = []
    real = ops.wkv
    monkeypatch.setattr(ops, "wkv", lambda *a, **kw: calls.append(
        a[0].shape[1]) or real(*a, **kw))
    y, S = t_rwkv6.wkv_whole_chunks(*map(torch.from_numpy, arrs), 64)
    y_ref, S_ref = j_wkv_sequential(*map(jnp.asarray, arrs))
    assert calls == ([] if T < 64 else [T - T % 64])
    assert y.shape == (2, T, 2, 16) and y.dtype == S.dtype == torch.float32
    assert scale_err(y.numpy(), y_ref) <= 1e-5
    assert scale_err(S.numpy(), S_ref) <= 1e-5


def test_time_mix_takes_whole_chunks_on_a_cuda_tensor(monkeypatch):
    """``use_kernel=None`` dispatches by the tensors' device: on a CUDA
    tensor ``wkv_whole_chunks`` (any T), on a CPU tensor the reference's
    plain routing. The device test is ``is_cuda``, faked here."""
    calls = []
    real = t_rwkv6.wkv_whole_chunks
    monkeypatch.setattr(t_rwkv6, "wkv_whole_chunks", lambda *a: calls.append(
        a[0].shape[1]) or real(*a))
    _, _, tm, tp = _pair("rwkv6-3b", "f32")
    toks = torch.from_numpy(_tokens(tm.cfg, 1, 200, seed=29).astype(np.int64))
    ref, _ = tm.forward(tp, {"tokens": toks})  # CPU: the plain routing
    assert calls == []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    got, _ = tm.forward(tp, {"tokens": toks})
    assert calls == [200] * tm.cfg.n_layers
    assert scale_err(got.numpy(), ref.numpy()) <= 1e-5


# -------------------------------------------------------- conversion
def test_params_from_jax_takes_lm_trees():
    jm, jp, tm, tp = _pair("rwkv6-3b", "f32")
    assert "denoiser" not in tp and tm.cfg.denoiser_latent is None
    # recognised from the tree (blocks/tm, no denoiser/) as an LM
    assert params_from_jax(jp)["lm_head"].shape == (128, 512)
    extra = dict(jp, stray=np.zeros(3))
    with pytest.raises(ValueError, match="stray"):
        params_from_jax(extra)
    jm, jp, tm, tp = _pair("starcoder2-3b", "f32", tie_embeddings=True)
    assert "lm_head" not in tp
    with pytest.raises(ValueError, match="config="):
        params_from_jax(jp)
