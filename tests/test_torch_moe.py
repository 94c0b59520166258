"""The port's MoE family against the JAX reference: ``moe_apply`` (top-k
routing, capacity drops, an exact tie at the k-th place, the shared
expert, the auxiliary loss and the gradients), ``mla_forward`` (the
chunked cache-free path, a prefill into the compressed cache, and decode
steps absorbed and expanded), and the two MoE configs' ``TransformerLM``
(dbrx-132b: every layer MoE; deepseek-v3-671b: MLA, a dense prefix, a
shared expert, MTP) at smoke width: ``forward``, ``loss_fn`` with and
without MTP, its gradients, ``prefill``, ``decode_step`` and the
reference's token-by-token decode consistency. Then ``param_count``, the
converter, the drivers (``launch.serve --mode lm``, ``launch.train``,
``launch.sample``) and the refusals.

Inputs are drawn with numpy from a seed; the reference's parameters come
across leaf by leaf (``params_from_jax`` for the models). The attention's
query and key projections (GQA's ``wq``/``wk``, MLA's ``wq_b``/``wk_b``)
are scaled by 0.3 after the reference's init, as in
``tests/test_torch_lm.py``: at the init the logits are far from unit
scale and a sharp softmax turns float32 rounding order into visible
differences. Tolerances, against the output's scale max(1, max|ref|):
1e-5 on a float32 stream (gradients: 1e-5 of each leaf's max |ref|);
1e-2 on the bfloat16 stream (the frameworks round bf16 at other places).
"""

import dataclasses
import math

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
from repro.models.attention import AttentionConfig as JAttentionConfig
from repro.models.attention import attn_defs as j_attn_defs
from repro.models.attention import mla_forward as j_mla_forward
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_defs as j_moe_defs
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.data import TokenTaskConfig, synthetic_lm_batch
from repro_torch.launch import sample as t_sample
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import MLAConfig, MoEConfig, TransformerLM
from repro_torch.models.attention import AttentionConfig, attn_defs, \
    mla_forward
from repro_torch.models.common import ParamDef
from repro_torch.models.moe import moe_apply, moe_defs, top_k_lower_first
from repro_torch.tree import paths_and_leaves, tree_map

MOE_ARCHS = ["dbrx-132b", "deepseek-v3-671b"]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}
QK_SCALE = 0.3


def scale_err(got, ref) -> float:
    """max |got - ref| over max(1, max|ref|)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _torch_tree(tree, defs):
    """The reference's numpy tree as torch tensors, shape-checked against
    the port's ``ParamDef`` tree (same keys)."""
    if isinstance(defs, ParamDef):
        a = np.asarray(tree, np.float32)
        assert a.shape == tuple(defs.shape)
        return torch.from_numpy(a.copy())
    assert set(tree) == set(defs)
    return {k: _torch_tree(tree[k], defs[k]) for k in defs}


def _leaf_errs(got: dict, ref: dict) -> dict:
    """max |got - ref| / max |ref| per leaf path."""
    got = dict(paths_and_leaves(got))
    ref = dict(paths_and_leaves(jax.tree.map(np.asarray, ref)))
    assert set(got) == set(ref)
    out = {}
    for k, r in ref.items():
        g = _np(got[k])
        assert g.shape == r.shape, k
        s = float(np.abs(r).max())
        e = float(np.abs(g - r).max())
        out[k] = e / s if s else (0.0 if e == 0 else math.inf)
    return out


def _j_init(defs, seed: int) -> dict:
    """The reference's ``init_params`` of ``defs`` from ``PRNGKey(seed)``,
    float32, compiled once (op by op it compiles every draw), as numpy."""
    return jax.device_get(jax.jit(lambda k: j_init_params(
        k, defs, jnp.float32))(jax.random.PRNGKey(seed)))


#: the reference's MoE and MLA layers, compiled (their configs static)
j_moe_apply_jit = jax.jit(j_moe_apply, static_argnums=1)
j_mla_jit = jax.jit(j_mla_forward, static_argnums=1,
                    static_argnames=("absorb",))


# ------------------------------------------------------------ moe_apply
def _moe_cfgs(arch: str, **over):
    jm = dataclasses.replace(j_get_smoke(arch).moe, **over)
    return jm, MoEConfig(**dataclasses.asdict(jm))


def _moe_case(arch, seed=0, B=2, S=32, **over):
    jcfg, tcfg = _moe_cfgs(arch, **over)
    d = j_get_smoke(arch).d_model
    jp = _j_init(j_moe_defs(d, jcfg), seed)
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)
    return jcfg, tcfg, jp, x


def test_top_k_takes_equal_values_lower_index_first():
    rng = np.random.default_rng(0)
    v = rng.integers(0, 4, (64, 16)).astype(np.float32)  # many ties
    jv, ji = jax.lax.top_k(jnp.asarray(v), 5)
    tv, ti = top_k_lower_first(torch.from_numpy(v), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch,over,dtype", [
    ("dbrx-132b", {}, "f32"),
    ("deepseek-v3-671b", {}, "f32"),                # the shared expert
    ("dbrx-132b", {"capacity_factor": 0.25}, "f32"),  # heavy drops
    ("deepseek-v3-671b", {"capacity_factor": 0.25}, "f32"),
    ("dbrx-132b", {}, "bf16"),
    ("deepseek-v3-671b", {}, "bf16"),
])
def test_moe_apply_matches_reference(arch, over, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg, tcfg, jp, x = _moe_case(arch, **over)
    tp = _torch_tree(jp, moe_defs(x.shape[-1], tcfg))
    ref, jaux = j_moe_apply_jit(jp, jcfg, jnp.asarray(x, jdt))
    out, aux = moe_apply(tp, tcfg, torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt and aux.dtype == torch.float32
    assert scale_err(_np(out), ref) <= tol
    assert abs(float(aux) - float(jaux)) <= 1e-6 * max(1.0, abs(float(jaux)))
    if over:  # the capacity really drops choices
        S, k, E = x.shape[1], tcfg.top_k, tcfg.n_experts
        assert max(1, int(S * k / E * tcfg.capacity_factor)) * E < S * k


def test_moe_apply_breaks_an_exact_tie_at_the_kth_place_like_the_reference():
    """Router columns 1 and 2 made equal: their probabilities are equal
    bit for bit in both packages, and wherever the pair straddles the
    k-th place the reference takes expert 1 (``lax.top_k``'s lower index
    first). Experts 1 and 2 have different weights, so the other choice
    would show in the output."""
    jcfg, tcfg, jp, x = _moe_case("dbrx-132b", seed=3)
    jp["router"] = np.array(jp["router"])
    jp["router"][:, 2] = jp["router"][:, 1]
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    rank = np.argsort(-np.asarray(probs), axis=-1, kind="stable")
    k = tcfg.top_k
    straddle = ((rank[..., k - 1] == 1) & (rank[..., k] == 2)).sum()
    assert straddle >= 1
    tp = _torch_tree(jp, moe_defs(x.shape[-1], tcfg))
    ref, _ = j_moe_apply_jit(jp, jcfg, jnp.asarray(x))
    out, _ = moe_apply(tp, tcfg, torch.from_numpy(x))
    assert scale_err(_np(out), ref) <= 1e-5


@pytest.mark.parametrize("arch,over", [
    ("dbrx-132b", {}), ("deepseek-v3-671b", {}),
    ("dbrx-132b", {"capacity_factor": 0.25})])
def test_moe_apply_gradients_match_reference(arch, over):
    """d(sum(out) + aux) through the gather, the experts, the gates and
    the router, for every parameter leaf and the input."""
    jcfg, tcfg, jp, x = _moe_case(arch, seed=1, **over)

    def jloss(p, xx):
        out, aux = j_moe_apply(p, jcfg, xx)
        return jnp.sum(out) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = tree_map(lambda t: t.requires_grad_(),
                  _torch_tree(jp, moe_defs(x.shape[-1], tcfg)))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = moe_apply(tp, tcfg, tx)
    (out.sum() + aux).backward()
    errs = _leaf_errs(tree_map(lambda t: t.grad, tp), jg)
    assert max(errs.values()) <= 1e-5, errs
    assert scale_err(_np(tx.grad), jgx) <= 1e-5


# ------------------------------------------------------------ mla_forward
def _mla_case(seed=0, dtype="f32"):
    """deepseek-v3's smoke attention in both packages, the reference's
    init with ``wq_b``/``wk_b`` x QK_SCALE, and the port's copy."""
    jcfg = j_get_smoke("deepseek-v3-671b")
    jacfg = JAttentionConfig(
        d_model=jcfg.d_model, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.hd,
        rope_theta=jcfg.rope_theta, mla=jcfg.mla)
    tacfg = AttentionConfig(
        d_model=jcfg.d_model, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.hd,
        rope_theta=jcfg.rope_theta,
        mla=MLAConfig(**dataclasses.asdict(jcfg.mla)))
    jp = _j_init(j_attn_defs(jacfg), seed)
    rng = np.random.default_rng(seed)
    # the zero-initialised norm weights off zero, so they are exercised
    for k in ("q_norm", "kv_norm"):
        jp[k] = 0.1 * rng.standard_normal(jp[k].shape).astype(np.float32)
    for k in ("wq_b", "wk_b"):
        jp[k] = jp[k] * np.float32(QK_SCALE)
    return jacfg, tacfg, jp, _torch_tree(jp, attn_defs(tacfg))


@pytest.mark.parametrize("S", [32, 512])
def test_mla_forward_without_cache_matches_reference(S):
    """S 512 takes the 256-query chunks, each at its own causal offset."""
    jacfg, tacfg, jp, tp = _mla_case()
    x = np.random.default_rng(5).standard_normal(
        (2, S, jacfg.d_model)).astype(np.float32)
    ref, _ = j_mla_jit(jp, jacfg, jnp.asarray(x))
    out, cache = mla_forward(tp, tacfg, torch.from_numpy(x))
    assert cache is None
    assert scale_err(_np(out), ref) <= 1e-5


def test_mla_chunks_are_checkpointed_under_autograd():
    """Gradients through the chunked path (each 256-query chunk
    checkpointed and recomputed in the backward) against ``jax.grad`` of
    the reference's (``lax.map`` of ``jax.checkpoint``)."""
    jacfg, tacfg, jp, tp = _mla_case(seed=2)
    x = np.random.default_rng(6).standard_normal(
        (1, 512, jacfg.d_model)).astype(np.float32)

    def jloss(p):
        y, _ = j_mla_forward(p, jacfg, jnp.asarray(x))
        return jnp.sum(y * y)

    jg = jax.jit(jax.grad(jloss))(jp)
    for t in tp.values():
        t.requires_grad_()
    y, _ = mla_forward(tp, tacfg, torch.from_numpy(x))
    (y * y).sum().backward()
    errs = _leaf_errs(tree_map(lambda t: t.grad, tp), jg)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("absorb", [True, False, None])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_prefill_then_decode_matches_reference(absorb, dtype):
    """A prefill of 12 into a cache of 16, then four decode steps with
    the latent absorbed (True), expanded (False) or the default (None:
    absorbed for S = 1); outputs and both cache leaves at every step."""
    jdt, tdt, tol = DTYPES[dtype]
    jacfg, tacfg, jp, tp = _mla_case(seed=1)
    B, P, T = 2, 12, 16
    x = np.random.default_rng(7).standard_normal(
        (B, T, jacfg.d_model)).astype(np.float32)
    m = jacfg.mla
    jcache = {"c_kv": jnp.zeros((B, T, m.kv_lora_rank), jdt),
              "k_rope": jnp.zeros((B, T, m.qk_rope_dim), jdt)}
    cache = {"c_kv": torch.zeros((B, T, m.kv_lora_rank), dtype=tdt),
             "k_rope": torch.zeros((B, T, m.qk_rope_dim), dtype=tdt)}
    xs, txs = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    ref, jcache = j_mla_jit(jp, jacfg, xs[:, :P], cache=jcache,
                            cache_index=0)
    out, got = mla_forward(tp, tacfg, txs[:, :P], cache=cache, cache_index=0)
    assert got is cache
    assert scale_err(_np(out), ref) <= tol
    for i in range(P, T):
        ref, jcache = j_mla_jit(jp, jacfg, xs[:, i:i + 1], cache=jcache,
                                cache_index=i, absorb=absorb)
        out, cache = mla_forward(tp, tacfg, txs[:, i:i + 1], cache=cache,
                                 cache_index=i, absorb=absorb)
        assert scale_err(_np(out), ref) <= tol, i
        for k in ("c_kv", "k_rope"):
            assert cache[k].dtype == tdt
            assert scale_err(_np(cache[k]), jcache[k]) <= tol, (i, k)


# ------------------------------------------------------------ the models
def _temper(jp: dict, jcfg) -> dict:
    """The reference's init with the attention's query and key
    projections x QK_SCALE, in both stacks and in the MTP block."""
    names = ("wq_b", "wk_b") if jcfg.mla is not None else ("wq", "wk")
    blocks = [jp[k] for k in ("blocks", "moe_blocks") if k in jp]
    if "mtp" in jp:
        blocks.append(jp["mtp"]["block"])
    for b in blocks:
        for n in names:
            b["attn"][n] = b["attn"][n] * np.float32(QK_SCALE)
    return jp


class _Compiled:
    """A reference model's entry points, each compiled once (``jax.jit``)
    instead of dispatched op by op; ``grad`` is ``loss_fn``'s gradient."""

    def __init__(self, model):
        self.cfg = model.cfg
        self.init_cache = model.init_cache
        for name in ("forward", "loss_fn", "prefill", "decode_step",
                     "denoise"):
            setattr(self, name, jax.jit(getattr(model, name)))
        self.grad = jax.jit(jax.grad(model.loss_fn))


def _model_pair(arch, dtype="f32", **over):
    """(reference model (compiled), its tempered params, port model, the
    params converted by ``params_from_jax(config=)``)."""
    jdt, tdt, _ = DTYPES[dtype]
    jcfg = dataclasses.replace(j_get_smoke(arch), dtype=jdt, cache_dtype=jdt,
                               **over)
    jm = j_build_model(jcfg)
    jp = _temper(_j_init(jm.param_defs(), 0), jcfg)
    jm = _Compiled(jm)
    tp = params_from_jax(jp, config=jcfg)
    tm = TransformerLM(dataclasses.replace(
        get_smoke(arch), dtype=tdt, cache_dtype=tdt,
        **{k: (MoEConfig(**dataclasses.asdict(v)) if k == "moe" else v)
           for k, v in over.items()}))
    return jm, jp, tm, tp


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def lm_pair(request):
    arch = request.param
    jm, jp, tm, tp = _model_pair(arch)
    B, S = 2, 16
    b = synthetic_lm_batch(TokenTaskConfig(
        vocab_size=tm.cfg.vocab_size, seq_len=S), B, 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return {"arch": arch, "jm": jm, "jp": jp, "tm": tm, "tp": tp,
            "jb": jb, "tb": tb}


def test_forward_matches_reference(lm_pair):
    jm, jp, tm, tp = (lm_pair[k] for k in ("jm", "jp", "tm", "tp"))
    ref, jaux = jm.forward(jp, {"tokens": lm_pair["jb"]["tokens"]})
    got, aux = tm.forward(tp, {"tokens": lm_pair["tb"]["tokens"]})
    assert scale_err(_np(got), ref) <= 1e-5
    assert float(jaux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)
    want = {"dbrx-132b": {"embed", "ln_f", "moe_blocks", "lm_head"},
            "deepseek-v3-671b": {"embed", "ln_f", "blocks", "moe_blocks",
                                 "lm_head", "mtp"}}[lm_pair["arch"]]
    assert set(tp) == want


@pytest.mark.parametrize("mtp", [True, False])
def test_loss_matches_reference(lm_pair, mtp):
    """The loss with the aux term, and with MTP's (deepseek) where the
    batch has ``labels2``."""
    jm, jp, tm, tp = (lm_pair[k] for k in ("jm", "jp", "tm", "tp"))
    keys = ("tokens", "labels") + (("labels2",) if mtp else ())
    jb = {k: lm_pair["jb"][k] for k in keys}
    tb = {k: lm_pair["tb"][k] for k in keys}
    ref = float(jm.loss_fn(jp, jb))
    got = float(tm.loss_fn(tp, tb))
    assert abs(got - ref) <= 1e-5 * abs(ref)
    if mtp and tm.cfg.mtp:
        assert abs(got - float(tm.loss_fn(
            tp, {k: tb[k] for k in ("tokens", "labels")}))) > 1e-3


def test_loss_gradients_match_reference(lm_pair):
    """Every leaf's gradient of the loss (with aux and MTP) against
    ``jax.grad``, under the config's remat off and on."""
    jm, jp, tm, tp = (lm_pair[k] for k in ("jm", "jp", "tm", "tp"))
    jg = jm.grad(jp, lm_pair["jb"])
    for remat in ("none", "full"):
        model = TransformerLM(dataclasses.replace(tm.cfg, remat=remat))
        _, grads = t_train.loss_and_grads(model, tp, lm_pair["tb"])
        errs = _leaf_errs(grads, jg)
        assert max(errs.values()) <= 1e-5, (remat, sorted(
            errs.items(), key=lambda kv: -kv[1])[:3])


def test_prefill_and_decode_match_reference(lm_pair):
    """prefill(12) into a cache of 16, then decode steps 12..15: logits
    and every cache leaf (both stacks; MLA's c_kv/k_rope) at each step."""
    jm, jp, tm, tp = (lm_pair[k] for k in ("jm", "jp", "tm", "tp"))
    toks = np.asarray(lm_pair["jb"]["tokens"])
    B, S, P = toks.shape[0], toks.shape[1], 12
    jlg, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :P])},
                             jm.init_cache(B, S))
    lg, cache = tm.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :P].astype(np.int64))}, tm.init_cache(B, S))
    assert scale_err(_np(lg), jlg) <= 1e-5
    want = {"dbrx-132b": {"moe_blocks"},
            "deepseek-v3-671b": {"blocks", "moe_blocks"}}[lm_pair["arch"]]
    assert set(cache) == want
    for i in range(P, S):
        jlg, jcache = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                     jcache, i)
        lg, cache = tm.decode_step(tp, torch.from_numpy(
            toks[:, i:i + 1].astype(np.int64)), cache, i)
        assert scale_err(_np(lg), jlg) <= 1e-5, i
    errs = _leaf_errs(cache, jcache)
    assert max(errs.values()) <= 1e-5, errs


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward_token_by_token(arch):
    """The reference's consistency check, drop-free (capacity_factor 8:
    forward routes 16 tokens a group, a decode step one): prefill(12) +
    decode steps to 16 against the forward's last logits, in both
    packages, and the port's against the reference's."""
    jcfg = j_get_smoke(arch)
    moe = dataclasses.replace(jcfg.moe, capacity_factor=8.0)
    jm, jp, tm, tp = _model_pair(arch, moe=moe)
    B, S, k = 2, 16, 12
    toks = _tokens(jcfg.vocab_size, B, S, seed=4)
    tt = torch.from_numpy(toks.astype(np.int64))
    jfw, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    fw, _ = tm.forward(tp, {"tokens": tt})
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :k])},
                           jm.init_cache(B, S))
    _, cache = tm.prefill(tp, {"tokens": tt[:, :k]}, tm.init_cache(B, S))
    for i in range(k, S):
        jlg, jcache = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]),
                                     jcache, i)
        lg, cache = tm.decode_step(tp, tt[:, i:i + 1], cache, i)
    assert scale_err(_np(fw[:, -1]), jfw[:, -1]) <= 1e-5
    assert scale_err(_np(lg[:, -1]), jlg[:, -1]) <= 1e-5
    assert scale_err(_np(lg[:, -1]), _np(fw[:, -1])) <= 1e-5
    assert scale_err(jlg[:, -1], jfw[:, -1]) <= 1e-5


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_stream_forward_matches_reference(arch):
    jm, jp, tm, tp = _model_pair(arch, "bf16")
    toks = _tokens(tm.cfg.vocab_size, 2, 16, seed=8)
    ref, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(
        toks.astype(np.int64))})
    assert scale_err(_np(got), ref) <= 1e-2
    assert abs(float(aux) - float(jaux)) <= 1e-2 * float(jaux)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_configs_are_the_reference(arch):
    """``full()`` and ``smoke()`` field for field the reference's (the
    nested MoE and MLA configs too), in the reference's order in
    ``ARCHS``; the param tree's shapes are the reference's."""
    assert [a for a in j_ARCHS if a in ARCHS] == list(ARCHS)
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        cfg, jcfg = get(arch), j_get(arch)
        for f in dataclasses.fields(jcfg):
            if f.name in ("dtype", "cache_dtype"):
                continue
            want = getattr(jcfg, f.name)
            got = getattr(cfg, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    f.name
            else:
                assert got == want, f.name
        assert cfg.dtype == cfg.cache_dtype == torch.bfloat16
    jdefs = j_build_model(j_get_smoke(arch)).param_defs()
    tdefs = TransformerLM(get_smoke(arch)).param_defs()
    shapes = lambda tree: {k: tuple(v.shape)
                           for k, v in paths_and_leaves(tree)}
    assert shapes(tdefs) == shapes(jdefs)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_is_the_reference(arch):
    got = get_config(arch).param_count()
    want = j_get_config(arch).param_count()
    assert got == tuple(want)
    if arch in MOE_ARCHS:
        assert got[1] < got[0]


# ------------------------------------------------------------ converter
def test_converter_round_trip(lm_pair):
    """params_from_jax by config and by model agree; a tree without
    ``blocks`` (dbrx) converts; the reference's prefilled cache
    ({blocks, moe_blocks} x {k, v} or {c_kv, k_rope}) is decoded by the
    port as the reference decodes it."""
    arch = lm_pair["arch"]
    jm, jp, tm, tp = (lm_pair[k] for k in ("jm", "jp", "tm", "tp"))
    for k, v in paths_and_leaves(params_from_jax(jp, tm)):
        assert torch.equal(v, dict(paths_and_leaves(tp))[k])
    toks = _tokens(tm.cfg.vocab_size, 2, 9, seed=2)
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])},
                           jm.init_cache(2, 9))
    cache = cache_from_jax(jax.device_get(jcache))
    leaf = {"dbrx-132b": ("k", "v"), "deepseek-v3-671b": ("c_kv", "k_rope")}
    assert set(next(iter(cache.values()))) == set(leaf[arch])
    jlg, _ = jm.decode_step(jp, jnp.asarray(toks[:, 8:]), jcache, 8)
    lg, _ = tm.decode_step(tp, torch.from_numpy(
        toks[:, 8:].astype(np.int64)), cache, 8)
    assert scale_err(_np(lg), jlg) <= 1e-5


# ------------------------------------------------------------ drivers
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_lm_smoke(arch, capsys):
    toks = t_serve.main(["--mode", "lm", "--arch", arch, "--smoke",
                         "--device", "cpu", "--batch", "2",
                         "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"arch={get_smoke(arch).name} prefill 16 toks x2" in out
    assert "sample token ids:" in out
    if toks is not None:
        assert tuple(toks.shape) == (2, 4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_train_smoke_takes_the_aux_and_mtp_terms(arch, tmp_path):
    """Three driver steps on the CPU: finite losses, and the first step's
    loss is ``loss_fn`` of the initial state on the first batch (aux and,
    for deepseek, MTP included: the batches carry ``labels2``)."""
    argv = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt", str(tmp_path),
            "--resume", "fresh"]
    state, hist = t_train.main(argv)
    losses = [h["loss"] for h in hist]
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    args = t_train.parse_args(argv)
    cfg = get_smoke(arch)
    model = TransformerLM(t_train.train_config(cfg))
    opt = t_train.make_optimizer(args.lr, args.steps)
    p0 = t_train.make_init_state(model, opt, torch.device("cpu"))()["params"]
    b0 = next(t_train.make_batches(cfg, 2, 32, torch.device("cpu")))
    assert "labels2" in b0
    with torch.no_grad():
        assert float(model.loss_fn(p0, b0)) == losses[0]
        _, aux = model.forward(p0, b0)
        plain = float(model.loss_fn(p0, {k: b0[k] for k in
                                         ("tokens", "labels")}))
    assert float(aux) > 0
    if cfg.mtp:
        assert losses[0] > plain + 1.0  # 0.3 x a cross entropy of ~6


def test_launch_train_resumes_bitwise_after_fail_at(tmp_path):
    """deepseek-v3's smoke config (MLA, dense prefix, MoE, MTP) killed by
    --fail-at and resumed: the uninterrupted run's loss stream."""
    base = ["--arch", "deepseek-v3-671b", "--smoke", "--steps", "6",
            "--batch", "2", "--seq", "32", "--device", "cpu",
            "--save-every", "2"]
    _, ref = t_train.main(base + ["--ckpt", str(tmp_path / "a")])
    from repro_torch.runtime import InjectedFailure
    with pytest.raises(InjectedFailure):
        t_train.main(base + ["--ckpt", str(tmp_path / "b"), "--fail-at",
                             "5"])
    _, hist = t_train.main(base + ["--ckpt", str(tmp_path / "b"),
                                   "--resume", "auto"])
    assert hist == ref[4:]


def test_launch_sample_over_a_moe_denoiser(capsys):
    """``launch.sample --arch dbrx-132b --smoke``: an SA solve over the
    MoE denoiser (finite), on the seeded init and on the contractive
    weights (adaLN drawn and damped in the MoE stack); ``--feature-cache``
    raises the reference's refusal of a MoE stack."""
    argv = ["--arch", "dbrx-132b", "--smoke", "--batch", "2", "--seq", "16",
            "--nfe", "6", "--device", "cpu", "--combine", "fused"]
    t_sample.main(argv)
    t_sample.main(argv + ["--weights", "tame"])
    out = capsys.readouterr().out
    assert out.count("arch=dbrx-smoke") == 2
    assert out.count("finite=True") == 2
    assert "weights=tame" in out
    with pytest.raises(NotImplementedError, match="dense"):
        t_sample.main(argv + ["--feature-cache", "2"])


def test_denoise_matches_reference_and_cached_refuses_a_moe_stack():
    """The MoE denoiser (deepseek's: MLA, dense prefix, MoE) against the
    reference's ``denoise``; ``denoise_cached`` refuses it as the
    reference does."""
    jcfg = dataclasses.replace(j_get_smoke("deepseek-v3-671b"),
                               denoiser_latent=8, dtype=jnp.float32)
    jm = j_build_model(jcfg)
    jp = _j_init(jm.param_defs(), 0)
    jm = _Compiled(jm)
    rng = np.random.default_rng(3)
    jp["denoiser"]["out_proj"] = 0.05 * rng.standard_normal(
        jp["denoiser"]["out_proj"].shape).astype(np.float32)
    for key in ("blocks", "moe_blocks"):
        jp[key]["adaln"] = 0.01 * rng.standard_normal(
            jp[key]["adaln"].shape).astype(np.float32)
    tp = params_from_jax(jp, config=jcfg)
    tm = TransformerLM(dataclasses.replace(
        get_smoke("deepseek-v3-671b"), denoiser_latent=8,
        dtype=torch.float32))
    z = rng.standard_normal((2, 16, 8)).astype(np.float32)
    ref = jm.denoise(jp, jnp.asarray(z), 0.5)
    got = tm.denoise(tp, torch.from_numpy(z), 0.5)
    assert float(np.abs(np.asarray(ref)).max()) > 0.01
    assert scale_err(_np(got), ref) <= 1e-5
    with pytest.raises(NotImplementedError, match="dense"):
        tm.denoise_cached(tp, torch.from_numpy(z), 0.5,
                          feats=torch.zeros(2, 16, 128), refresh=True)
