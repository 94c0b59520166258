"""Attention variants: GQA/MQA/MHA self-attention with RoPE or Qwen2-VL's
M-RoPE and logit soft-capping, and DeepSeek's multi-head latent attention
(MLA), each with and without a cache.

``gqa_forward`` projects q/k/v, rotates q and k (RoPE, or M-RoPE over
three position streams [3, B, S]: with no ``positions`` given, the
text-only default gives all three streams the same positions), attends,
and projects back. Without a cache (the DiT's bidirectional blocks, the LM's
causal ``forward``) the attention goes through
``kernels.ops.flash_attention`` (the Hopper kernel on a CUDA tensor, its
plain version on a CPU tensor) or through ``_sdpa``, the plain PyTorch
attention of the reference: ``AttentionConfig.use_flash`` True or False
picks one, and None (the default) takes the kernel for CUDA tensors and
``_sdpa`` for CPU tensors. A soft-capped config always takes ``_sdpa``,
as in the reference. With a cache (prefill and decode) the new keys and
values are written into the preallocated cache in place and ``_sdpa``
attends over its valid positions.

``mla_forward`` compresses keys and values into a rank-``kv_lora_rank``
latent ``c_kv`` and one shared RoPE key ``k_rope``, and caches those. The
cache-free and prefill paths expand the latent to per-head keys and
values; a decode step (S = 1 with a cache) absorbs ``wk_b`` into the
query and ``wv_b`` into the output and attends in the latent space, in
float32. MLA calls no kernel, as in the reference: its q.k head dim
(nope + rope, 192 for DeepSeek-V3) is not one of flash's.

Cache layouts (per layer; stacked over layers by the caller):
    GQA : k, v           [B, S_max, K, hd]
    MLA : c_kv [B, S_max, kv_lora], k_rope [B, S_max, rope_dim]
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from ..kernels import ops as kops
from .common import (ParamDef, apply_mrope, apply_rope, is_dtensor,
                     promote_einsum, promote_matmul, replicated, rms_norm,
                     shard_heads_dim, whole_along)

__all__ = ["AttentionConfig", "MLAConfig", "attn_defs", "cache_shape",
           "gqa_forward", "mla_forward"]

NEG_INF = -2.0**30


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_type: str = "rope"  # "rope" | "mrope" | "none"
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    mla: MLAConfig | None = None
    attn_logit_softcap: float | None = None
    #: route the no-cache path through kernels.ops.flash_attention (True),
    #: through _sdpa (False), or by the tensors' device (None: the kernel
    #: for CUDA tensors)
    use_flash: bool | None = None


def attn_defs(cfg: AttentionConfig) -> dict:
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        return {
            "wq_a": ParamDef((cfg.d_model, m.q_lora_rank), ("embed", None),
                             "scaled"),
            "q_norm": ParamDef((m.q_lora_rank,), (None,), "zeros"),
            "wq_b": ParamDef((m.q_lora_rank, cfg.n_heads, qk),
                             (None, "heads", None), "scaled"),
            "wkv_a": ParamDef((cfg.d_model, m.kv_lora_rank + m.qk_rope_dim),
                              ("embed", None), "scaled"),
            "kv_norm": ParamDef((m.kv_lora_rank,), (None,), "zeros"),
            "wk_b": ParamDef((m.kv_lora_rank, cfg.n_heads, m.qk_nope_dim),
                             (None, "heads", None), "scaled"),
            "wv_b": ParamDef((m.kv_lora_rank, cfg.n_heads, m.v_dim),
                             (None, "heads", None), "scaled"),
            "wo": ParamDef((cfg.n_heads, m.v_dim, cfg.d_model),
                           ("heads", None, "embed"), "scaled"),
        }
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None), "scaled"),
        "wk": ParamDef((d, K, hd), ("embed", "kv_heads", None), "scaled"),
        "wv": ParamDef((d, K, hd), ("embed", "kv_heads", None), "scaled"),
        "wo": ParamDef((H, hd, d), ("heads", None, "embed"), "scaled"),
    }


def cache_shape(cfg: AttentionConfig, batch: int, s_max: int,
                dtype=torch.bfloat16) -> dict:
    """One layer's cache, ``{name: (shape, dtype)}`` (the caller stacks
    the layers)."""
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": ((batch, s_max, m.kv_lora_rank), dtype),
                "k_rope": ((batch, s_max, m.qk_rope_dim), dtype)}
    shape = (batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _sdpa(q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None,
          softcap=None, q_chunk: int = 256):
    """q [B,S,H,hd]; k,v [B,T,K,hd]. Long sequences run q-chunked (live
    scores bounded to [B,H,q_chunk,T]), each chunk at its own offset;
    shorter ones in one block."""
    S = q.shape[1]
    if S > q_chunk and S % q_chunk == 0:
        return torch.cat([
            _sdpa_block(q[:, c:c + q_chunk], k, v, causal=causal,
                        q_offset=q_offset + c, kv_len=kv_len,
                        softcap=softcap)
            for c in range(0, S, q_chunk)], dim=1)
    return _sdpa_block(q, k, v, causal=causal, q_offset=q_offset,
                       kv_len=kv_len, softcap=softcap)


def _sdpa_block(q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None,
                softcap=None):
    """q [B,S,H,hd]; k,v [B,T,K,hd] (K divides H). Returns [B,S,H,hd_v].

    ``q_offset`` is the absolute position of q[0] for causal masking;
    ``kv_len`` the number of valid cache positions (positions >= kv_len
    are masked); ``softcap`` caps the logits at ``softcap * tanh(s /
    softcap)``."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = _grouped_heads(q, K).reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    w = _masked_softmax(scores, causal=causal, q_offset=q_offset,
                        kv_len=kv_len)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    # the groups merge back into H heads: a gradient sharded over heads
    # could not split into (K, G) again, so it comes back whole
    return whole_along(out.reshape(B, S, H, v.shape[-1]), 2).to(q.dtype)


def _grouped_heads(q, K: int):
    """q [B,S,H,hd], its heads about to split as (K, H/K): a DTensor whose
    heads are sharded over more parts than K divides is gathered along
    them first (the split cannot keep such a sharding; GSPMD reshards
    there too)."""
    if not is_dtensor(q):
        return q
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    parts = math.prod(mesh.size(i) for i, p in enumerate(q.placements)
                      if isinstance(p, Shard) and p.dim == 2)
    return q if K % parts == 0 else replicated(q, 2)


def _masked_softmax(scores, *, causal: bool, q_offset: int = 0,
                    kv_len=None):
    """Softmax over the last dim of ``scores`` [..., S, T] with the
    masked positions at ``NEG_INF``: causally, key t past query s's
    absolute position ``q_offset + s``; with ``kv_len``, keys at or past
    it."""
    S, T = scores.shape[-2:]
    tpos = torch.arange(T, device=scores.device)
    mask = None
    if causal:
        spos = torch.arange(S, device=scores.device) + q_offset
        mask = tpos[None, :] <= spos[:, None]  # [S, T]
    if kv_len is not None:
        valid = (tpos < kv_len)[None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    return torch.softmax(scores, dim=-1)


def _positions(seq: int, offset: int, device):
    """[1, seq] absolute positions from ``offset``."""
    return torch.arange(seq, device=device)[None, :] + offset


def _rope_q_or_k(cfg: AttentionConfig, x, positions):
    if cfg.rope_type == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope_type == "mrope":
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return x


# ---------------------------------------------------------------------------
# GQA forward (train / prefill / decode)
# ---------------------------------------------------------------------------


def gqa_forward(p: dict, cfg: AttentionConfig, x: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                cache: dict | None = None, cache_index: int | None = None,
                causal: bool | None = None):
    """x [B,S,d] -> ``(y [B,S,d], cache)``. Without a cache: full
    self-attention, causal per ``cfg`` unless ``causal`` overrides it.
    With one: k/v are written at ``cache_index .. cache_index + S`` of
    the cache in place, and the queries attend over its first
    ``cache_index + S`` positions (prefill S > 1, decode S = 1); the
    returned cache is the one given. ``positions``: [B or 1, S] (RoPE) or
    [3, B or 1, S] (M-RoPE); None: ``cache_index + arange(S)``, the same in
    all three M-RoPE streams. A bfloat16 stream times float32 weights
    projects in float32, as in the reference."""
    B, S, _ = x.shape
    causal = cfg.causal if causal is None else causal
    offset = 0 if cache_index is None else int(cache_index)
    q = promote_einsum("bsd,dhk->bshk", x, p["wq"])
    k = promote_einsum("bsd,dhk->bshk", x, p["wk"])
    v = promote_einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.rope_type != "none":
        if positions is None:
            positions = _positions(S, offset, x.device)
            if cfg.rope_type == "mrope":  # text only: one stream for all 3
                positions = positions[None].expand(3, *positions.shape)
        q = _rope_q_or_k(cfg, q, positions)
        k = _rope_q_or_k(cfg, k, positions)
    # head-parallel attention internals (Megatron layout); the S-sharded
    # residual stream is gathered here and the heads take the SP axes
    q = shard_heads_dim(q)
    k = shard_heads_dim(k)
    v = shard_heads_dim(v)

    if cache is None:
        flash = q.is_cuda if cfg.use_flash is None else cfg.use_flash
        if flash and cfg.attn_logit_softcap is None:
            o = kops.flash_attention(
                q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), causal=causal)
            out = o.transpose(1, 2)
        else:
            out = _sdpa(q, k, v, causal=causal,
                        softcap=cfg.attn_logit_softcap)
    else:
        cache["k"][:, offset:offset + S] = k.to(cache["k"].dtype)
        cache["v"][:, offset:offset + S] = v.to(cache["v"].dtype)
        out = _sdpa(q, cache["k"], cache["v"], causal=causal, q_offset=offset,
                    kv_len=offset + S, softcap=cfg.attn_logit_softcap)
    return promote_einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ---------------------------------------------------------------------------
# MLA forward
# ---------------------------------------------------------------------------


def mla_forward(p: dict, cfg: AttentionConfig, x: torch.Tensor, *,
                positions: torch.Tensor | None = None,
                cache: dict | None = None, cache_index: int | None = None,
                causal: bool | None = None, absorb: bool | None = None):
    """x [B,S,d] -> ``(y [B,S,d], cache)``: DeepSeek's multi-head latent
    attention. With a cache, ``c_kv`` and ``k_rope`` are written at
    ``cache_index .. cache_index + S`` in place and the queries attend
    over the first ``cache_index + S`` positions. ``absorb`` (None: True
    exactly for a decode step, S = 1 with a cache) attends in the latent
    space with ``wk_b``/``wv_b`` folded into the query and the output, in
    float32; otherwise the latent is expanded to per-head keys and
    values. Queries longer than 256 that 256 divides attend 256 at a
    time (live scores [B, H, 256, T]), each chunk checkpointed under
    autograd, as the reference's ``lax.map`` of ``jax.checkpoint``."""
    m = cfg.mla
    B, S, _ = x.shape
    if absorb is None:
        absorb = S == 1 and cache is not None
    causal = cfg.causal if causal is None else causal
    offset = 0 if cache_index is None else int(cache_index)
    if positions is None:
        positions = _positions(S, offset, x.device)
    r, nope = m.kv_lora_rank, m.qk_nope_dim

    q_lat = rms_norm(promote_matmul(x, p["wq_a"]), p["q_norm"])
    q = promote_einsum("bsr,rhk->bshk", q_lat, p["wq_b"])
    q = shard_heads_dim(q)  # head-parallel MLA attention
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = promote_matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :r], p["kv_norm"])                  # [B,S,r]
    k_rope = apply_rope(kv[..., None, r:], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        cache["c_kv"][:, offset:offset + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_rope"][:, offset:offset + S] = k_rope.to(
            cache["k_rope"].dtype)
        c_all, kr_all, kv_len = cache["c_kv"], cache["k_rope"], offset + S
    else:
        c_all, kr_all, kv_len = c_kv, k_rope, None
    scale = 1.0 / math.sqrt(nope + m.qk_rope_dim)

    if absorb:
        c32, kr32 = c_all.float(), kr_all.float()
        wk_b, wv_b = p["wk_b"].float(), p["wv_b"].float()

        def attend(qn, qr, off):
            q_c = torch.einsum("bshk,rhk->bshr", qn.float(), wk_b)
            s_c = torch.einsum("bshr,btr->bhst", q_c, c32)
            s_r = torch.einsum("bshk,btk->bhst", qr.float(), kr32)
            w = _masked_softmax((s_c + s_r) * scale, causal=causal,
                                q_offset=off, kv_len=kv_len)
            o_c = torch.einsum("bhst,btr->bshr", w, c32)
            return torch.einsum("bshr,rhv->bshv", o_c, wv_b).to(x.dtype)
    else:
        k_nope = promote_einsum("btr,rhk->bthk", c_all, p["wk_b"])
        v = promote_einsum("btr,rhv->bthv", c_all, p["wv_b"])
        k_nope = shard_heads_dim(k_nope)
        v = shard_heads_dim(v)
        k32 = torch.cat([k_nope.float(), kr_all[:, :, None, :].float().expand(
            *k_nope.shape[:3], m.qk_rope_dim)], dim=-1)
        v32 = v.float()

        def attend(qn, qr, off):
            q_full = torch.cat([qn, qr], dim=-1)
            scores = torch.einsum("bshk,bthk->bhst", q_full.float(),
                                  k32) * scale
            w = _masked_softmax(scores, causal=causal, q_offset=off,
                                kv_len=kv_len)
            return torch.einsum("bhst,bthv->bshv", w, v32).to(x.dtype)

    q_chunk = 256
    if S > q_chunk and S % q_chunk == 0:
        remat = torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *p.values()))
        outs = []
        for c in range(0, S, q_chunk):
            args = (q_nope[:, c:c + q_chunk], q_rope[:, c:c + q_chunk],
                    offset + c)
            outs.append(torch.utils.checkpoint.checkpoint(
                attend, *args, use_reentrant=False) if remat
                else attend(*args))
        out = torch.cat(outs, dim=1)
    else:
        out = attend(q_nope, q_rope, offset)
    return promote_einsum("bshv,hvd->bsd", out, p["wo"]), cache
