"""GQA/MQA/MHA self-attention with RoPE and logit soft-capping, with and
without a KV cache.

``gqa_forward`` projects q/k/v, rotates q and k (RoPE), attends, and
projects back. Without a cache (the DiT's bidirectional blocks, the LM's
causal ``forward``) the attention goes through
``kernels.ops.flash_attention`` (the Hopper kernel on a CUDA tensor, its
plain version on a CPU tensor) or through ``_sdpa``, the plain PyTorch
attention of the reference: ``AttentionConfig.use_flash`` True or False
picks one, and None (the default) takes the kernel for CUDA tensors and
``_sdpa`` for CPU tensors. A soft-capped config always takes ``_sdpa``,
as in the reference. With a cache (prefill and decode) the new keys and
values are written into the preallocated cache in place and ``_sdpa``
attends over its valid positions.

Cache layout (per layer; stacked over layers by the caller):
    k, v  [B, S_max, K, hd]
M-RoPE and DeepSeek's MLA come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import ops as kops
from .common import ParamDef, apply_rope, promote_einsum

__all__ = ["AttentionConfig", "attn_defs", "cache_shape", "gqa_forward"]

NEG_INF = -2.0**30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    rope_type: str = "rope"  # "rope" | "none" ("mrope" comes later)
    causal: bool = True
    attn_logit_softcap: float | None = None
    #: route the no-cache path through kernels.ops.flash_attention (True),
    #: through _sdpa (False), or by the tensors' device (None: the kernel
    #: for CUDA tensors)
    use_flash: bool | None = None

    def __post_init__(self):
        if self.rope_type not in ("rope", "none"):
            raise NotImplementedError(
                f"rope_type={self.rope_type!r}: the PyTorch port computes "
                "'rope' and 'none'; M-RoPE (qwen2-vl, mrope_sections) comes "
                "with a later slice")


def attn_defs(cfg: AttentionConfig) -> dict:
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
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    tpos = torch.arange(T, device=q.device)
    mask = None
    if causal:
        spos = torch.arange(S, device=q.device) + q_offset
        mask = tpos[None, :] <= spos[:, None]  # [S, T]
    if kv_len is not None:
        valid = (tpos < kv_len)[None, :]
        mask = valid if mask is None else mask & valid
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def _positions(seq: int, offset: int, device):
    """[1, seq] absolute positions from ``offset``."""
    return torch.arange(seq, device=device)[None, :] + offset


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
    returned cache is the one given. A bfloat16 stream times float32
    weights projects in float32, as in the reference."""
    B, S, _ = x.shape
    causal = cfg.causal if causal is None else causal
    offset = 0 if cache_index is None else int(cache_index)
    q = promote_einsum("bsd,dhk->bshk", x, p["wq"])
    k = promote_einsum("bsd,dhk->bshk", x, p["wk"])
    v = promote_einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.rope_type == "rope":
        if positions is None:
            positions = _positions(S, offset, x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

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
