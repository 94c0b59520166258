"""GQA/MQA/MHA self-attention, the no-cache path the DiT denoiser runs.

``gqa_forward`` projects q/k/v, attends, and projects back. The attention
itself goes through ``kernels.ops.flash_attention`` (the Hopper kernel on
a CUDA tensor, its plain version on a CPU tensor) or through ``_sdpa``,
the plain PyTorch attention of the reference: ``AttentionConfig.use_flash``
True or False picks one, and None (the default) takes the kernel for CUDA
tensors and ``_sdpa`` for CPU tensors. RoPE/M-RoPE, logit soft-capping, MLA
and the KV-cache decode path come with the LM-zoo slice of the port.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import ops as kops
from .common import ParamDef, promote_einsum

__all__ = ["AttentionConfig", "attn_defs", "gqa_forward"]

NEG_INF = -2.0**30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    #: route the no-cache path through kernels.ops.flash_attention (True),
    #: through _sdpa (False), or by the tensors' device (None: the kernel
    #: for CUDA tensors)
    use_flash: bool | None = None


def attn_defs(cfg: AttentionConfig) -> dict:
    H, K, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    return {
        "wq": ParamDef((d, H, hd), ("embed", "heads", None), "scaled"),
        "wk": ParamDef((d, K, hd), ("embed", "kv_heads", None), "scaled"),
        "wv": ParamDef((d, K, hd), ("embed", "kv_heads", None), "scaled"),
        "wo": ParamDef((H, hd, d), ("heads", None, "embed"), "scaled"),
    }


def _sdpa(q, k, v, *, causal: bool, q_chunk: int = 256):
    """q [B,S,H,hd]; k,v [B,T,K,hd]. Long sequences run q-chunked (live
    scores bounded to [B,H,q_chunk,T]); shorter ones in one block."""
    S = q.shape[1]
    if S > q_chunk and S % q_chunk == 0:
        return torch.cat([
            _sdpa_block(q[:, c:c + q_chunk], k, v, causal=causal, q_offset=c)
            for c in range(0, S, q_chunk)], dim=1)
    return _sdpa_block(q, k, v, causal=causal)


def _sdpa_block(q, k, v, *, causal: bool, q_offset: int = 0):
    """q [B,S,H,hd]; k,v [B,T,K,hd] (K divides H). Returns [B,S,H,hd_v].
    ``q_offset`` is the absolute position of q[0] for causal masking."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    if causal:
        tpos = torch.arange(T, device=q.device)
        spos = torch.arange(S, device=q.device) + q_offset
        scores = scores.masked_fill(~(tpos[None, :] <= spos[:, None]), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def gqa_forward(p: dict, cfg: AttentionConfig, x: torch.Tensor, *,
                causal: bool | None = None) -> torch.Tensor:
    """x [B,S,d] -> [B,S,d]: full self-attention, causal per ``cfg`` unless
    ``causal`` overrides it. A bfloat16 stream times float32 weights
    projects in float32, as in the reference."""
    causal = cfg.causal if causal is None else causal
    q = promote_einsum("bsd,dhk->bshk", x, p["wq"])
    k = promote_einsum("bsd,dhk->bshk", x, p["wk"])
    v = promote_einsum("bsd,dhk->bshk", x, p["wv"])
    flash = q.is_cuda if cfg.use_flash is None else cfg.use_flash
    if flash:
        o = kops.flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal)
        out = o.transpose(1, 2)
    else:
        out = _sdpa(q, k, v, causal=causal)
    return promote_einsum("bshk,hkd->bsd", out, p["wo"])
