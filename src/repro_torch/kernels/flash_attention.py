"""Blocked online-softmax attention.

q [B,H,S,hd]; k, v [B,K,T,hd] with K dividing H (GQA: q-head h reads
kv-head h // (H/K)); causal or bidirectional; f32 softmax and
accumulation; output in q.dtype. ``flash_attention`` launches the
hand-written Hopper kernel (``csrc/flash_attention.cu``: one block per
(b, h, q-tile), a loop over k-tiles inside it, Q K^T as f32 FMA chains
on the CUDA cores (the plain version's own rounding), P V on the tensor
cores as three TF32 products per multiply-add, running max/sum and the
accumulator in registers, ragged T masked in the kernel).
``flash_attention_plain`` is the same function in plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS", "cost"]

#: head dims with a compiled kernel instance (dispatch in the .cu source)
HEAD_DIMS = (16, 32, 64, 72, 80, 96, 128, 224, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by :func:`flash_attention` in this process
launches = 0


def cost(B: int, H: int, K: int, S: int, T: int, hd: int, causal: bool,
         itemsize: int) -> tuple[int, int]:
    """``(flops, bytes)`` of one call: q and the output [B, H, S, hd]
    and k, v [B, K, T, hd] moved once; 2 hd flops for each score's q.k
    and 2 hd for its p.v, over the scores the call needs (causal: query
    s sees keys 0..s, the plain version's mask)."""
    if causal:
        per_head = sum(min(s + 1, T) for s in range(min(S, T))) \
            + max(S - T, 0) * T
    else:
        per_head = S * T
    flops = 4 * B * H * per_head * hd
    nbytes = itemsize * (2 * B * H * S * hd + 2 * B * K * T * hd)
    return flops, nbytes


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """q [B,H,S,hd]; k,v [B,K,T,hd] with K dividing H. f32 softmax."""
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qk = q.reshape(B, K, G, S, hd)
    scores = torch.einsum("bkgsd,bktd->bkgst", qk.float(),
                          k.float()) / math.sqrt(hd)
    if causal:
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        scores = scores.masked_fill(~mask, -2.0**30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return out.reshape(B, H, S, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True):
    """The Hopper kernel: same contract as :func:`flash_attention_plain`,
    contiguous CUDA tensors of one dtype (float32 or bfloat16) only."""
    global launches
    _build.refuse_autograd("flash_attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CUDA tensors, got {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, S, hd = q.shape
    K, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K < 1 or H % K:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instance; have {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, K, S,
        T, hd, int(causal), 1.0 / math.sqrt(hd), _DTYPE_CODES[q.dtype], stream)
    _build.check(rc, "flash_attention")
    launches += 1
    return out
