"""Chunked RWKV6 WKV recurrence.

Per (batch, head), with state S [hd, hd] carried across chunks of C
tokens, L the inclusive cumulative sum of logw along time and
Lprev = L - logw:

    A[t,s] = sum_i r[t,i] k[s,i] exp(Lprev[t,i] - L[s,i])   (s < t only)
    y      = A v + diag(r u k^T) v + (r * exp(Lprev)) S
    S     <- exp(Ltot) * S + (k * exp(Ltot - L))^T v

Every exponent is <= 0, so no term overflows (the factored form
exp(Lprev) * exp(-L) would: L reaches -512 within a chunk).
``rwkv6_wkv`` launches the hand-written Hopper kernel
(``csrc/rwkv6_wkv.cu``: one block per (b, h, chunk), the blocks of a
(b, h) in a thread-block cluster that passes the state chain
S_c = exp(Ltot_c) S_{c-1} + (k exp(Ltot - L))^T v through distributed
shared memory; the three products as three TF32 tensor-core products);
``rwkv6_wkv_plain`` is the same function in plain PyTorch with float32
accumulation, for CPU tensors and the card-side checks.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["rwkv6_wkv", "rwkv6_wkv_plain", "HEAD_DIMS", "CHUNKS"]

#: head dims and chunk lengths the kernel is built for
HEAD_DIMS = (16, 32, 64)
CHUNKS = (16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by :func:`rwkv6_wkv` in this process
launches = 0


def rwkv6_wkv_plain(r, k, v, logw, u, S0, *, chunk: int = 64):
    """r/k/v/logw [B,T,H,hd] (any float dtype); u [H,hd]; S0 [B,H,hd,hd].
    Returns (y [B,T,H,hd], S_T [B,H,hd,hd]), both float32. Raises unless
    ``chunk`` divides T."""
    B, T, H, hd = r.shape
    if T % chunk:
        raise ValueError(f"T={T} must be divisible by chunk={chunk}")
    u = u.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=r.device), diagonal=-1)[:, :, None, None]
    S = S0.float()
    ys = []
    for c0 in range(0, T, chunk):
        rc, kc, vc, lwc = (a[:, c0:c0 + chunk].float()
                           for a in (r, k, v, logw))      # [B,C,H,hd]
        L = torch.cumsum(lwc, dim=1)                       # inclusive
        Lprev = L - lwc
        Ltot = L[:, -1]                                    # [B,H,hd]
        D = torch.where(tri, Lprev[:, :, None] - L[:, None, :], -torch.inf)
        A = (rc[:, :, None] * kc[:, None] * torch.exp(D)).sum(-1)  # [B,C,C,H]
        diag = (rc * u * kc).sum(-1)                       # [B,C,H]
        y = torch.einsum("btsh,bshj->bthj", A, vc) + diag[..., None] * vc
        y = y + torch.einsum("bthi,bhij->bthj", rc * torch.exp(Lprev), S)
        k_dec = kc * torch.exp(Ltot[:, None] - L)
        S = torch.exp(Ltot)[..., None] * S \
            + torch.einsum("bthi,bthj->bhij", k_dec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def rwkv6_wkv(r, k, v, logw, u, S0, *, chunk: int = 64):
    """The Hopper kernel: same contract as :func:`rwkv6_wkv_plain`, on
    contiguous CUDA tensors: r, k, v of one dtype (float32 or bfloat16),
    logw float32 or bfloat16, u and S0 float32; hd in ``HEAD_DIMS`` and
    chunk in ``CHUNKS`` dividing T. Anything else raises."""
    global launches
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv takes CUDA tensors, got {r.device}")
    for name, t in (("k", k), ("v", v), ("logw", logw), ("u", u), ("S0", S0)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share float32 or bfloat16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype not in _DTYPE_CODES:
        raise TypeError(f"logw must be float32 or bfloat16, got {logw.dtype}")
    if u.dtype != torch.float32 or S0.dtype != torch.float32:
        raise TypeError(f"u and S0 must be float32, got {u.dtype}, {S0.dtype}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r/k/v/logw must share one [B,T,H,hd] shape: "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, hd = r.shape
    if tuple(u.shape) != (H, hd) or tuple(S0.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)} / S0 {tuple(S0.shape)} do not "
                         f"fit r {tuple(r.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} has no kernel instance; have {HEAD_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk {chunk} has no kernel instance; have {CHUNKS}")
    if T % chunk or T == 0:
        raise ValueError(f"T={T} must be a positive multiple of chunk={chunk}")
    if not all(t.is_contiguous() for t in (r, k, v, logw, u, S0)):
        raise ValueError("r, k, v, logw, u and S0 must be contiguous")
    if S0.data_ptr() % 16:  # the kernel reads S0 in 16-byte vectors
        S0 = S0.clone()
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    s_out = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    lib = _build.load("rwkv6_wkv")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), S0.data_ptr(), y.data_ptr(), s_out.data_ptr(), B, T, H,
        hd, chunk, _DTYPE_CODES[r.dtype], _DTYPE_CODES[logw.dtype], stream)
    _build.check(rc, "rwkv6_wkv")
    launches += 1
    return y, s_out
