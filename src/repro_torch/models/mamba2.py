"""Mamba2 (SSD) block and the Zamba2 hybrid (arXiv:2411.15242), after the
reference's ``models/mamba2.py``.

Mamba2 state-space recurrence, per head h with state h_state in R^{P x N}:

    a_t   = exp(dt_t * A_h)                      (A_h < 0, scalar per head)
    h_t   = a_t * h_{t-1} + dt_t * (x_t  B_t^T)  (outer product, P x N)
    y_t   = h_t C_t + D_h * x_t                  (contraction over N)

y_t reads the post-update state (the current token is included). Two
evaluation paths, as in the reference:

  - ``ssd_sequential``: the exact recurrence, one token at a time (decode,
    and any T that is not a multiple of the chunk above one chunk);
  - ``ssd_chunked``: chunks of C tokens (the SSD algorithm of the Mamba2
    paper): the per-head scalar decay makes the intra-chunk pairwise
    matrix [C, C], all of whose exponents are <= 0.

Both run in float32 in plain PyTorch: the reference computes them in jnp,
outside any Pallas kernel, so the port has no SSD kernel.

Zamba2 stacks Mamba2 blocks and applies ONE shared transformer block (full
attention and a gated GELU MLP over concat(hidden, initial embedding),
2 * d_model wide, projected back to d_model) after every
``shared_period`` Mamba blocks, with the same parameters each time; the
``n_layers mod shared_period`` Mamba blocks left over run after the last
application. The shared attention is causal in every mode, the
denoiser's included (as the reference's code computes it; its
docstring says otherwise). Without a cache it goes through
``kernels.ops.flash_attention`` on the card (``Zamba2Config.use_flash``,
as ``LMConfig.use_flash``): at zamba2-7b's widths that is head dim
2 * 3584 / 32 = 224.

Caches (``init_cache``): ``mamba`` {conv [L, B, K-1, conv_dim] in
``cache_dtype``, h [L, B, H, P, N] float32} and, for ``s_max > 0``,
``shared_kv`` {k, v [n_shared_apps, B, s_max, K, hd]}. ``prefill`` and
``decode_step`` write the new states and keys/values into the cache given,
in place, and return it; ``forward``, ``loss_fn`` and ``denoise`` run from
zero states and keep none. The layer loops are Python loops over the
stacked [L, ...] block parameters, unbound once per call (the reference
scans over them); ``remat="full"`` recomputes each Mamba block and each
shared application in the backward.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..tree import tree_leaves
from .attention import AttentionConfig, attn_defs, cache_shape, gqa_forward
from .common import (ParamDef, gathered, is_dtensor, layer_of, mlp_apply,
                     mlp_defs, promote_matmul, replicated, rms_norm,
                     shard_batch_dim,
                     softmax_cross_entropy, tree_defs_map, unstack,
                     whole_along)
from .transformer import timestep_embedding

__all__ = ["Mamba2Config", "Zamba2Config", "Zamba2", "ssd_sequential",
           "ssd_chunked", "mamba2_defs", "mamba2_apply",
           "mamba2_cache_shapes"]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_inner: int = 512        # expand * d_model
    head_dim: int = 64        # P
    n_groups: int = 1         # G (B, C shared per group)
    d_state: int = 64         # N
    conv_width: int = 4
    chunk_size: int = 32

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


# ---------------------------------------------------------------------------
# SSD recurrence
# ---------------------------------------------------------------------------


def ssd_sequential(x, dt, A, B, C, D, h0):
    """x [B,T,H,P]; dt [B,T,H]; A [H]; B,C [B,T,G,N]; D [H]; h0 [B,H,P,N]
    -> ``(y [B,T,H,P], h_T)``, float32."""
    rep = x.shape[2] // B.shape[2]
    x, dt = x.float(), dt.float()
    Bm = B.float().repeat_interleave(rep, dim=2)              # [B,T,H,N]
    Cm = C.float().repeat_interleave(rep, dim=2)
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = x[:, t], dt[:, t]                           # [B,H,P],[B,H]
        upd = dtt[..., None, None] * (xt[..., :, None] * Bm[:, t, :, None, :])
        h = torch.exp(dtt * A)[..., None, None] * h + upd      # [B,H,P,N]
        ys.append((h @ Cm[:, t, :, :, None])[..., 0] + D[None, :, None] * xt)
    return torch.stack(ys, dim=1), h


def _segsum(logd):
    """logd [..., C] -> pairwise sums S[t, s] = sum_{u=s+1..t} logd[u] for
    t >= s, -inf above the diagonal. The mask is made on logd's device (a
    copy from the host would fail inside a CUDA-graph capture)."""
    C = logd.shape[-1]
    cs = torch.cumsum(logd, dim=-1)
    S = cs[..., :, None] - cs[..., None, :]                   # [..., t, s]
    mask = torch.ones((C, C), dtype=torch.bool, device=logd.device).tril()
    return S.masked_fill(~mask, float("-inf"))


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient goes back in contiguous layout. DTensor
    (torch 2.13) hands back the gradient of a transposed bfloat16-to-
    float32 copy with a shard laid out heads-major while its global
    strides say row-major, and the view that merges (heads, head dim)
    back into the model dim then fails on the shard (zamba2-7b x
    train_4k on the (2, 16, 16) mesh)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clone(memory_format=torch.contiguous_format)


def ssd_chunked(x, dt, A, B, C, D, h0, chunk: int = 32):
    """Chunked SSD, the same function as :func:`ssd_sequential` (rounded
    in another order): the reference's per-chunk einsums as batched
    matrix products over (B, H, chunk), every chunk at once; only the
    state entering each chunk is carried from chunk to chunk (one decay
    and one add a chunk), so the [B, H, T/C, C, C] pairwise matrix of the
    whole sequence is live at once. Raises unless ``chunk`` divides T."""
    Bb, T, H, P = x.shape
    if T % chunk != 0:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    n, N, rep = T // chunk, B.shape[3], H // B.shape[2]
    if is_dtensor(x):
        x = _DenseGrad.apply(x)

    def heads(a, w):  # [B,T,H(,w)] -> [B,H,n,C(,w)], float32
        a = a.float().transpose(1, 2)
        return a.reshape(Bb, H, n, chunk, *((w,) if w else ()))

    xc = heads(x, P)
    dtc = heads(dt, 0)
    # B and C repeated over their group's heads; under DTensor the heads
    # dim gathered, and its gradient with it: a gradient split over the
    # heads cannot be viewed back as (groups, heads per group) where the
    # split does not divide the groups (zamba2-7b x train_4k on the
    # (2, 16, 16) mesh: 2 groups of 56 heads, 16 ways)
    Bc = heads(whole_along(B.repeat_interleave(rep, dim=2), 2), N)
    Cc = heads(whole_along(C.repeat_interleave(rep, dim=2), 2), N)
    logd = dtc * A[:, None, None]                             # <= 0
    Lcum = torch.cumsum(logd, dim=-1)                         # [B,H,n,C]
    Ltot = Lcum[..., -1]                                      # [B,H,n]
    xdt = xc * dtc[..., None]                                 # x_s dt_s
    # within each chunk
    seg = torch.exp(_segsum(logd))                            # [.., C, C]
    y = ((Cc @ Bc.transpose(-1, -2)) * seg) @ xdt             # [B,H,n,C,P]
    # each chunk's own contribution to the state at its end
    w_end = torch.exp(Ltot[..., None] - Lcum)
    dS = (xdt * w_end[..., None]).transpose(-1, -2) @ Bc      # [B,H,n,P,N]
    # the states entering the chunks, carried in order
    decay = torch.exp(Ltot)
    h = h0.float()
    entering = []
    for c in range(n):
        entering.append(h)
        h = decay[..., c, None, None] * h + dS[:, :, c]
    h_in = torch.stack(entering, dim=2)                       # [B,H,n,P,N]
    # read with the decay up to and including step t
    y = y + torch.exp(Lcum)[..., None] * (Cc @ h_in.transpose(-1, -2))
    y = y + D[:, None, None, None] * xc
    return y.reshape(Bb, H, T, P).transpose(1, 2), h


# ---------------------------------------------------------------------------
# Mamba2 block (functional)
# ---------------------------------------------------------------------------


def mamba2_defs(d_model: int, m: Mamba2Config) -> dict:
    di, G, N, H = m.d_inner, m.n_groups, m.d_state, m.n_heads
    conv_dim = di + 2 * G * N
    return {
        "in_proj": ParamDef((d_model, 2 * di + 2 * G * N + H),
                            ("embed", "ssm_heads"), "scaled"),
        "conv_w": ParamDef((m.conv_width, conv_dim), (None, "ssm_heads"),
                           "scaled", 0.5),
        "conv_b": ParamDef((conv_dim,), ("ssm_heads",), "zeros"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), "normal", 0.5),
        "A_log": ParamDef((H,), ("ssm_heads",), "normal", 0.5),
        "D": ParamDef((H,), ("ssm_heads",), "normal", 0.5),
        "norm": ParamDef((di,), ("ssm_heads",), "zeros"),
        "out_proj": ParamDef((di, d_model), ("ssm_heads", "embed"),
                             "scaled"),
    }


def _causal_conv(u, w, b, conv_state):
    """Depthwise causal conv in ``u``'s dtype, then SiLU. u [B,T,Cd]; w
    [K,Cd]; conv_state [B,K-1,Cd] (the K-1 inputs before u) ->
    ``(out [B,T,Cd], new state [B,K-1,Cd])``."""
    K, T = w.shape[0], u.shape[1]
    full = torch.cat([conv_state.to(u.dtype), u], dim=1)      # [B,T+K-1,Cd]
    out = full[:, :T] * w[0].to(u.dtype)
    for i in range(1, K):
        out = out + full[:, i:i + T] * w[i].to(u.dtype)
    # a copy, so that the state does not keep the whole input alive
    new_state = full[:, T:].clone() if K > 1 else conv_state
    return F.silu(out + b.to(u.dtype)), new_state


def mamba2_apply(p, m: Mamba2Config, x, cache=None, *, chunked: bool):
    """x [B,T,d] -> ``(out [B,T,d] in x's dtype, new cache)``. cache:
    {"conv": [B,K-1,conv_dim], "h": [B,H,P,N]}, or None for zero states.
    ``in_proj`` and the conv run in x's dtype, ``dt``, ``A`` and the SSD
    in float32, ``y * silu(z)`` (promoted to float32), its RMSNorm and
    ``out_proj`` in float32, cast back to x's dtype. The chunked SSD runs
    where ``chunked`` and T is a multiple of the chunk above one chunk;
    otherwise the sequential one."""
    Bb, T, _ = x.shape
    di, G, N, H, P = m.d_inner, m.n_groups, m.d_state, m.n_heads, m.head_dim
    if cache is None:
        cache = {"conv": x.new_zeros((Bb, m.conv_width - 1, di + 2 * G * N)),
                 "h": torch.zeros((Bb, H, P, N), dtype=torch.float32,
                                  device=x.device)}
    proj = x @ p["in_proj"].to(x.dtype)   # stays in the compute dtype
    z, xbc, dt = torch.split(proj, [di, di + 2 * G * N, H], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   cache["conv"])
    xs, Bv, Cv = torch.split(xbc, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(Bb, T, H, P)
    Bv = Bv.reshape(Bb, T, G, N)
    Cv = Cv.reshape(Bb, T, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())        # [B,T,H]
    A = -torch.exp(p["A_log"].float())                        # [H] < 0
    if chunked and T % m.chunk_size == 0 and T > m.chunk_size:
        y, h = ssd_chunked(xs, dt, A, Bv, Cv, p["D"], cache["h"],
                           m.chunk_size)
    else:
        y, h = ssd_sequential(xs, dt, A, Bv, Cv, p["D"], cache["h"])
    y = rms_norm(y.reshape(Bb, T, di) * F.silu(z), p["norm"])
    out = promote_matmul(y, p["out_proj"]).to(x.dtype)
    return out, {"conv": conv_state.to(cache["conv"].dtype), "h": h}


def mamba2_cache_shapes(m: Mamba2Config, batch: int,
                        dtype=torch.float32) -> dict:
    """One layer's Mamba2 state, ``{name: (shape, dtype)}``."""
    conv_dim = m.d_inner + 2 * m.n_groups * m.d_state
    return {"conv": ((batch, m.conv_width - 1, conv_dim), dtype),
            "h": ((batch, m.n_heads, m.head_dim, m.d_state), torch.float32)}


# ---------------------------------------------------------------------------
# Zamba2 hybrid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    name: str = "zamba2"
    n_layers: int = 8            # number of Mamba2 blocks
    d_model: int = 256
    n_heads: int = 8             # shared attention heads (over 2*d)
    n_kv_heads: int = 8
    d_ff: int = 1024             # shared block MLP
    vocab_size: int = 1024
    mamba: Mamba2Config = Mamba2Config()
    shared_period: int = 4       # apply the shared block every k blocks
    rope_theta: float = 10000.0
    #: "full" recomputes each Mamba block and each shared application in
    #: the backward (``torch.utils.checkpoint``); "none" saves everything
    remat: str = "none"
    #: residual-stream dtype
    dtype: torch.dtype = torch.bfloat16
    #: Mamba conv-state and shared KV-cache dtype
    cache_dtype: torch.dtype = torch.bfloat16
    #: latent width of the denoiser's continuous input/output heads;
    #: None: an LM
    denoiser_latent: int | None = None
    #: run the shared attention's cache-free path through the flash kernel
    #: (True), through the plain attention (False), or by the tensors'
    #: device (None: the kernel for CUDA tensors), as ``LMConfig``'s
    use_flash: bool | None = None

    @property
    def n_shared_apps(self) -> int:
        return self.n_layers // self.shared_period

    def shared_attn_config(self) -> AttentionConfig:
        d2 = 2 * self.d_model
        return AttentionConfig(
            d_model=d2, n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
            head_dim=d2 // self.n_heads, rope_theta=self.rope_theta,
            causal=True, use_flash=self.use_flash)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, analytic (the reference's
        formula)."""
        d, m = self.d_model, self.mamba
        di, G, N, H = m.d_inner, m.n_groups, m.d_state, m.n_heads
        per_mamba = d * (2 * di + 2 * G * N + H) \
            + m.conv_width * (di + 2 * G * N) + 3 * H + di + di * d
        d2 = 2 * d
        a = self.shared_attn_config()
        shared = d2 * a.n_heads * a.head_dim * 2 \
            + d2 * a.n_kv_heads * a.head_dim * 2 + 3 * d2 * self.d_ff \
            + d2 * d
        total = self.n_layers * per_mamba + shared + 2 * self.vocab_size * d
        return total, total


class Zamba2:
    def __init__(self, cfg: Zamba2Config):
        if cfg.remat not in ("none", "full"):
            raise ValueError(f"remat={cfg.remat!r}; expected 'none' or "
                             "'full'")
        self.cfg = cfg
        self.acfg = cfg.shared_attn_config()

    def param_defs(self) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        block = {"ln": ParamDef((d,), (None,), "zeros"),
                 "mamba": mamba2_defs(d, cfg.mamba)}
        out = {
            "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"),
                              "normal", 0.02),
            "blocks": tree_defs_map(
                lambda pd: ParamDef((cfg.n_layers,) + pd.shape,
                                    (None,) + pd.axes, pd.init, pd.scale),
                block),
            "shared": {
                "ln1": ParamDef((2 * d,), (None,), "zeros"),
                "attn": attn_defs(self.acfg),
                "ln2": ParamDef((2 * d,), (None,), "zeros"),
                "mlp": mlp_defs(2 * d, cfg.d_ff, gated=True),
                "out_proj": ParamDef((2 * d, d), (None, "embed"), "scaled",
                                     0.1),
            },
            "ln_f": ParamDef((d,), (None,), "zeros"),
            "lm_head": ParamDef((d, cfg.vocab_size), ("embed", "vocab"),
                                "scaled"),
        }
        dz = cfg.denoiser_latent
        if dz is not None:
            out["denoiser"] = {
                "in_proj": ParamDef((dz, d), (None, "embed"), "scaled"),
                "out_proj": ParamDef((d, dz), ("embed", None), "zeros"),
                "t_mlp1": ParamDef((256, d), (None, "embed"), "scaled"),
                "t_mlp2": ParamDef((d, d), ("embed", None), "scaled"),
            }
        return out

    # -- blocks ------------------------------------------------------------
    def _mamba_block(self, p, x, cache, chunked: bool):
        """x + Mamba2(rms_norm(x)) -> ``(x, new layer cache)``."""
        out, cache = mamba2_apply(p["mamba"], self.cfg.mamba,
                                  rms_norm(x, p["ln"]), cache,
                                  chunked=chunked)
        return x + out, cache

    def _shared_block(self, p, x, emb0, kv_cache, cache_index):
        """The shared transformer block over concat(x, emb0), projected
        back to d_model and added to x. With ``kv_cache`` (this
        application's {k, v}) the keys and values are written at
        ``cache_index`` in place."""
        h2 = torch.cat([x, emb0], dim=-1)
        a, _ = gqa_forward(p["attn"], self.acfg, rms_norm(h2, p["ln1"]),
                           cache=kv_cache, cache_index=cache_index)
        h2 = h2 + a.to(h2.dtype)
        m = mlp_apply(p["mlp"], rms_norm(h2, p["ln2"]), "gelu", gated=True)
        h2 = h2 + m.to(h2.dtype)
        return x + promote_matmul(h2, p["out_proj"]).to(x.dtype)

    def _apply(self, fn, p, *args):
        """``fn(gathered(p), *args)``, checkpointed under ``remat="full"``
        where autograd records it (the gather inside: made again in the
        backward)."""
        def run(p_, *a):
            return fn(gathered(p_), *a)
        if self.cfg.remat == "full" and torch.is_grad_enabled() and any(
                t.requires_grad for t in (*args, *tree_leaves(p))
                if isinstance(t, torch.Tensor)):
            return torch.utils.checkpoint.checkpoint(
                run, p, *args, use_reentrant=False)
        return run(p, *args)

    def _run(self, params, x, caches=None, *, chunked: bool,
             cache_index=None):
        """The hybrid stack over x: groups of ``shared_period`` Mamba
        blocks, each followed by the shared block (the reference's two
        scans: 13 groups of 6 for zamba2-7b), then the Mamba blocks left
        over. With ``caches`` each Mamba block starts from its state and
        writes the new one there, and each shared application writes its
        keys and values at ``cache_index``, in place; without, every state
        starts at zero and none is kept."""
        cfg = self.cfg
        emb0 = x
        period = cfg.shared_period
        n_main = cfg.n_shared_apps * period
        kv = None if caches is None else caches.get("shared_kv")
        mamba = functools.partial(self._mamba_block, cache=None,
                                  chunked=chunked)
        for l, p in enumerate(unstack(params["blocks"])):
            x = shard_batch_dim(x)  # pin batch at layer boundary
            if caches is None:
                x, _ = self._apply(mamba, p, x)
            else:
                lc = layer_of(caches["mamba"], l)
                x, new = self._mamba_block(p, x, lc, chunked)
                for k, v in new.items():
                    lc[k].copy_(v)
            if l < n_main and (l + 1) % period == 0:
                shared = functools.partial(
                    self._shared_block,
                    kv_cache=None if kv is None
                    else layer_of(kv, l // period),
                    cache_index=cache_index)
                x = self._apply(shared, params["shared"], x, emb0)
        return x, caches

    # -- public API --------------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int) -> dict:
        """``{"mamba": {conv, h: ((L, ...), dtype)}}``, with
        ``"shared_kv": {k, v: ((n_shared_apps, B, s_max, K, hd), dtype)}``
        for ``s_max > 0`` where the stack has a shared application."""
        cfg = self.cfg
        L = cfg.n_layers
        mc = mamba2_cache_shapes(cfg.mamba, batch, cfg.cache_dtype)
        out = {"mamba": {k: ((L,) + shape, dt)
                         for k, (shape, dt) in mc.items()}}
        if s_max > 0 and cfg.n_shared_apps > 0:
            kv = cache_shape(self.acfg, batch, s_max, cfg.cache_dtype)
            out["shared_kv"] = {k: ((cfg.n_shared_apps,) + shape, dt)
                                for k, (shape, dt) in kv.items()}
        return out

    def init_cache(self, batch: int, s_max: int, device=None) -> dict:
        """A zero cache of ``s_max`` positions on ``device``."""
        return {key: {k: torch.zeros(shape, dtype=dt, device=device)
                      for k, (shape, dt) in leaves.items()}
                for key, leaves in self.cache_shapes(batch, s_max).items()}

    def _embed(self, params, tokens):
        return F.embedding(tokens,
                           replicated(params["embed"], 0)).to(self.cfg.dtype)

    def _logits(self, params, x):
        return promote_matmul(rms_norm(x, params["ln_f"]),
                              params["lm_head"]).float()

    def forward(self, params, batch):
        """batch ``tokens`` [B, S] -> ``(logits [B, S, V] float32, aux)``
        from zero states, the shared attention without a cache; aux is a
        float32 zero."""
        x, _ = self._run(params, self._embed(params, batch["tokens"]),
                         chunked=True)
        return self._logits(params, x), x.new_zeros((), dtype=torch.float32)

    def loss_fn(self, params, batch):
        """Next-token loss against ``batch["labels"]``, the mean over
        ``batch.get("mask")``."""
        logits, _ = self.forward(params, batch)
        return softmax_cross_entropy(logits, batch["labels"],
                                     batch.get("mask"))

    def prefill(self, params, batch, cache):
        """The prompt ``batch["tokens"]`` [B, S] from ``cache``'s states,
        its keys and values written from position 0 -> ``(last logits
        [B, 1, V], cache)``, the cache updated in place."""
        x, cache = self._run(params, self._embed(params, batch["tokens"]),
                             cache, chunked=True, cache_index=0)
        return self._logits(params, x[:, -1:, :]), cache

    def decode_step(self, params, tokens, cache, index):
        """tokens [B, 1] at position ``index`` -> ``(logits [B, 1, V],
        cache)``, the cache updated in place."""
        x, cache = self._run(params, self._embed(params, tokens), cache,
                             chunked=False, cache_index=int(index))
        return self._logits(params, x), cache

    # -- denoiser mode (SA-Solver integration) -----------------------------
    def denoise(self, params, z, t):
        """z [B, S, dz], t scalar (or [B]) -> x0 prediction [B, S, dz]
        (float32). The stack runs forward and on the time-reversed
        sequence (whose initial embedding is reversed too), and the two
        are averaged; the shared attention stays causal in both, as the
        reference's code runs it."""
        cfg = self.cfg
        if cfg.denoiser_latent is None:
            raise ValueError(f"{cfg.name} is built as an LM; denoise needs "
                             "denoiser_latent set")
        dp = params["denoiser"]
        B = z.shape[0]
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=dp["t_mlp1"].device).expand(B)
        temb = timestep_embedding(t, 256)
        tcond = F.silu(temb @ dp["t_mlp1"].float()) @ dp["t_mlp2"].float()
        x = z.to(cfg.dtype) @ dp["in_proj"].to(cfg.dtype)
        x = x + tcond[:, None, :].to(cfg.dtype)
        h_f, _ = self._run(params, x, chunked=True)
        h_b, _ = self._run(params, torch.flip(x, dims=[1]), chunked=True)
        h = 0.5 * (h_f + torch.flip(h_b, dims=[1]))
        return (rms_norm(h, params["ln_f"])
                @ dp["out_proj"].to(h.dtype)).float()
