"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with data-dependent
decay and token-shift ddlerp, also an SA-Solver denoiser backbone.

Time-mixing recurrence, per head with state S in R^{hd x hd}:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

where w_t = exp(-exp(w0 + lora(x-shifted))) in (0, 1) is the per-channel
data-dependent decay. Two equivalent evaluation paths:

  - ``wkv_sequential``: the exact recurrence, one token at a time (the
    oracle, decode, and the path for T not above one chunk);
  - ``wkv_chunked``: chunks of C tokens with intra-chunk pairwise
    log-decay differences, all exponents <= 0 (overflow-safe).

``RWKV6Config.use_kernel`` routes the chunked path through
``kernels.ops.wkv`` (the Hopper kernel on a CUDA tensor, its plain version
on a CPU tensor): True sends every chunked call there (the reference's
``use_pallas``: it raises for a T that chunks do not divide); False keeps
the reference's plain routing; None (the default) takes the kernel on
CUDA tensors for the whole chunks of T and finishes the ``T mod C``
tokens left with ``wkv_sequential`` from the kernel's state
(``wkv_whole_chunks``), so any T runs, and the plain routing on CPU
tensors.

LM entry points: ``forward``/``loss_fn`` over a zero state, ``prefill``
(the prompt through the chunked path) and ``decode_step`` (one token
through the recurrence) against the per-layer state cache
``{"S": [L, B, H, hd, hd], "tm_shift": [L, B, d], "cm_shift": [L, B, d]}``,
O(1) in the context length; both return a new cache. ``denoise`` runs the
causal stack forward and on the time-reversed sequence and averages the
two.

Training differentiates ``loss_fn`` through the plain WKV paths
(``use_kernel=False``: the kernel has no backward and refuses inputs that
require grad), the layers unbound once per call and, under
``remat="full"``, each recomputed in the backward.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..kernels import ops as kops
from ..kernels.rwkv6_scan import rwkv6_wkv_plain
from ..tree import tree_leaves
from .common import (ParamDef, gathered, is_dtensor, layer_norm, layer_of,
                     promote_einsum, promote_matmul, replicated,
                     shard_batch_dim,
                     softmax_cross_entropy, tree_defs_map, unstack,
                     whole_along)
from .transformer import timestep_embedding

__all__ = ["RWKV6Config", "RWKV6", "wkv_sequential", "wkv_chunked",
           "wkv_whole_chunks", "group_norm"]


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    name: str = "rwkv6"
    n_layers: int = 4
    d_model: int = 256
    head_dim: int = 64
    d_ff: int = 896
    vocab_size: int = 1024
    decay_lora: int = 64
    tshift_lora: int = 32
    chunk_size: int = 32
    #: the reference's rematerialisation policy: "full" recomputes each
    #: layer in the backward (``torch.utils.checkpoint``); any other value
    #: saves every activation, as the reference's scan does
    remat: str = "none"
    #: residual-stream dtype
    dtype: torch.dtype = torch.bfloat16
    #: run the chunked WKV through kernels.ops.wkv (the counterpart of the
    #: reference's ``use_pallas``): True, False, or None for the kernel on
    #: the whole chunks of CUDA tensors (``wkv_whole_chunks``) and the
    #: plain paths on CPU tensors
    use_kernel: bool | None = None
    #: latent width of the denoiser's continuous input/output heads
    denoiser_latent: int | None = None

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, analytic (the reference's
        formula)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        tm = 4 * d * d + d * self.decay_lora * 2 + d * (5 * self.tshift_lora) \
            + 5 * self.tshift_lora * d
        cm = d * f + f * d + d * d
        total = L * (tm + cm) + 2 * V * d
        return total, total


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------


def wkv_sequential(r, k, v, logw, u, S0):
    """Exact recurrence. r,k,v,logw: [B,T,H,hd]; u: [H,hd]; S0: [B,H,hd,hd].

    Returns (y [B,T,H,hd], S_T). All math f32.
    """
    r, k, v, logw, u = (a.float() for a in (r, k, v, logw, u))
    S = S0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B,H,hd,hd]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               S + u[..., :, None] * kv))
        S = torch.exp(logw[:, t])[..., :, None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv_chunked(r, k, v, logw, u, S0, chunk: int = 32):
    """Chunked evaluation, mathematically identical to ``wkv_sequential``:
    the plain version of the WKV kernel (``kernels/rwkv6_scan.py``)."""
    return rwkv6_wkv_plain(r, k, v, logw, u, S0, chunk=chunk)


def wkv_whole_chunks(r, k, v, logw, u, S0, chunk: int):
    """Any T: the whole chunks of T through ``kernels.ops.wkv`` (the
    kernel on a CUDA tensor, its plain version on a CPU tensor), then the
    ``T mod chunk`` tokens left through ``wkv_sequential`` from the state
    those chunks leave; T below one chunk runs ``wkv_sequential`` alone.
    The reference's function for every T, rounded in another order."""
    T = r.shape[1]
    n = T - T % chunk
    if n == 0:
        return wkv_sequential(r, k, v, logw, u, S0)
    if n == T:
        return kops.wkv(r, k, v, logw, u, S0, chunk=chunk)
    head = [a[:, :n].contiguous() for a in (r, k, v, logw)]
    y, S = kops.wkv(*head, u, S0, chunk=chunk)
    y_tail, S = wkv_sequential(r[:, n:], k[:, n:], v[:, n:], logw[:, n:],
                               u, S)
    return torch.cat([y, y_tail], dim=1), S


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


def _token_shift(x, shift_state):
    """sx_t = x_{t-1}; position 0 takes shift_state. x [B,T,d]."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def group_norm(x, gamma, beta, n_groups, eps=64e-5):
    """Per-head group norm over the flattened head dim. x [B,T,d]; the
    output stays float32."""
    B, T, d = x.shape
    xg = x.reshape(B, T, n_groups, d // n_groups).float()
    mu = torch.mean(xg, dim=-1, keepdim=True)
    var = torch.var(xg, dim=-1, keepdim=True, correction=0)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return xg.reshape(B, T, d) * gamma.float() + beta.float()


def _heads(x, H: int):
    """[B, T, H*hd] -> [B, T, H, hd]. A DTensor whose last dim is split
    over more parts than H divides (or holds pending sums) is gathered
    first: the split into heads cannot keep such a sharding (GSPMD
    reshards there too)."""
    B, T, _ = x.shape
    if is_dtensor(x):
        from torch.distributed.tensor import Partial, Shard
        parts = math.prod(
            x.device_mesh.size(i) for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == 2)
        if H % parts or any(isinstance(p, Partial) for p in x.placements):
            x = replicated(x, -1)
    return x.reshape(B, T, H, -1)


class RWKV6:
    def __init__(self, cfg: RWKV6Config):
        self.cfg = cfg

    # -- parameters ------------------------------------------------------
    def _layer_defs(self) -> dict:
        cfg = self.cfg
        d, ts, dl, f = cfg.d_model, cfg.tshift_lora, cfg.decay_lora, cfg.d_ff
        H, hd = cfg.n_heads, cfg.head_dim
        return {
            "ln1": ParamDef((d,), (None,), "ones"),
            "ln1b": ParamDef((d,), (None,), "zeros"),
            "ln2": ParamDef((d,), (None,), "ones"),
            "ln2b": ParamDef((d,), (None,), "zeros"),
            "tm": {
                "mu_x": ParamDef((d,), (None,), "zeros"),
                "mu": ParamDef((5, d), (None, None), "zeros"),
                "ts_w1": ParamDef((d, 5 * ts), ("embed", None), "scaled", 0.1),
                "ts_w2": ParamDef((5, ts, d), (None, None, "embed"), "scaled", 0.1),
                "w0": ParamDef((d,), (None,), "normal", 0.5),
                "wa": ParamDef((d, dl), ("embed", None), "scaled", 0.1),
                "wb": ParamDef((dl, d), (None, "embed"), "scaled", 0.1),
                "u": ParamDef((H, hd), ("heads", None), "normal", 0.5),
                "wr": ParamDef((d, d), ("embed", "heads_flat"), "scaled"),
                "wk": ParamDef((d, d), ("embed", "heads_flat"), "scaled"),
                "wv": ParamDef((d, d), ("embed", "heads_flat"), "scaled"),
                "wg": ParamDef((d, d), ("embed", "heads_flat"), "scaled"),
                "wo": ParamDef((d, d), ("heads_flat", "embed"), "scaled"),
                "gn_g": ParamDef((d,), (None,), "ones"),
                "gn_b": ParamDef((d,), (None,), "zeros"),
            },
            "cm": {
                "mu_k": ParamDef((d,), (None,), "zeros"),
                "mu_r": ParamDef((d,), (None,), "zeros"),
                "wk": ParamDef((d, f), ("embed", "mlp"), "scaled"),
                "wv": ParamDef((f, d), ("mlp", "embed"), "scaled"),
                "wr": ParamDef((d, d), ("embed", None), "scaled"),
            },
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        d, dz = cfg.d_model, cfg.denoiser_latent
        out = {
            "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"),
                              "normal", 0.02),
            "ln_in": ParamDef((d,), (None,), "ones"),
            "ln_inb": ParamDef((d,), (None,), "zeros"),
            "blocks": tree_defs_map(
                lambda pd: ParamDef((cfg.n_layers,) + pd.shape,
                                    (None,) + pd.axes, pd.init, pd.scale),
                self._layer_defs()),
            "ln_f": ParamDef((d,), (None,), "ones"),
            "ln_fb": ParamDef((d,), (None,), "zeros"),
            "lm_head": ParamDef((d, cfg.vocab_size), ("embed", "vocab"),
                                "scaled"),
        }
        if dz is not None:
            out["denoiser"] = {
                "in_proj": ParamDef((dz, d), (None, "embed"), "scaled"),
                "out_proj": ParamDef((d, dz), ("embed", None), "zeros"),
                "t_mlp1": ParamDef((256, d), (None, "embed"), "scaled"),
                "t_mlp2": ParamDef((d, d), ("embed", None), "scaled"),
            }
        return out

    # -- blocks ----------------------------------------------------------
    def _time_mix(self, p, x, shift_state, S0, *, chunked: bool):
        cfg = self.cfg
        B, T, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim
        xf = x.float()
        sx = _token_shift(xf, shift_state) - xf              # (sx - x)

        z = xf + sx * p["mu_x"]
        # the five low-rank mixes split the product's last dim: gathered
        # first where it is sharded (DTensor cannot split such a dim)
        dd = torch.tanh(replicated(promote_matmul(z, p["ts_w1"]), -1)
                        ).reshape(B, T, 5, -1)                 # [B,T,5,ts]
        deltas = promote_einsum("btfk,fkd->btfd", dd, p["ts_w2"])  # [B,T,5,d]
        mix = p["mu"][None, None] + deltas                   # [B,T,5,d]
        xw, xk, xv, xr, xg = [xf + sx * mix[:, :, i] for i in range(5)]

        logw = -torch.exp(p["w0"] + promote_matmul(
            torch.tanh(promote_matmul(xw, p["wa"])), p["wb"]))
        logw = _heads(torch.clamp(logw, -8.0, -1e-5), H)
        r = _heads(promote_matmul(xr, p["wr"]), H)
        k = _heads(promote_matmul(xk, p["wk"]), H)
        v = _heads(promote_matmul(xv, p["wv"]), H)
        g = F.silu(promote_matmul(xg, p["wg"]))

        if chunked and cfg.use_kernel:
            y, S = kops.wkv(r, k, v, logw, p["u"], S0, chunk=cfg.chunk_size)
        elif chunked and cfg.use_kernel is None and r.is_cuda:
            y, S = wkv_whole_chunks(r, k, v, logw, p["u"], S0,
                                    cfg.chunk_size)
        elif chunked and T % cfg.chunk_size == 0 and T > cfg.chunk_size:
            y, S = wkv_chunked(r, k, v, logw, p["u"], S0, cfg.chunk_size)
        else:
            y, S = wkv_sequential(r, k, v, logw, p["u"], S0)
        # heads merged and split again by the norm: kept whole along d
        # both ways where a mesh would split d other than by heads
        y = whole_along(group_norm(whole_along(y.reshape(B, T, d), -1),
                                   p["gn_g"], p["gn_b"], H), -1)
        out = promote_matmul(y * g, p["wo"]).to(x.dtype)
        return out, xf[:, -1, :], S

    def _channel_mix(self, p, x, shift_state):
        xf = x.float()
        sx = _token_shift(xf, shift_state) - xf
        xk = xf + sx * p["mu_k"]
        xr = xf + sx * p["mu_r"]
        kk = torch.square(F.relu(promote_matmul(xk, p["wk"])))
        out = (torch.sigmoid(promote_matmul(xr, p["wr"]))
               * promote_matmul(kk, p["wv"])).to(x.dtype)
        return out, xf[:, -1, :]

    def _block(self, p, x, cache, *, chunked: bool):
        h = layer_norm(x, p["ln1"], p["ln1b"])
        tm_out, tm_shift, S = self._time_mix(
            p["tm"], h, cache["tm_shift"], cache["S"], chunked=chunked)
        x = x + tm_out
        h = layer_norm(x, p["ln2"], p["ln2b"])
        cm_out, cm_shift = self._channel_mix(p["cm"], h, cache["cm_shift"])
        x = x + cm_out
        return x, {"S": S, "tm_shift": tm_shift, "cm_shift": cm_shift}

    def _layer(self, p, x, cache, *, chunked: bool):
        """``_block`` of ``gathered(p)``, checkpointed under
        ``remat="full"`` where autograd records it (the gather inside:
        made again in the backward)."""
        def run(p_, x_, cache_):
            return self._block(gathered(p_), x_, cache_, chunked=chunked)
        if self.cfg.remat == "full" and torch.is_grad_enabled() and any(
                t.requires_grad for t in tree_leaves(p)):
            return torch.utils.checkpoint.checkpoint(
                run, p, x, cache, use_reentrant=False)
        return run(p, x, cache)

    def _run(self, params, x, caches, *, chunked: bool):
        """The block stack over the stacked [L, ...] block params, unbound
        once per call (the reference scans over them); returns (x,
        per-layer caches stacked)."""
        x = layer_norm(x, params["ln_in"], params["ln_inb"])
        outs = []
        for l, p in enumerate(unstack(params["blocks"])):
            x = shard_batch_dim(x)  # pin batch->data at layer boundary
            x, out = self._layer(p, x, layer_of(caches, l), chunked=chunked)
            outs.append(out)
        x = layer_norm(x, params["ln_f"], params["ln_fb"])
        return x, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    # -- public API --------------------------------------------------------
    def cache_shapes(self, batch: int, s_max: int = 0) -> dict:
        """Per-layer recurrent state, ``{name: (shape, dtype)}``: O(1) in
        the sequence length (``s_max`` is taken for the transformer's
        signature and unused)."""
        cfg = self.cfg
        L, H, hd, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        return {
            "S": ((L, batch, H, hd, hd), torch.float32),
            "tm_shift": ((L, batch, d), torch.float32),
            "cm_shift": ((L, batch, d), torch.float32),
        }

    def init_cache(self, batch: int, s_max: int = 0, device=None) -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_shapes(batch).items()}

    def _lm(self, params, x, cache, *, chunked: bool):
        """Embedded tokens through the stack and the LM head ->
        ``(logits float32, new cache)``."""
        x, cache = self._run(params, x, cache, chunked=chunked)
        return promote_matmul(x, params["lm_head"]).float(), cache

    def forward(self, params, batch):
        """batch ``tokens`` [B, S] -> ``(logits [B, S, V] float32, aux)``
        from a zero state; aux is a float32 zero. The embedding is a
        gather whose backward sums each row in order (indexing's adds with
        atomics on the CPU: not bitwise reproducible)."""
        x = F.embedding(batch["tokens"],
                        replicated(params["embed"], 0)).to(self.cfg.dtype)
        cache = self.init_cache(x.shape[0], device=x.device)
        logits, _ = self._lm(params, x, cache, chunked=True)
        return logits, x.new_zeros((), dtype=torch.float32)

    def loss_fn(self, params, batch):
        """Next-token loss against ``batch["labels"]``, the mean over
        ``batch.get("mask")``."""
        logits, _ = self.forward(params, batch)
        return softmax_cross_entropy(logits, batch["labels"],
                                     batch.get("mask"))

    def prefill(self, params, batch, cache):
        """The prompt ``batch["tokens"]`` [B, S] from ``cache``'s state ->
        ``(last logits [B, 1, V], new cache)``."""
        x = F.embedding(batch["tokens"],
                        replicated(params["embed"], 0)).to(self.cfg.dtype)
        x, cache = self._run(params, x, cache, chunked=True)
        return promote_matmul(x[:, -1:], params["lm_head"]).float(), cache

    def decode_step(self, params, tokens, cache, index=None):
        """tokens [B, 1] -> ``(logits [B, 1, V], new cache)``; ``index``
        is unused (the state carries the whole context)."""
        del index
        x = F.embedding(tokens,
                        replicated(params["embed"], 0)).to(self.cfg.dtype)
        return self._lm(params, x, cache, chunked=False)

    def denoise(self, params, z, t):
        """z [B, S, dz], t scalar (or [B]) -> x0 prediction [B, S, dz]
        (float32). The causal recurrence runs forward and on the reversed
        sequence, and the two are averaged (the bidirectional adaptation)."""
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
        caches = self.init_cache(B, device=z.device)
        h_f, _ = self._run(params, x, caches, chunked=True)
        h_b, _ = self._run(params, torch.flip(x, dims=[1]), caches,
                           chunked=True)
        h = 0.5 * (h_f + torch.flip(h_b, dims=[1]))
        return (h @ dp["out_proj"].to(h.dtype)).float()
