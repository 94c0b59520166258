"""RWKV-6 "Finch" (arXiv:2404.05892) as an SA-Solver denoiser backbone:
attention-free, with data-dependent decay and token-shift ddlerp.

Time-mixing recurrence, per head with state S in R^{hd x hd}:

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

where w_t = exp(-exp(w0 + lora(x-shifted))) in (0, 1) is the per-channel
data-dependent decay. Two equivalent evaluation paths:

  - ``wkv_sequential``: the exact recurrence, one token at a time (the
    oracle, and the path for T not above one chunk);
  - ``wkv_chunked``: chunks of C tokens with intra-chunk pairwise
    log-decay differences, all exponents <= 0 (overflow-safe).

``RWKV6Config.use_kernel`` routes the chunked path through
``kernels.ops.wkv`` (the Hopper kernel on a CUDA tensor, its plain version
on a CPU tensor) when True, through the plain paths above when False,
and by the tensors' device when None (the default): the kernel for CUDA
tensors, which raises for a T that chunks do not divide. ``denoise`` runs the causal stack forward and on the
time-reversed sequence and averages the two. The LM entry points
(forward, loss, prefill, decode_step) come with a later slice.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.rwkv6_scan import rwkv6_wkv_plain
from .common import ParamDef, layer_norm, layer_of, tree_defs_map
from .transformer import timestep_embedding

__all__ = ["RWKV6Config", "RWKV6", "wkv_sequential", "wkv_chunked",
           "group_norm"]


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
    #: the reference's rematerialisation policy, kept so the configs match;
    #: the port runs no backward pass yet, so it has no effect
    remat: str = "none"
    #: residual-stream dtype
    dtype: torch.dtype = torch.bfloat16
    #: run the chunked WKV through kernels.ops.wkv (the counterpart of the
    #: reference's ``use_pallas``): True, False, or None for the kernel on
    #: CUDA tensors and the plain paths on CPU tensors
    use_kernel: bool | None = None
    #: latent width of the denoiser's continuous input/output heads
    denoiser_latent: int | None = None

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


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


class RWKV6:
    def __init__(self, cfg: RWKV6Config):
        if cfg.denoiser_latent is None:
            raise NotImplementedError(
                "the PyTorch port runs RWKV6 in denoiser mode only "
                "(denoiser_latent set); the LM path comes later")
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
        return {
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
            "denoiser": {
                "in_proj": ParamDef((dz, d), (None, "embed"), "scaled"),
                "out_proj": ParamDef((d, dz), ("embed", None), "zeros"),
                "t_mlp1": ParamDef((256, d), (None, "embed"), "scaled"),
                "t_mlp2": ParamDef((d, d), ("embed", None), "scaled"),
            },
        }

    # -- blocks ----------------------------------------------------------
    def _time_mix(self, p, x, shift_state, S0, *, chunked: bool):
        cfg = self.cfg
        B, T, d = x.shape
        H, hd = cfg.n_heads, cfg.head_dim
        xf = x.float()
        sx = _token_shift(xf, shift_state) - xf              # (sx - x)

        z = xf + sx * p["mu_x"]
        dd = torch.tanh(z @ p["ts_w1"]).reshape(B, T, 5, -1)  # [B,T,5,ts]
        deltas = torch.einsum("btfk,fkd->btfd", dd, p["ts_w2"])  # [B,T,5,d]
        mix = p["mu"][None, None] + deltas                   # [B,T,5,d]
        xw, xk, xv, xr, xg = [xf + sx * mix[:, :, i] for i in range(5)]

        logw = -torch.exp(p["w0"] + torch.tanh(xw @ p["wa"]) @ p["wb"])
        logw = torch.clamp(logw, -8.0, -1e-5).reshape(B, T, H, hd)
        r = (xr @ p["wr"]).reshape(B, T, H, hd)
        k = (xk @ p["wk"]).reshape(B, T, H, hd)
        v = (xv @ p["wv"]).reshape(B, T, H, hd)
        g = F.silu(xg @ p["wg"])

        kernel = r.is_cuda if cfg.use_kernel is None else cfg.use_kernel
        if kernel and chunked:
            y, S = kops.wkv(r, k, v, logw, p["u"], S0, chunk=cfg.chunk_size)
        elif chunked and T % cfg.chunk_size == 0 and T > cfg.chunk_size:
            y, S = wkv_chunked(r, k, v, logw, p["u"], S0, cfg.chunk_size)
        else:
            y, S = wkv_sequential(r, k, v, logw, p["u"], S0)
        y = group_norm(y.reshape(B, T, d), p["gn_g"], p["gn_b"], H)
        out = ((y * g) @ p["wo"]).to(x.dtype)
        return out, xf[:, -1, :], S

    def _channel_mix(self, p, x, shift_state):
        xf = x.float()
        sx = _token_shift(xf, shift_state) - xf
        xk = xf + sx * p["mu_k"]
        xr = xf + sx * p["mu_r"]
        kk = torch.square(F.relu(xk @ p["wk"]))
        out = (torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])).to(x.dtype)
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

    def _run(self, params, x, caches, *, chunked: bool):
        """The block stack over the stacked [L, ...] block params (the
        reference scans over them); returns (x, per-layer caches stacked)."""
        x = layer_norm(x, params["ln_in"], params["ln_inb"])
        outs = []
        for l in range(self.cfg.n_layers):
            x, out = self._block(layer_of(params["blocks"], l), x,
                                 layer_of(caches, l), chunked=chunked)
            outs.append(out)
        x = layer_norm(x, params["ln_f"], params["ln_fb"])
        return x, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    # -- public API --------------------------------------------------------
    def cache_shapes(self, batch: int) -> dict:
        """Per-layer recurrent state, ``{name: (shape, dtype)}``: O(1) in
        the sequence length."""
        cfg = self.cfg
        L, H, hd, d = cfg.n_layers, cfg.n_heads, cfg.head_dim, cfg.d_model
        return {
            "S": ((L, batch, H, hd, hd), torch.float32),
            "tm_shift": ((L, batch, d), torch.float32),
            "cm_shift": ((L, batch, d), torch.float32),
        }

    def init_cache(self, batch: int, device=None) -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=device)
                for k, (shape, dt) in self.cache_shapes(batch).items()}

    def denoise(self, params, z, t):
        """z [B, S, dz], t scalar (or [B]) -> x0 prediction [B, S, dz]
        (float32). The causal recurrence runs forward and on the reversed
        sequence, and the two are averaged (the bidirectional adaptation)."""
        cfg = self.cfg
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
