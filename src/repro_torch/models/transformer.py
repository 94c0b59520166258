"""Transformer backbone in denoiser mode (DiT): the part of the reference's
``models/transformer.py`` that SA-Solver samples through.

    param_defs()                    -> ParamDef tree (blocks stacked [L, ...])
    denoise(params, z, t, cond)     -> x0 prediction [B, S, dz]
    denoise_cached(params, z, t, cond, feats=, refresh=)
                                    -> (x0 prediction, features)
                                    (refresh: a bool, or a device flag
                                    per batch or per row)

``denoise`` embeds the continuous latent, runs the block stack with
bidirectional attention and adaLN conditioning on the time and, with
``denoiser_cond`` set, a class/text vector (``_tcond``, float32 end to
end), and projects back. The layer loop walks the stacked [L, ...] block
parameters, unbound once per call (so a backward stacks each leaf's
gradient once); the reference scans over them. ``denoise_cached`` replays
the mid-segment of the stack from a cached residual (DeepCache).

Training differentiates ``denoise`` with autograd through the plain
attention (``use_flash=False``, the reference's default): the kernels
have no backward and refuse inputs that require grad. ``LMConfig.remat``
recomputes each block in the backward (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` policies do. The LM entry points
(forward, loss, prefill/decode) and MoE/MLA blocks come with later slices
of the port.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..kernels.graph_gate import run_if
from ..tree import tree_leaves
from .attention import AttentionConfig, attn_defs, gqa_forward
from .common import (ParamDef, mlp_apply, mlp_defs, promote_matmul,
                     rms_norm, tree_defs_map, unstack)

__all__ = ["LMConfig", "TransformerLM", "timestep_embedding"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    #: size of the (unused in denoiser mode) token embedding and LM head,
    #: kept so the parameter tree is the reference's
    vocab_size: int = 1024
    #: the reference's block options, at the only values the port computes
    #: (the DiT's: GELU-tanh, ungated MLP, no RoPE, no logit soft-capping);
    #: TransformerLM refuses any other
    act: str = "gelu"
    gated_mlp: bool = False
    rope_type: str = "none"
    attn_logit_softcap: float | None = None
    #: activation checkpointing of each block under autograd: "none",
    #: "full" (save nothing, recompute the block in the backward) or
    #: "dots" (save the matmul outputs, recompute the rest)
    remat: str = "none"
    #: residual-stream dtype (the reference's compute dtype)
    dtype: torch.dtype = torch.bfloat16
    #: latent width of the denoiser's continuous input/output heads
    denoiser_latent: int | None = None
    #: width of the denoiser's class/text conditioning vector (``y_proj``
    #: maps it into the adaLN signal); None: unconditional
    denoiser_cond: int | None = None
    #: run the blocks' attention through the flash kernel (True), through
    #: the plain attention (False), or by the tensors' device (None: the
    #: kernel for CUDA tensors); the reference carries this on
    #: AttentionConfig only
    use_flash: bool | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            use_flash=self.use_flash)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding of (possibly batched) scalar t, float32."""
    t = torch.atleast_1d(torch.as_tensor(t, dtype=torch.float32))
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    ang = t[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _remat_kwargs(remat: str) -> dict | None:
    """``torch.utils.checkpoint.checkpoint``'s keywords for a remat policy
    (None: no checkpointing), after the reference's ``_remat_policy``:
    "full" saves nothing, "dots" the outputs of the matmuls."""
    if remat == "none":
        return None
    if remat == "full":
        return {}
    if remat == "dots":
        try:
            from torch.utils.checkpoint import \
                create_selective_checkpoint_contexts
        except ImportError as e:
            raise NotImplementedError(
                "remat='dots' needs torch.utils.checkpoint."
                "create_selective_checkpoint_contexts, which this PyTorch "
                "lacks; use 'full' or 'none'") from e
        aten = torch.ops.aten
        saved = [aten.mm.default, aten.bmm.default, aten.addmm.default]
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, saved)}
    raise ValueError(f"remat={remat!r}; expected 'none', 'full' or 'dots'")


class TransformerLM:
    def __init__(self, cfg: LMConfig):
        if cfg.denoiser_latent is None:
            raise NotImplementedError(
                "the PyTorch port runs the transformer in denoiser mode "
                "only (denoiser_latent set); the LM zoo comes later")
        computed = {"act": "gelu", "gated_mlp": False, "rope_type": "none",
                    "attn_logit_softcap": None}
        other = {k: getattr(cfg, k) for k, v in computed.items()
                 if getattr(cfg, k) != v}
        if other:
            raise NotImplementedError(
                f"the PyTorch port's transformer computes {computed} only "
                f"(the DiT block); {cfg.name} asks for {other}")
        self.cfg = cfg
        self.acfg = cfg.attn_config()
        self._remat_kw = _remat_kwargs(cfg.remat)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _block_defs(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": ParamDef((cfg.d_model,), (None,), "zeros"),
            "ln2": ParamDef((cfg.d_model,), (None,), "zeros"),
            "attn": attn_defs(self.acfg),
            "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
            "adaln": ParamDef((cfg.d_model, 6 * cfg.d_model),
                              ("embed", None), "zeros"),
        }

    def param_defs(self) -> dict:
        cfg = self.cfg
        L = cfg.n_layers
        out: dict = {
            "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              "normal", 0.02),
            "ln_f": ParamDef((cfg.d_model,), (None,), "zeros"),
            "blocks": tree_defs_map(
                lambda pd: ParamDef((L,) + pd.shape, (None,) + pd.axes,
                                    pd.init, pd.scale), self._block_defs()),
            "lm_head": ParamDef((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), "scaled"),
        }
        dz = cfg.denoiser_latent
        out["denoiser"] = {
            "in_proj": ParamDef((dz, cfg.d_model), (None, "embed"), "scaled"),
            "out_proj": ParamDef((cfg.d_model, dz), ("embed", None), "zeros"),
            "t_mlp1": ParamDef((256, cfg.d_model), (None, "embed"), "scaled"),
            "t_mlp2": ParamDef((cfg.d_model, cfg.d_model), ("embed", None),
                               "scaled"),
        }
        if cfg.denoiser_cond is not None:
            out["denoiser"]["y_proj"] = ParamDef(
                (cfg.denoiser_cond, cfg.d_model), (None, "embed"), "scaled")
        return out

    # ------------------------------------------------------------------
    # blocks
    # ------------------------------------------------------------------
    def _block(self, p, x, tcond):
        """One adaLN block: shift/scale/gate from the f32 conditioning,
        applied to the residual stream in its own dtype."""
        mod = promote_matmul(tcond, p["adaln"]).float()
        s1, g1, b1, s2, g2, b2 = torch.chunk(mod, 6, dim=-1)
        dt = x.dtype
        h = rms_norm(x, p["ln1"]) * (1 + s1[:, None, :]).to(dt) \
            + b1[:, None, :].to(dt)
        a = gqa_forward(p["attn"], self.acfg, h, causal=False)
        x = x + g1[:, None, :].to(dt) * a.to(dt)
        h = rms_norm(x, p["ln2"]) * (1 + s2[:, None, :]).to(dt) \
            + b2[:, None, :].to(dt)
        m = mlp_apply(p["mlp"], h)
        return x + g2[:, None, :].to(dt) * m.to(dt)

    def _tcond(self, dp, t, batch: int, cond=None):
        """adaLN conditioning signal, float32 end to end: the bf16 policy
        narrows latents only; quantizing ``t`` (or the class/text vector)
        to bf16 would collapse adjacent solver timesteps. ``cond``
        ([d_cond] or [batch, d_cond]) adds ``cond @ y_proj``."""
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=dp["t_mlp1"].device).expand(batch)
        temb = timestep_embedding(t, 256)
        tcond = F.silu(temb @ dp["t_mlp1"].float()) @ dp["t_mlp2"].float()
        if cond is not None:
            if self.cfg.denoiser_cond is None:
                raise ValueError("a conditioning input needs denoiser_cond "
                                 "in the config")
            c = torch.atleast_2d(torch.as_tensor(cond, dtype=torch.float32,
                                                 device=tcond.device))
            c = c.expand(batch, c.shape[-1])
            tcond = tcond + c @ dp["y_proj"].float()
        return tcond

    def _stack(self, layers, x, tcond, lo: int, hi: int):
        """Blocks ``[lo, hi)`` of the stack (``layers``: the unstacked
        block parameters) over the residual stream; each block
        checkpointed per ``cfg.remat`` where autograd records it."""
        for l in range(lo, hi):
            p = layers[l]
            if self._remat_kw is not None and torch.is_grad_enabled() and (
                    x.requires_grad or tcond.requires_grad or any(
                        t.requires_grad for t in tree_leaves(p))):
                x = torch.utils.checkpoint.checkpoint(
                    self._block, p, x, tcond, use_reentrant=False,
                    **self._remat_kw)
            else:
                x = self._block(p, x, tcond)
        return x

    def _embed(self, dp, z, t, cond):
        cfg = self.cfg
        x = z.to(cfg.dtype) @ dp["in_proj"].to(cfg.dtype)
        return x, self._tcond(dp, t, z.shape[0], cond)

    def _head(self, params, x):
        x = rms_norm(x, params["ln_f"])
        return (x @ params["denoiser"]["out_proj"].to(self.cfg.dtype)).float()

    def denoise(self, params, z, t, cond=None):
        """z [B, S, dz], t scalar (or [B]) -> x0 prediction [B, S, dz]
        (float32): bidirectional attention + adaLN conditioning; ``cond``
        ([d_cond] or [B, d_cond]) joins ``t`` in the adaLN signal."""
        x, tcond = self._embed(params["denoiser"], z, t, cond)
        x = self._stack(unstack(params["blocks"]), x, tcond, 0,
                        self.cfg.n_layers)
        return self._head(params, x)

    # ---- step-to-step feature caching (DeepCache-style) ---------------
    def cache_span(self) -> tuple[int, int]:
        """Default [a, b) mid-segment of the block stack to cache: the
        deep interior whose activations drift slowest across adjacent
        solver steps, one-sixth of the depth kept live on each side."""
        L = self.cfg.n_layers
        k = max(1, L // 6)
        return (k, L - k)

    def feature_shape(self, batch: int, seq: int):
        """``(shape, dtype)`` of the cached mid-segment residual for one
        [batch, seq, dz] latent: it lives in the d_model stream."""
        return (batch, seq, self.cfg.d_model), self.cfg.dtype

    def denoise_cached(self, params, z, t, cond=None, *, feats,
                       refresh, span=None):
        """``denoise`` with the mid-segment ``[a, b)`` of the block stack
        either recomputed (``refresh``) or replaced by the cached residual
        ``feats`` (DeepCache). Returns ``(x0_prediction, new_feats)``. The
        cached quantity is the residual ``y - x`` across [a, b), so a
        refresh-every-step schedule reproduces ``denoise``. ``span``
        overrides :meth:`cache_span`.

        ``refresh`` is a Python bool (a refresh returns new features, a
        reuse passes ``feats`` back unchanged), or a bool tensor on the
        device of ``z``: 0-d for the whole batch, or [B], one flag per
        row. With a tensor the segment runs only where some flag is set,
        decided on the device (:func:`repro_torch.kernels.graph_gate.run_if`:
        a conditional node of a CUDA graph under capture), and the
        refreshed rows are written into ``feats`` in place, which is
        returned. The reference dispatches a traced flag through
        ``lax.cond``."""
        L = self.cfg.n_layers
        a, b = self.cache_span() if span is None else span
        if not 0 <= a <= b <= L:
            raise ValueError(f"bad cache span ({a}, {b}) for L={L}")
        x, tcond = self._embed(params["denoiser"], z, t, cond)
        layers = unstack(params["blocks"])
        x = self._stack(layers, x, tcond, 0, a)
        if isinstance(refresh, bool):
            if refresh:
                y = self._stack(layers, x, tcond, a, b)
                feats = (y - x).to(feats.dtype)
                x = y
            else:
                x = x + feats.to(x.dtype)
        else:
            if refresh.dim() > 1 or (refresh.dim() == 1
                                     and refresh.shape[0] != x.shape[0]):
                raise ValueError(
                    f"refresh of shape {tuple(refresh.shape)}: 0-d, or one "
                    f"flag per row of a batch of {x.shape[0]}")
            rows = refresh.reshape(tuple(refresh.shape)
                                   + (1,) * (x.dim() - refresh.dim()))
            h = x + feats.to(x.dtype)  # the reuse, overwritten where fresh

            def deep():
                y = self._stack(layers, x, tcond, a, b)
                feats.copy_(torch.where(rows, (y - x).to(feats.dtype), feats))
                h.copy_(torch.where(rows, y, h))

            run_if(refresh.any(), deep)
            x = h
        x = self._stack(layers, x, tcond, b, L)
        return self._head(params, x), feats
