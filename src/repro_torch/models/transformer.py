"""Decoder-only transformer: the LM (dense or MoE; GQA with RoPE and a KV
cache, or DeepSeek's MLA with its compressed cache) and the DiT denoiser,
one class by config, after the reference's ``models/transformer.py``.

    param_defs()                    -> ParamDef tree (blocks stacked [L, ...])
    forward(params, batch)          -> (logits [B, S, V] float32, aux)
    loss_fn(params, batch)          -> scalar next-token loss (+ MoE aux,
                                       + MTP)
    cache_shapes(batch, s_max)      -> {name: (shape, dtype)} per layer stack
    init_cache(batch, s_max, device=None) -> zero KV cache
    prefill(params, batch, cache)   -> (last logits [B, 1, V], cache)
    decode_step(params, tokens, cache, index) -> (logits [B, 1, V], cache)
    denoise(params, z, t, cond)     -> x0 prediction [B, S, dz]
    denoise_cached(params, z, t, cond, feats=, refresh=)
                                    -> (x0 prediction, features)
                                    (refresh: a bool, or a device flag
                                    per batch or per row)

LM mode (``denoiser_latent`` None) embeds tokens (or takes embeddings,
``input_mode="embeds"``), runs the causal block stack (pre-norm
attention and MLP) and projects through the LM head (or the tied
embedding). With ``moe`` set the stack is ``n_dense_layers`` dense
blocks (``params["blocks"]``, absent when 0) followed by MoE blocks
(``params["moe_blocks"]``), whose auxiliary losses are summed into
``aux``; the caches keep the same two keys. ``mla`` swaps the attention
for ``mla_forward`` (its decode absorbs the latent projections unless a
``mla_absorb`` attribute set on the model says otherwise), and ``mtp``
adds DeepSeek's multi-token-prediction module to the loss when the batch
has ``labels2``. ``prefill`` writes the prompt's keys and values into the
preallocated cache in place and returns that cache; ``decode_step``
writes one position at ``index``. Without a cache the attention runs
through the flash kernel on the card (``AttentionConfig.use_flash``);
with one, through the plain attention over the cache.

Denoiser mode embeds the continuous latent, runs the block stack with
bidirectional attention and adaLN conditioning on the time and, with
``denoiser_cond`` set, a class/text vector (``_tcond``, float32 end to
end), and projects back. ``denoise_cached`` replays the mid-segment of
the stack from a cached residual (DeepCache).

The layer loop walks the stacked [L, ...] block parameters, unbound once
per call (so a backward stacks each leaf's gradient once); the reference
scans over them. Training differentiates through the plain attention
(``use_flash=False``, the reference's default): the kernels have no
backward and refuse inputs that require grad. ``LMConfig.remat``
recomputes each block in the backward (``torch.utils.checkpoint``), as
the reference's ``jax.checkpoint`` policies do. ``rope_type="mrope"``
(Qwen2-VL) rotates q and k over the batch's three position streams
``positions`` [3, B, S] (t, h, w; ``mrope_sections`` of the frequencies
each), or over the text-only default where the batch has none.
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
from .attention import (AttentionConfig, MLAConfig, attn_defs, cache_shape,
                        gqa_forward, mla_forward)
from .common import (ParamDef, chunked_lm_loss, gathered, layer_of,
                     mlp_apply, mlp_defs, promote_matmul, replicated,
                     rms_norm, shard_batch_dim, shard_logits_path,
                     softmax_cross_entropy, tree_defs_map, unstack)
from .moe import MoEConfig, moe_apply, moe_defs

__all__ = ["LMConfig", "TransformerLM", "timestep_embedding"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    family: str = "dense"  # dense | moe | audio | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None  # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    rope_type: str = "rope"  # rope | mrope | none
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    attn_logit_softcap: float | None = None
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    n_dense_layers: int = 0   # deepseek: first k layers dense even in MoE nets
    mtp: bool = False         # deepseek multi-token prediction module
    mtp_weight: float = 0.3
    #: "tokens" (default) or "embeds" (audio/vlm stub frontends)
    input_mode: str = "tokens"
    #: activation checkpointing of each block under autograd: "none",
    #: "full" (save nothing, recompute the block in the backward) or
    #: "dots" (save the matmul outputs, recompute the rest)
    remat: str = "none"
    #: residual-stream dtype (the reference's compute dtype)
    dtype: torch.dtype = torch.bfloat16
    #: KV-cache dtype
    cache_dtype: torch.dtype = torch.bfloat16
    #: latent width of the denoiser's continuous input/output heads
    #: (denoiser mode: time-conditioned, bidirectional); None: an LM
    denoiser_latent: int | None = None
    #: width of the denoiser's class/text conditioning vector (``y_proj``
    #: maps it into the adaLN signal); None: unconditional
    denoiser_cond: int | None = None
    #: run the no-cache attention through the flash kernel (True),
    #: through the plain attention (False), or by the tensors' device
    #: (None: the kernel for CUDA tensors); the reference carries this on
    #: AttentionConfig only
    use_flash: bool | None = None

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=self.rope_theta, rope_type=self.rope_type,
            mrope_sections=self.mrope_sections, causal=True, mla=self.mla,
            attn_logit_softcap=self.attn_logit_softcap,
            use_flash=self.use_flash)

    def param_count(self) -> tuple[int, int]:
        """(total, active) parameter counts, analytic (the reference's
        formula: the norm vectors are left out)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab_size
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_dim + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        else:
            attn = d * self.n_heads * self.hd * 2 \
                + d * self.n_kv_heads * self.hd * 2
        mlp_mats = 3 if self.gated_mlp else 2
        dense_mlp = mlp_mats * d * f
        if self.moe is not None:
            mo = self.moe
            expert = mlp_mats * d * mo.d_expert_ff
            shared = (mlp_mats * d * mo.d_shared_ff) if mo.n_shared else 0
            router = d * mo.n_experts
            n_moe = L - self.n_dense_layers
            total_mlp = (self.n_dense_layers * dense_mlp
                         + n_moe * (expert * mo.n_experts + shared + router))
            active_mlp = (self.n_dense_layers * dense_mlp
                          + n_moe * (expert * mo.top_k + shared + router))
        else:
            total_mlp = active_mlp = L * dense_mlp
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = L * attn + total_mlp + emb
        active = L * attn + active_mlp + emb
        return total, active


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
        if cfg.input_mode not in ("tokens", "embeds"):
            raise ValueError(f"input_mode={cfg.input_mode!r}; expected "
                             "'tokens' or 'embeds'")
        self.cfg = cfg
        self.acfg = cfg.attn_config()
        self._remat_kw = _remat_kwargs(cfg.remat)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _block_defs(self, moe_layer: bool = False) -> dict:
        cfg = self.cfg
        d = {
            "ln1": ParamDef((cfg.d_model,), (None,), "zeros"),
            "ln2": ParamDef((cfg.d_model,), (None,), "zeros"),
            "attn": attn_defs(self.acfg),
        }
        if moe_layer:
            d["moe"] = moe_defs(cfg.d_model, cfg.moe)
        else:
            d["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
        if cfg.denoiser_latent is not None:
            d["adaln"] = ParamDef((cfg.d_model, 6 * cfg.d_model),
                                  ("embed", None), "zeros")
        return d

    def _stack_sizes(self) -> dict:
        """``{"blocks": dense layers, "moe_blocks": MoE layers}``, the
        stacks of this config (a stack of no layer left out)."""
        cfg = self.cfg
        n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
        sizes = {"blocks": cfg.n_layers - n_moe, "moe_blocks": n_moe}
        return {k: n for k, n in sizes.items() if n}

    def param_defs(self) -> dict:
        cfg = self.cfg
        out: dict = {
            "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                              "normal", 0.02),
            "ln_f": ParamDef((cfg.d_model,), (None,), "zeros"),
        }
        for key, n in self._stack_sizes().items():
            out[key] = tree_defs_map(
                lambda pd, n=n: ParamDef((n,) + pd.shape, (None,) + pd.axes,
                                         pd.init, pd.scale),
                self._block_defs(moe_layer=key == "moe_blocks"))
        if not cfg.tie_embeddings:
            out["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                      ("embed", "vocab"), "scaled")
        if cfg.mtp:
            out["mtp"] = {
                "proj": ParamDef((2 * cfg.d_model, cfg.d_model),
                                 ("embed", None), "scaled"),
                "block": self._block_defs(moe_layer=False),
                "ln": ParamDef((cfg.d_model,), (None,), "zeros"),
            }
        dz = cfg.denoiser_latent
        if dz is None:
            return out
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
    def _attn(self, p, x, *, positions=None, cache=None, cache_index=None,
              causal=None):
        if self.cfg.mla is not None:
            return mla_forward(p, self.acfg, x, positions=positions,
                               cache=cache, cache_index=cache_index,
                               causal=causal,
                               absorb=getattr(self, "mla_absorb", None))
        return gqa_forward(p, self.acfg, x, positions=positions, cache=cache,
                           cache_index=cache_index, causal=causal)

    def _ffn(self, p, h):
        """The block's MLP, or its MoE when it has one -> ``(out, aux)``
        (aux: the float32 zero of an MLP)."""
        if "moe" in p:
            return moe_apply(p["moe"], self.cfg.moe, h)
        return (mlp_apply(p["mlp"], h, self.cfg.act, self.cfg.gated_mlp),
                h.new_zeros((), dtype=torch.float32))

    def _block(self, p, x, tcond):
        """One adaLN block: shift/scale/gate from the f32 conditioning,
        applied to the residual stream in its own dtype (an MoE block's
        aux loss is dropped, as the reference's ``denoise`` drops it)."""
        mod = promote_matmul(tcond, p["adaln"]).float()
        s1, g1, b1, s2, g2, b2 = torch.chunk(mod, 6, dim=-1)
        dt = x.dtype
        h = rms_norm(x, p["ln1"]) * (1 + s1[:, None, :]).to(dt) \
            + b1[:, None, :].to(dt)
        a, _ = self._attn(p["attn"], h, causal=False)
        x = x + g1[:, None, :].to(dt) * a.to(dt)
        h = rms_norm(x, p["ln2"]) * (1 + s2[:, None, :]).to(dt) \
            + b2[:, None, :].to(dt)
        m, _ = self._ffn(p, h)
        return x + g2[:, None, :].to(dt) * m.to(dt)

    def _lm_block(self, p, x, positions=None, cache=None, cache_index=None):
        """One causal pre-norm block -> ``(x, cache, aux)``."""
        a, cache = self._attn(p["attn"], rms_norm(x, p["ln1"]),
                              positions=positions, cache=cache,
                              cache_index=cache_index)
        x = x + a.to(x.dtype)
        m, aux = self._ffn(p, rms_norm(x, p["ln2"]))
        return x + m.to(x.dtype), cache, aux

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

    def _apply(self, fn, p, *args):
        """``fn(gathered(p), *args)``, checkpointed per ``cfg.remat`` where
        autograd records it (the gather inside: made again in the
        backward)."""
        def run(p_, *a):
            return fn(gathered(p_), *a)
        if self._remat_kw is not None and torch.is_grad_enabled() and any(
                t.requires_grad for t in (*args, *tree_leaves(p))
                if isinstance(t, torch.Tensor)):
            return torch.utils.checkpoint.checkpoint(
                run, p, *args, use_reentrant=False, **self._remat_kw)
        return run(p, *args)

    def _layers(self, params) -> list:
        """The unstacked block parameters, the dense blocks then the MoE
        blocks."""
        return [p for key in self._stack_sizes() for p in unstack(params[key])]

    def _stack(self, layers, x, tcond, lo: int, hi: int):
        """Blocks ``[lo, hi)`` of the stack (``layers``: the unstacked
        block parameters) over the residual stream."""
        for l in range(lo, hi):
            x = shard_batch_dim(x)  # pin batch->data at layer boundary
            x = self._apply(self._block, layers[l], x, tcond)
        return x

    def _run_stack(self, params, x, *, positions=None, caches=None,
                   cache_index=None):
        """The causal block stack over ``x``: the dense blocks, then the
        MoE blocks. With ``caches`` (the stacked per-layer caches under
        the same keys) each layer writes its cache at ``cache_index`` in
        place. Returns ``(x, caches, aux)``, aux the float32 sum of the
        MoE blocks' auxiliary losses."""
        def run(p_, x_):
            x_ = shard_batch_dim(x_)  # pin batch->data at layer boundary
            x_, _, a_ = self._lm_block(p_, x_, positions)
            return x_, a_

        aux = x.new_zeros((), dtype=torch.float32)
        for key in self._stack_sizes():
            for l, p in enumerate(unstack(params[key])):
                if caches is None:
                    x, a = self._apply(run, p, x)
                else:
                    x, _, a = self._lm_block(p, x, positions,
                                             layer_of(caches[key], l),
                                             cache_index)
                aux = aux + a
        return x, caches, aux

    # ------------------------------------------------------------------
    # LM: embedding / head
    # ------------------------------------------------------------------
    def _embed(self, params, batch):
        cfg = self.cfg
        if cfg.input_mode == "embeds" or "embeds" in batch:
            x = batch["embeds"].to(cfg.dtype)
        else:
            # a gather whose backward sums each row in order (indexing's
            # adds with atomics on the CPU: not bitwise reproducible)
            x = F.embedding(batch["tokens"],
                            replicated(params["embed"], 0)).to(cfg.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
        return x

    def _head_weight(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["lm_head"]

    def _logits(self, params, x):
        h = rms_norm(x, params["ln_f"])
        h, _ = shard_logits_path(h, None)
        logits = (h @ self._head_weight(params).to(h.dtype)).float()
        _, logits = shard_logits_path(None, logits)
        return logits

    # ------------------------------------------------------------------
    # LM: public API
    # ------------------------------------------------------------------
    def forward(self, params, batch):
        """batch: ``tokens`` [B, S] (or ``embeds`` [B, S, d]), optional
        ``positions`` ([B, S]; M-RoPE: [3, B, S]). Returns ``(logits
        [B, S, V] float32, aux)``, aux the MoE blocks' auxiliary loss
        (float32; zero for a dense stack)."""
        x = self._embed(params, batch)
        x, _, aux = self._run_stack(params, x,
                                    positions=batch.get("positions"))
        return self._logits(params, x), aux

    def loss_fn(self, params, batch):
        """Causal LM loss against ``batch["labels"]`` ([B, S], next
        token), the mean over ``batch.get("mask")``, plus the MoE blocks'
        auxiliary loss. Large vocabularies (>= 32,000) at S a multiple of
        512 above 512 take the sequence-chunked head
        (``common.chunked_lm_loss``). With ``mtp`` and ``labels2`` in the
        batch, DeepSeek-V3's multi-token prediction adds ``mtp_weight``
        times the loss of token t+2: the trunk state joined with the
        embedding of token t+1, projected, one dense block, and the shared
        head."""
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = batch.get("positions")
        x, _, aux = self._run_stack(params, x, positions=positions)
        S = x.shape[1]
        if cfg.vocab_size >= 32000 and S > 512 and S % 512 == 0:
            h = rms_norm(x, params["ln_f"])
            h, _ = shard_logits_path(h, None)
            loss = chunked_lm_loss(h, self._head_weight(params).to(h.dtype),
                                   batch["labels"], batch.get("mask"))
        else:
            loss = softmax_cross_entropy(self._logits(params, x),
                                         batch["labels"], batch.get("mask"))
        if cfg.mtp and "labels2" in batch:
            mp = params["mtp"]
            tgt = F.embedding(batch["labels"],
                              replicated(params["embed"], 0)).to(x.dtype)
            h = promote_matmul(torch.cat([x, tgt], dim=-1), mp["proj"])
            h, _, _ = self._lm_block(mp["block"], h, positions)
            logits2 = self._logits(params, rms_norm(h, mp["ln"]))
            loss = loss + cfg.mtp_weight * softmax_cross_entropy(
                logits2, batch["labels2"], batch.get("mask"))
        return loss + aux

    def cache_shapes(self, batch: int, s_max: int) -> dict:
        """``{stack: {leaf: ((L_stack, B, s_max, ...), cache_dtype)}}`` for
        the stacks ``blocks`` and ``moe_blocks``; the leaves are ``k``,
        ``v`` [.., K, hd] (GQA) or ``c_kv``, ``k_rope`` (MLA)."""
        per_layer = cache_shape(self.acfg, batch, s_max, self.cfg.cache_dtype)
        return {key: {k: ((n,) + shape, dt)
                      for k, (shape, dt) in per_layer.items()}
                for key, n in self._stack_sizes().items()}

    def init_cache(self, batch: int, s_max: int, device=None) -> dict:
        """A zero cache of ``s_max`` positions on ``device``."""
        return {key: {k: torch.zeros(shape, dtype=dt, device=device)
                      for k, (shape, dt) in leaves.items()}
                for key, leaves in self.cache_shapes(batch, s_max).items()}

    def prefill(self, params, batch, cache):
        """Run the prompt, writing the cache from position 0 in place.
        Returns the last position's logits [B, 1, V] and the cache."""
        x = self._embed(params, batch)
        x, cache, _ = self._run_stack(params, x,
                                      positions=batch.get("positions"),
                                      caches=cache, cache_index=0)
        return self._logits(params, x[:, -1:, :]), cache

    def decode_step(self, params, tokens, cache, index):
        """tokens [B, 1] (or embeds [B, 1, d]) at position ``index`` (an
        int) -> ``(logits [B, 1, V], cache)``, the cache written at
        ``index`` in place."""
        batch = {"tokens": tokens} if tokens.dim() == 2 else {"embeds": tokens}
        x = self._embed(params, batch)
        x, cache, _ = self._run_stack(params, x, caches=cache,
                                      cache_index=int(index))
        return self._logits(params, x), cache

    # ------------------------------------------------------------------
    # denoiser mode
    # ------------------------------------------------------------------
    def _denoise_embed(self, dp, z, t, cond):
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
        x, tcond = self._denoise_embed(params["denoiser"], z, t, cond)
        x = self._stack(self._layers(params), x, tcond, 0,
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
        ``lax.cond``. A MoE stack raises ``NotImplementedError``, as the
        reference's does."""
        if "moe_blocks" in params:
            raise NotImplementedError(
                "feature caching requires a dense (non-MoE) block stack")
        L = self.cfg.n_layers
        a, b = self.cache_span() if span is None else span
        if not 0 <= a <= b <= L:
            raise ValueError(f"bad cache span ({a}, {b}) for L={L}")
        x, tcond = self._denoise_embed(params["denoiser"], z, t, cond)
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
