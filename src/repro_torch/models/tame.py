"""Contractive denoiser weights: the yardstick for whole-solve comparisons.

A freshly initialised backbone is useless for comparing two solves: with
zero-initialised output heads (the DiT's adaLN-zero ``adaln`` and
``out_proj``, RWKV6's ``out_proj``) it predicts exactly 0, and with random
output weights its x0-prediction is *expansive* in ``x`` (random
attention/MLP/recurrence paths open through O(1) gates, and every norm's
Jacobian grows as the solve drives ``|x|`` toward zero), so a last-bit
difference between two combines is amplified ~5-8x per solver step and
says nothing about the combines. A trained denoiser is contractive:
roughly the data mean plus a small x-dependent correction.
:func:`tame_dit`, :func:`tame_rwkv6` and :func:`tame_zamba2` build that
regime from a seed:

- the DiT's adaLN weights drawn at ``adaln_scale`` (small but real gates);
  RWKV6 and Zamba2 have no gates, so the output projections of their
  residual branches (RWKV6's ``tm/wo``, ``cm/wv``; Zamba2's
  ``mamba/out_proj`` and the shared block's ``out_proj``) are scaled by
  ``BRANCH_SCALE`` instead: without that, 32 random RWKV6 blocks amplify a
  1e-7 nudge of x_T to ~1e-3 over a solve while a random-direction
  Jacobian gain still reads below 1; Zamba2's shared attention also has
  its ``wq`` and ``wk`` scaled by hd^-1/2 each, so that its logits have
  unit scale (at the init their std is the head dim, 224 at full width);
- ``out_proj`` drawn at ``1/out_div`` (a small x-dependent correction);
- the t-conditioning MLP damped by ``t_damp`` so ``tcond`` stays O(1),
  and a class-conditional DiT's ``y_proj`` (which adds its class/text
  vector to the same signal) damped like ``t_mlp2``;
- a fixed unit-scale anchor ``mu`` ("data mean") added to the output by
  :func:`tame_networks`, keeping ``|x|`` O(1) through the solve.

Width: both random maps sum over ``d_model`` inputs, so their draws are
scaled by ``sqrt(64 / d_model)``. At width 64 (the ``dit-s`` smoke config
the reference's constants were tuned on) this is exactly the reference's
DiT construction; at full width it keeps the same per-output magnitudes.
:func:`ensure_contractive` measures the Jacobian gain on the target
device and damps the adaLN weights (the DiT) or ``out_proj`` (RWKV6,
Zamba2) further until it is below 1.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..configs import get_config, get_smoke
from ..core.denoiser import CachedNetwork
from ..device import resolve_device
from .common import block_stacks, init_params
from .mamba2 import Zamba2
from .rwkv6 import RWKV6
from .transformer import TransformerLM

__all__ = ["tame_dit", "tame_rwkv6", "tame_zamba2", "tame_params",
           "tame_networks", "jacobian_gain", "ensure_contractive"]

# RWKV6's and Zamba2's counterpart of the DiT's small adaLN gates: the
# factor on the output projections of their residual branches.
BRANCH_SCALE = 0.05


def tame_params(params: dict, d_model: int, generator: torch.Generator, *,
                adaln_scale: float = 0.003, out_div: float = 50.0,
                t_damp: tuple[float, float] = (0.1, 0.3)) -> dict:
    """Overwrite an ``init_params`` tree in place with the contractive
    construction (draws from ``generator``); returns it. ``adaln_scale``
    applies to trees with adaLN weights (the DiT; a MoE denoiser's dense
    and MoE stacks both); trees with RWKV6 or Mamba2 blocks have their
    branch projections scaled by ``BRANCH_SCALE``, and a Zamba2 tree's
    shared block its ``out_proj`` too and its ``wq``/``wk`` by hd^-1/2."""
    w = math.sqrt(64.0 / d_model)
    dp = params["denoiser"]
    dev = dp["out_proj"].device
    for blocks in block_stacks(params):
        if "adaln" in blocks:
            blocks["adaln"] = adaln_scale * w * torch.randn(
                blocks["adaln"].shape, generator=generator, device=dev)
        if "tm" in blocks:
            blocks["tm"]["wo"] = blocks["tm"]["wo"] * BRANCH_SCALE
            blocks["cm"]["wv"] = blocks["cm"]["wv"] * BRANCH_SCALE
        if "mamba" in blocks:
            blocks["mamba"]["out_proj"] = \
                blocks["mamba"]["out_proj"] * BRANCH_SCALE
    if "shared" in params:
        sp = params["shared"]
        sp["out_proj"] = sp["out_proj"] * BRANCH_SCALE
        qk = sp["attn"]["wq"].shape[-1] ** -0.5
        for k in ("wq", "wk"):
            sp["attn"][k] = sp["attn"][k] * qk
    dp["out_proj"] = w / out_div * torch.randn(
        dp["out_proj"].shape, generator=generator, device=dev)
    dp["t_mlp1"] = dp["t_mlp1"] * t_damp[0]
    dp["t_mlp2"] = dp["t_mlp2"] * t_damp[1]
    if "y_proj" in dp:
        dp["y_proj"] = dp["y_proj"] * t_damp[1]
    return params


def _tame(model, seed: int, device, **tame_kw):
    """``(model, params, mu)`` for a built model: its parameters drawn from
    ``seed`` and tamed, and the unit-scale anchor ``mu(seq) -> [seq, dz]``
    (deterministic in ``seed``)."""
    cfg = model.cfg
    params = init_params(torch.Generator(device).manual_seed(seed),
                         model.param_defs(), torch.float32, device)
    tame_params(params, cfg.d_model,
                torch.Generator(device).manual_seed(seed + 1), **tame_kw)
    anchors: dict[int, torch.Tensor] = {}

    def mu(seq: int) -> torch.Tensor:
        if seq not in anchors:
            g = torch.Generator(device).manual_seed(seed + 2)
            anchors[seq] = torch.randn((seq, cfg.denoiser_latent),
                                       generator=g, device=device)
        return anchors[seq]

    return model, params, mu


def tame_dit(arch: str = "dit-s", *, smoke: bool = True,
             n_layers: int | None = None, seed: int = 0,
             adaln_scale: float = 0.003, out_div: float = 50.0,
             t_damp: tuple[float, float] = (0.1, 0.3),
             use_flash: bool | None = None,
             denoiser_cond: int | None = None, latent: int = 16,
             device="cuda"):
    """Build a DiT (smoke or full config) whose denoise map is contractive.

    The residual stream is float32, as in the reference's construction.
    Returns ``(model, params, mu)``; ``mu(seq) -> [seq, dz]`` is the fixed
    unit-scale anchor (deterministic in ``seed``) that
    :func:`tame_networks` adds to the model's x0 output. Runs on the card
    unless ``device`` says otherwise; ``use_flash`` as on ``LMConfig``
    (None: the flash kernel on the card, the plain attention on the CPU);
    ``denoiser_cond`` makes the DiT class-conditional with a conditioning
    vector of that width (``y_proj``); ``latent`` is the denoiser latent
    width of an LM config (starcoder2-3b), which leaves it unset.
    """
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=cfg.n_layers if n_layers is None else n_layers,
        dtype=torch.float32, use_flash=use_flash,
        denoiser_cond=denoiser_cond,
        denoiser_latent=cfg.denoiser_latent or latent)
    return _tame(TransformerLM(cfg), seed, device, adaln_scale=adaln_scale,
                 out_div=out_div, t_damp=t_damp)


def tame_rwkv6(arch: str = "rwkv6-3b", *, smoke: bool = True,
               n_layers: int | None = None, seed: int = 0,
               out_div: float = 50.0, use_kernel: bool | None = None,
               latent: int = 16, device="cuda"):
    """Build an RWKV6 denoiser (smoke or full config) whose denoise map is
    contractive: the residual branches' output projections scaled by
    ``BRANCH_SCALE``, ``out_proj`` drawn small instead of zero, the t-MLP
    damped. The residual stream is float32 (the published config's is
    bfloat16: swap it with ``dataclasses.replace`` on ``model.cfg``);
    ``latent`` is the denoiser latent width, which the LM config leaves
    unset; ``use_kernel`` as on ``RWKV6Config`` (None: the WKV kernel on
    the card, the plain recurrence on the CPU). Returns
    ``(model, params, mu)`` as :func:`tame_dit` does; runs on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=cfg.n_layers if n_layers is None else n_layers,
        dtype=torch.float32, use_kernel=use_kernel,
        denoiser_latent=cfg.denoiser_latent or latent)
    return _tame(RWKV6(cfg), seed, device, out_div=out_div)


def tame_zamba2(arch: str = "zamba2-7b", *, smoke: bool = True,
                n_layers: int | None = None, seed: int = 0,
                out_div: float = 50.0, use_flash: bool | None = None,
                latent: int = 16, device="cuda"):
    """Build a Zamba2 denoiser (smoke or full config) whose denoise map is
    contractive: the Mamba blocks' and the shared block's output
    projections scaled by ``BRANCH_SCALE``, the shared attention's logits
    brought to unit scale, ``out_proj`` drawn small instead of zero, the
    t-MLP damped. The residual stream is float32 (the published config's
    is bfloat16: swap it with ``dataclasses.replace`` on ``model.cfg``);
    ``latent`` is the denoiser latent width, which the LM config leaves
    unset; ``use_flash`` as on ``Zamba2Config`` (None: the flash kernel on
    the card, the plain attention on the CPU). Returns
    ``(model, params, mu)`` as :func:`tame_dit` does; runs on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(
        cfg, n_layers=cfg.n_layers if n_layers is None else n_layers,
        dtype=torch.float32, use_flash=use_flash,
        denoiser_latent=cfg.denoiser_latent or latent)
    return _tame(Zamba2(cfg), seed, device, out_div=out_div)


def tame_networks(model, params, mu):
    """``(network, cached)`` over a tame triple: the Denoiser network
    ``(x, t, cond) -> x0`` with the mean anchor applied, and its
    feature-cached twin (a :class:`CachedNetwork` over
    ``denoise_cached``; None for a backbone without one: RWKV6, Zamba2).
    ``cond`` (when not None) is the model's conditioning input for a
    class-conditional DiT (``denoiser_cond`` set: [d_cond] or
    [B, d_cond]), and otherwise an input-space prompt added to the
    latent."""
    conditional = getattr(model.cfg, "denoiser_cond", None) is not None

    def inputs(x, cond):
        """(latent, model conditioning) of one call."""
        if conditional or cond is None:
            return x, cond
        return x + cond, None

    def network(x, t, cond):
        h, c = inputs(x, cond)
        x0 = model.denoise(params, h, t, c) if conditional else \
            model.denoise(params, h, t)
        return x0 + mu(x.shape[-2])

    if not hasattr(model, "denoise_cached"):
        return network, None

    def call(x, t, cond, feats, refresh):
        h, c = inputs(x, cond)
        x0, new = model.denoise_cached(params, h, t, c, feats=feats,
                                       refresh=refresh)
        return x0 + mu(x.shape[-2]), new

    def init(x):
        shape, dtype = model.feature_shape(x.shape[0], x.shape[1])
        return torch.zeros(shape, dtype=dtype, device=x.device)

    return network, CachedNetwork(call=call, init=init)


@torch.no_grad()
def jacobian_gain(network, x: torch.Tensor, t: float, v: torch.Tensor,
                  rel_step: float = 1e-3, cond=None) -> float:
    """``|J v| / |v|`` of ``network(., t, cond)`` at ``x``, by a central
    finite difference along ``v`` scaled to ``rel_step * |x|``."""
    d = v * (rel_step * x.norm() / v.norm())
    tt = torch.tensor(t, dtype=torch.float32, device=x.device)
    jv = network(x + d, tt, cond) - network(x - d, tt, cond)
    return float(jv.norm() / (2 * d.norm()))


@torch.no_grad()
def ensure_contractive(model, params, mu, x: torch.Tensor,
                       generator: torch.Generator,
                       ts=(0.95, 0.5, 0.1), max_halvings: int = 4,
                       cond=None) -> dict:
    """Check that the tame network's Jacobian gain is below 1 at every
    ``t`` in ``ts`` (at the state ``x`` and conditioning ``cond``, along a
    random direction); halve
    the damped leaf in place until it is, at most ``max_halvings`` times.
    The damped leaf is the adaLN weights where the tree has them (the
    DiT: in every stack), else ``denoiser/out_proj`` (RWKV6, Zamba2).
    Returns
    ``{"damped", "factor", "gains", "halvings"}``; raises if the gain
    stays at or above 1."""
    network, _ = tame_networks(model, params, mu)
    v = torch.randn(x.shape, generator=generator, device=x.device)
    trees = [b for b in block_stacks(params) if "adaln" in b]
    trees, leaf = (trees, "adaln") if trees else \
        ([params["denoiser"]], "out_proj")
    factor = 1.0
    for halvings in range(max_halvings + 1):
        gains = {t: jacobian_gain(network, x, t, v, cond=cond) for t in ts}
        if max(gains.values()) < 1.0:
            return {"damped": leaf, "factor": factor, "gains": gains,
                    "halvings": halvings}
        if halvings < max_halvings:
            for tree in trees:
                tree[leaf] = tree[leaf] * 0.5
            factor *= 0.5
    raise RuntimeError(
        f"tame weights stay expansive after {max_halvings} halvings of "
        f"{leaf}: Jacobian gains {gains}")
