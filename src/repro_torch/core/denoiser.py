"""Denoiser adapter layer: raw network -> solver-facing model contract.

Every executor consumes ``model_fn(x, t)`` whose output is the plan's
parameterization (x0-prediction for the "data" SA-Solver path,
eps-prediction for the "noise" path). :class:`Denoiser` wraps a network
of any output convention:

- **prediction-type conversion**: ``convert_prediction`` maps any of
  ``eps``/``x0``/``v`` to any other on the solve's device, using the
  schedule's ``alpha_t``/``sigma_t`` at the evaluation time and the
  identities of ``x_t = alpha_t x_0 + sigma_t eps`` and
  ``v = alpha_t eps - sigma_t x_0``;
- **classifier-free guidance**: the cond and uncond branches run as ONE
  network call over a doubled batch ``[x; x]`` with ``[cond; null]``,
  then combine as ``(1 - s) * uncond + s * cond``. That form, not
  ``uncond + s (cond - uncond)``, makes scale 1.0 exactly the conditional
  branch (``0 * u + c``) of that call.
- **sharded classifier-free guidance**: given a process group of two ranks
  (the ``cfg`` axis of a mesh, ``cfg_group``), group rank 0 evaluates the
  cond branch and group rank 1 the uncond branch, each at the call's own
  batch; one ``all_gather`` over the group gives both halves to both ranks,
  in the one-call pair's order (cond, then uncond), and the combine is the
  same. Both ranks then hold the same bytes of the combined output.
- **feature caching**: a :class:`CachedNetwork` companion evaluates the
  network with the mid-segment of its block stack either recomputed or
  replayed from the previous step (DeepCache); under guidance its
  features carry the doubled batch (under sharded guidance, each rank
  the features of its own branch).

NFE accounting: one guided evaluation costs two network evaluations
(``SamplerSpec.network_nfe``), run as one call over twice the batch.

Lane-batched evaluation (serving): the lane-batched executors
(``sample_batched``, the step protocol) call ``model_fn(x, t)`` with ``x``
[L, *shape] and ``t`` [L], one time per lane, and a per-lane guidance
scale [L]; a lane's output depends on that lane's input only. Every
per-lane value here broadcasts over the lane axis (:func:`lane_view`),
and a 0-d ``t`` or scale keeps the one-solve contract unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..distributed import all_gather
from ..scope import named_scope
from .schedules import NoiseSchedule

__all__ = ["PREDICTION_TYPES", "CachedNetwork", "Denoiser",
           "canonical_prediction", "convert_prediction", "lane_view"]

#: canonical prediction-type names (aliases: "data"/"x0", "noise"/"eps")
PREDICTION_TYPES = ("x0", "eps", "v")

_ALIASES = {
    "data": "x0", "x0": "x0",
    "noise": "eps", "eps": "eps", "epsilon": "eps",
    "v": "v", "v_prediction": "v",
}


def canonical_prediction(name: str) -> str:
    """Normalize a prediction-type name ("data"/"x0", "noise"/"eps", "v")."""
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown prediction type {name!r}; one of "
            f"{sorted(set(_ALIASES))}")


def lane_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-lane ``v`` [L] as [L, 1, ...], broadcasting over the lane axis
    of ``x`` [L, *shape]; a 0-d ``v`` as it is."""
    if v.dim() == 0:
        return v
    return v.reshape(tuple(v.shape) + (1,) * (x.dim() - v.dim()))


def convert_prediction(pred: torch.Tensor, x: torch.Tensor, t, src: str,
                       dst: str, schedule: NoiseSchedule) -> torch.Tensor:
    """Convert a network output between prediction types.

    ``a = alpha_t`` and ``s = sigma_t`` come from the schedule's torch
    functions at ``t`` (a float32 tensor). The operands are promoted to
    the widest of their dtypes and ``t``'s first, so a bfloat16 latent
    converts in float32 as in the reference (PyTorch would otherwise keep
    bfloat16 when a 0-d float32 tensor meets it). The v inversions use the
    general ``1/(a^2 + s^2)`` normalizer so non-VP schedules stay exact.
    A per-lane ``t`` [L] converts each lane of ``x`` [L, *shape] at its
    own time.
    """
    src, dst = canonical_prediction(src), canonical_prediction(dst)
    if src == dst:
        return pred
    a = lane_view(schedule.alpha_d(t), x)
    s = lane_view(schedule.sigma_d(t), x)
    dt = torch.promote_types(torch.promote_types(pred.dtype, x.dtype), a.dtype)
    pred, x = pred.to(dt), x.to(dt)
    if dst == "x0":
        if src == "eps":
            return (x - s * pred) / a
        return (a * x - s * pred) / (a * a + s * s)      # src == "v"
    if dst == "eps":
        if src == "x0":
            return (x - a * pred) / s
        return (s * x + a * pred) / (a * a + s * s)      # src == "v"
    # dst == "v"
    if src == "x0":
        return a * (x - a * pred) / s - s * pred
    return a * pred - s * (x - s * pred) / a             # src == "eps"


def _doubled(t):
    """A per-row value of a guided call's doubled batch (the time, the
    refresh flags): a per-lane ``t`` [L] twice over, in ``_cfg_pair``'s
    row order; a 0-d one (or a Python value) as it is."""
    if isinstance(t, torch.Tensor) and t.dim() == 1:
        return torch.cat([t, t])
    return t


@dataclasses.dataclass(frozen=True, eq=False)
class CachedNetwork:
    """Feature-cached companion of a :class:`Denoiser`'s network
    (DeepCache-style step-to-step activation reuse).

    Args:
        call: ``(x, t, cond, feats, refresh) -> (prediction, new_feats)``.
            With ``refresh`` True (a Python bool) the deep feature segment
            is recomputed and returned; with False the cached ``feats``
            stand in and come back unchanged. ``refresh`` may also be a
            bool tensor on the device, 0-d or one flag per row of ``x``:
            the segment then runs on the device's decision and the
            refreshed rows are written into ``feats`` in place
            (``TransformerLM.denoise_cached``). Predictions follow the
            owning Denoiser's ``prediction`` convention; ``cond`` follows
            its network's contract.
        init: ``(x) -> feats``, the zero features for one network input
            ``x`` (before the Denoiser doubles the batch under guidance).
    """

    call: Callable
    init: Callable


@dataclasses.dataclass(frozen=True, eq=False)
class Denoiser:
    """A raw network wrapped into the solver-facing model contract.

    Args:
        network: ``(x, t, cond) -> prediction`` in ``prediction``'s
            convention, for ``x`` of leading batch axis B. Unconditional
            networks ignore ``cond``. Unguided, ``cond`` is passed as the
            call gave it. Under guidance the network is called once with
            ``x`` doubled to 2B and ``cond`` with a leading batch axis of
            2B (the conditional rows, then the null rows), so it must
            accept a batched ``cond``.
        schedule: the noise schedule whose ``alpha_t``/``sigma_t`` drive
            the prediction conversion. Must match the plan's.
        prediction: the network's output convention (``"eps"``/``"x0"``/
            ``"v"``; aliases ``"noise"``/``"data"`` accepted).
        guidance: enable classifier-free guidance with the per-call
            ``guidance_scale``.
        null_cond: the unconditional conditioning; None means zeros like
            the per-call cond (the null-embedding convention).
        cond_rank: the rank of ONE sample's conditioning, which says how
            guidance batches ``cond`` and ``null_cond``: a tensor of this
            rank is shared by the whole batch and expanded to it, one of
            rank ``cond_rank + 1`` already has the leading batch axis.
            None: every cond is one sample's conditioning, shared by the
            batch (a ``(seq, dz)`` prompt, a ``[d_cond]`` vector). The
            layout is never read from the sizes, so a shared ``(seq, dz)``
            prompt with ``seq == B`` stays shared.
        cached: the feature-cached companion, required by a spec that sets
            ``feature_cache``.
    """

    network: Callable[[torch.Tensor, Any, Any], torch.Tensor]
    schedule: NoiseSchedule
    prediction: str = "eps"
    guidance: bool = False
    null_cond: Any = None
    cond_rank: int | None = None
    cached: CachedNetwork | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "prediction", canonical_prediction(self.prediction))

    def _batched(self, c: torch.Tensor, batch: int) -> torch.Tensor:
        """``c`` with a leading batch axis of ``batch``: a shared cond is
        expanded to it, a per-sample one checked against it."""
        c = torch.as_tensor(c)
        if self.cond_rank is None or c.dim() == self.cond_rank:
            return c.expand((batch,) + tuple(c.shape))
        if c.dim() != self.cond_rank + 1 or c.shape[0] != batch:
            raise ValueError(
                f"cond of shape {tuple(c.shape)} is neither one sample's "
                f"conditioning (rank {self.cond_rank}) nor one per sample "
                f"of a batch of {batch}")
        return c

    def _cfg_pair(self, x: torch.Tensor, cond, cfg_group=None):
        """The doubled batch of one guided call: ``[x; x]`` and
        ``[cond; null]``, each half expanded to the batch of ``x``. Under
        sharded guidance (``cfg_group``) this rank's half only: ``x`` and
        the cond (group rank 0) or the null cond (group rank 1)."""
        null = self.null_cond
        if null is None and cond is not None:
            null = torch.zeros_like(torch.as_tensor(cond))
        if (cond is None) != (null is None):
            raise ValueError("null_cond needs a per-call cond to pair with")
        B = x.shape[0]
        if cfg_group is not None:
            c = cond if dist.get_rank(cfg_group) == 0 else null
            return x, None if c is None else self._batched(c, B)
        xx = torch.cat([x, x])
        if cond is None:
            return xx, None
        return xx, torch.cat([self._batched(cond, B),
                              self._batched(null, B)])

    @staticmethod
    def _halves(out: torch.Tensor, B: int, cfg_group):
        """``(cond, uncond)`` outputs of one guided call: the two halves of
        the doubled batch, or under sharded guidance each rank's branch
        gathered over ``cfg_group``."""
        if cfg_group is None:
            return out[:B], out[B:]
        c_out, u_out = all_gather(out, cfg_group)
        return c_out, u_out

    def statics(self, target: str) -> tuple:
        """What the binding to ``target`` computes, for the compile-cache
        key: everything but the network itself (keyed separately, by weak
        identity) and the per-call cond and scale (data)."""
        return ("denoiser", self.prediction, bool(self.guidance),
                canonical_prediction(target), self.schedule)

    @staticmethod
    def _combine(c_out, u_out, scale):
        # the sampler hands the scale over as a float32 tensor on the
        # device (its compile-cache entry's buffer: 0-d, or [L] per lane),
        # so this reads device data and copies nothing from the host
        s = lane_view(torch.as_tensor(scale, dtype=c_out.dtype,
                                      device=c_out.device), c_out)
        # (1-s)*u + s*c: at s == 1.0 this is exactly the cond branch
        return (1.0 - s) * u_out + s * c_out

    def evaluate(self, x: torch.Tensor, t, cond, scale,
                 cfg_group=None) -> torch.Tensor:
        """One guided (or plain) network evaluation, in ``self.prediction``
        convention. Under guidance both branches run as ONE network call
        over the doubled batch, or with ``cfg_group`` one branch on each
        of its two ranks (sharded guidance).

        The network runs under ``named_scope("backbone")`` (a profiler
        range, and the scope ``launch.op_cost`` reads), as the reference
        runs it under ``jax.named_scope("backbone")``."""
        if not self.guidance:
            with named_scope("backbone"):
                return self.network(x, t, cond)
        xx, cc = self._cfg_pair(x, cond, cfg_group)
        with named_scope("backbone"):
            out = self.network(
                xx, t if cfg_group is not None else _doubled(t), cc)
        return self._combine(*self._halves(out, x.shape[0], cfg_group),
                             scale)

    def init_feats(self, x: torch.Tensor, cfg_group=None):
        """Zero feature cache for one solver state ``x`` (under guidance
        for the doubled batch, matching ``evaluate``'s call; under sharded
        guidance for this rank's branch alone)."""
        if self.cached is None:
            raise ValueError("Denoiser built without cached=")
        f = self.cached.init(x)
        return torch.cat([f, f]) if self.guidance and cfg_group is None \
            else f

    def evaluate_cached(self, x, t, cond, scale, feats, refresh,
                        cfg_group=None):
        """``evaluate`` through the feature-cached network. Returns
        ``(prediction, new_feats)``. ``refresh``: a Python bool, or a
        device bool tensor (0-d, or one flag per row of ``x``, doubled
        with the batch under one-call guidance). Under sharded guidance
        ``feats`` are this rank's branch's, and the refresh flags (read
        from the combined state, the same on both ranks) gate both ranks'
        segments alike."""
        if self.cached is None:
            raise ValueError("Denoiser built without cached=")
        if not self.guidance:
            with named_scope("backbone"):
                return self.cached.call(x, t, cond, feats, refresh)
        xx, cc = self._cfg_pair(x, cond, cfg_group)
        if cfg_group is None:
            t, refresh = _doubled(t), _doubled(refresh)
        with named_scope("backbone"):
            out, new_feats = self.cached.call(xx, t, cc, feats, refresh)
        return (self._combine(*self._halves(out, x.shape[0], cfg_group),
                              scale), new_feats)

    def as_model_fn(self, target: str, cond, scale,
                    cfg_group=None) -> Callable:
        """Bind to a plan's parameterization and one call's conditioning
        and guidance scale (and, for sharded guidance, the cfg group): the
        ``model_fn(x, t)`` the executors consume."""
        target = canonical_prediction(target)

        def model_fn(x, t):
            raw = self.evaluate(x, t, cond, scale, cfg_group)
            return convert_prediction(raw, x, t, self.prediction, target,
                                      self.schedule)

        return model_fn

    def as_cached_model_fn(self, target: str, cond, scale,
                           cfg_group=None) -> Callable:
        """Feature-cached twin of :meth:`as_model_fn`:
        ``model_fn(x, t, feats, refresh) -> (prediction, new_feats)``."""
        target = canonical_prediction(target)

        def model_fn(x, t, feats, refresh):
            raw, new_feats = self.evaluate_cached(x, t, cond, scale, feats,
                                                  refresh, cfg_group)
            return (convert_prediction(raw, x, t, self.prediction, target,
                                       self.schedule), new_feats)

        return model_fn

    def __repr__(self) -> str:
        return (f"Denoiser(prediction={self.prediction!r}, "
                f"guidance={self.guidance}, schedule={self.schedule!r})")
