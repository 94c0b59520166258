"""Plan-keyed microbatching for the diffusion serve engine.

Requests are grouped by **bucket key**, ``(SamplerSpec, latent shape,
dtype, cond structure)``, because that tuple determines the compiled
executor: the spec fixes the sampler family and its statics (the
prediction type, guidance on/off, the history layout, the precision
policy, the step program's mode pattern), the shape and dtype fix the
buffers, and the conditioning joins only by its shape and dtype.
Everything else (tau, per-interval program orders and taus, coefficient
tables, grid values, cond values, the guidance scale) is data copied into
the executor's buffers, so requests that differ only in those ride one
compile-cache entry.

Within a bucket-key group, requests are chunked FIFO into microbatches of
at most ``max(bucket_sizes)``; a ragged tail takes the *smallest*
configured bucket that fits it and is padded with masked dummy lanes
(``PAD_RID``), never with a duplicated request. Padded lanes are computed
(fixed batch shapes are what make the cache work) and their outputs
dropped.

Per-request randomness comes from generator seeds derived from the
request id alone: :func:`fold_keys` gives ``seed(base, rid)`` and
:func:`retry_fold` folds in a retry's attempt count (attempt 0 keeps the
seed). A request's initial noise and step noise therefore do not depend on
the microbatch it lands in, its lane, or the scheduler. Within one bucket
size re-bucketing cannot change a request's bytes (lanes are independent
in every op); across bucket sizes the backbone's products run at another
batch, and results agree to float rounding.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Sequence

import numpy as np
import torch

from ..core.samplers import SamplerSpec, cond_struct

__all__ = [
    "PAD_RID",
    "Request",
    "MicroBatch",
    "bucket_key",
    "choose_bucket",
    "cond_struct",
    "form_microbatches",
    "fold_keys",
    "retry_fold",
    "request_draws",
]

#: rid assigned to padded lanes; int32-max so it cannot collide with real
#: engine-assigned ids (which count up from 0)
PAD_RID = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class Request:
    """One sampling request: which sampler configuration, what latent,
    and, for Denoiser-backed engines, its conditioning and guidance scale
    (data: only cond's shape and dtype enter the bucket key)."""

    rid: int
    spec: SamplerSpec
    shape: tuple[int, ...]
    dtype: str = "float32"
    cond: Any = None
    guidance_scale: float = 1.0
    # -- scheduling metadata (step scheduler; NOT in the bucket key) --
    #: higher runs first (ties broken by deadline, then arrival)
    priority: int = 0
    #: absolute ``time.monotonic()`` deadline; pending requests past it
    #: are shed with ``status="shed"`` instead of joining a batch
    deadline: float | None = None
    #: masked early-exit tolerance on the per-step predictor-vs-corrector
    #: residual; <= 0 disables (the disabled path is the whole solve's)
    early_exit_tol: float = 0.0
    #: steps a lane must complete before early exit may fire; None
    #: defaults to the spec's solver order
    min_steps: int | None = None
    # -- retry bookkeeping (set by the engine when a failed request is
    # re-enqueued; not in the bucket key either) --
    #: 0 for the original submission, one more per retry; folds into the
    #: generator seeds (attempt 0 is the base stream)
    attempt: int = 0
    #: ``time.monotonic()`` before which the retry must not be served
    #: (exponential backoff after host-side faults; 0 = immediately)
    not_before: float = 0.0
    #: label of the degradation-ladder rung this retry runs at (a tier
    #: name or "tau0"); None while undegraded
    degraded_to: str | None = None


def bucket_key(req: Request) -> tuple:
    """The executor identity this request is served under."""
    return (req.spec, req.shape, req.dtype, cond_struct(req.cond))


@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """A bucket's worth of work: ``size`` lanes, ``requests`` real ones."""

    key: tuple
    requests: tuple[Request, ...]
    size: int  # padded lane count (a configured bucket size)

    @property
    def n_padded(self) -> int:
        return self.size - len(self.requests)

    @property
    def spec(self) -> SamplerSpec:
        return self.key[0]

    @property
    def shape(self) -> tuple[int, ...]:
        return self.key[1]

    @property
    def dtype(self) -> str:
        return self.key[2]

    def rids(self) -> list[int]:
        """Lane rids including pad slots."""
        return [r.rid for r in self.requests] \
            + [PAD_RID] * (self.size - len(self.requests))

    def stacked_cond(self, device) -> torch.Tensor | None:
        """Per-lane conditioning [size, ...] on ``device``: the real
        requests' conds stacked, pad lanes zeros (the null conditioning;
        their outputs are dropped). None when the bucket is
        unconditional."""
        c0 = self.requests[0].cond
        if c0 is None:
            return None
        conds = [torch.as_tensor(r.cond) for r in self.requests]
        conds += [torch.zeros_like(conds[0])] * self.n_padded
        return torch.stack(conds).to(device)

    def scales(self) -> torch.Tensor:
        """Per-lane guidance scales [size] (pad lanes at 1.0)."""
        return torch.tensor(
            [float(r.guidance_scale) for r in self.requests]
            + [1.0] * self.n_padded, dtype=torch.float32)


def choose_bucket(n: int, bucket_sizes: Sequence[int]) -> int:
    """Smallest configured bucket that fits ``n`` lanes (the largest
    bucket if none does: callers chunk to ``max(bucket_sizes)`` first)."""
    if n < 1:
        raise ValueError("empty microbatch")
    for b in sorted(bucket_sizes):
        if b >= n:
            return b
    return max(bucket_sizes)


def form_microbatches(requests: Sequence[Request],
                      bucket_sizes: Sequence[int]) -> list[MicroBatch]:
    """Group FIFO by bucket key, chunk to the largest bucket, size tails.

    Returns microbatches in first-arrival order of their bucket key, so a
    drain loop serves oldest work first.
    """
    if not bucket_sizes:
        raise ValueError("need at least one bucket size")
    cap = max(bucket_sizes)
    groups: OrderedDict[tuple, list[Request]] = OrderedDict()
    for r in requests:
        groups.setdefault(bucket_key(r), []).append(r)
    out = []
    for key, group in groups.items():
        for i in range(0, len(group), cap):
            chunk = tuple(group[i:i + cap])
            out.append(MicroBatch(key=key, requests=chunk,
                                  size=choose_bucket(len(chunk),
                                                     bucket_sizes)))
    return out


def _fold(seed: int, data: int) -> int:
    """A 64-bit generator seed from ``(seed, data)`` (numpy's
    SeedSequence hash: distinct inputs give independent streams)."""
    ss = np.random.SeedSequence([int(seed) % 2**64, int(data) % 2**64])
    return int(ss.generate_state(1, np.uint64)[0])


def fold_keys(base: int, rids) -> list[int]:
    """Per-lane generator seeds ``seed(base, rid)``: pure in the rid, so
    the same rid draws the same noise whatever bucket, lane or scheduler
    serves it."""
    return [_fold(base, r) for r in rids]


def retry_fold(seeds, attempts) -> list[int]:
    """Fresh per-attempt seeds: ``seed(seed, attempt)`` per lane, so a
    retried request never replays the stream that just failed. Attempt 0
    keeps the seed, which preserves every fault-free contract."""
    return [s if int(a) == 0 else _fold(s, a)
            for s, a in zip(seeds, attempts)]


def request_draws(noise_seed: int, solve_seed: int, rid: int, attempt: int,
                  shape, M: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """One request's unit-normal draws on ``device``: the initial latent
    ``z`` [*shape] from the generator seeded ``seed(noise_seed, rid)`` and
    the [M, *shape] step noise from ``seed(solve_seed, rid)``, both folded
    with the attempt (float32; the engine scales ``z`` by the plan's prior
    scale)."""
    nk, sk = (retry_fold(fold_keys(base, [rid]), [attempt])[0]
              for base in (noise_seed, solve_seed))
    device = torch.device(device)
    z = torch.randn(tuple(shape), device=device,
                    generator=torch.Generator(device).manual_seed(nk))
    noise = torch.randn((M,) + tuple(shape), device=device,
                        generator=torch.Generator(device).manual_seed(sk))
    return z, noise
