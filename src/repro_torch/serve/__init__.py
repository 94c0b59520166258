"""repro_torch.serve — continuously batched diffusion serving on one device,
or sharded over a mesh's ranks.

Turns the plan/execute sampler registry into a service: requests carrying
any registered :class:`~repro_torch.core.samplers.SamplerSpec` are
queued, bucketed, warmed, and solved together on one device (the card
unless the caller asks for the CPU).

::

    submit(spec, shape)                          ServeResult(rid, x0,
         │                                          previews) ── on_result
         ▼                                              ▲
      queue ──▶ bucket by (spec, shape, dtype, cond)    │ pad lanes
                 │  FIFO chunks ≤ max bucket;           │ dropped
                 │  ragged tail -> smallest bucket,     │
                 │  masked pad lanes (PAD_RID)          │
                 ▼                                      │
      per-lane generators seeded by (seed, rid)         │
      (bucket-independent: re-bucketing never           │
       changes a request's noise)                       │
                 │                                      │
      warmup per bucket (on the card a CUDA graph;      │
      tau & tables are data, so sweeps replay it)       │
                 │                                      │
                 ├─ scheduler="solve": sample_batched ──┤
                 │  (one solve over the stacked lanes)  │
                 └─ scheduler="step": ContinuousBatcher ┘
                    (one lane-batched tick per call;
                     joins, early exit, migration)

The model is lane-batched: ``model_fn(x [L, *shape], t [L])``, or a
:class:`~repro_torch.core.denoiser.Denoiser` over such a network.

Quickstart::

    from repro_torch.core.samplers import SamplerSpec
    from repro_torch.serve import ServeEngine

    engine = ServeEngine(model_fn, bucket_sizes=(1, 2, 4, 8))
    spec = SamplerSpec.from_nfe("sa", 15, tau=0.6)
    rids = [engine.submit(spec, shape=(256, 16)) for _ in range(12)]
    results = engine.run()          # list[ServeResult], service order
    print(engine.stats())           # requests/s, model-evals/s, ...

Fault tolerance (:mod:`repro_torch.serve.faults` and engine knobs):
per-lane numerical guards (``guard_interval``, carry data), per-bucket
containment, bounded retry with degradation (``max_retries``,
``degrade_ladder``; each retry folds its attempt into the generator
seeds, attempt 0 stays the base stream), consecutive-failure quarantine
with cooldown, a straggler watchdog, and a seeded chaos harness
(:class:`FaultPlan`/:class:`FaultInjector`). ``ServeEngine.health()`` is
the poll surface.

Sharding (:mod:`repro_torch.serve.sharding`): ``ServeEngine(mesh=,
data_axis=, cfg_axis=)`` places each microbatch's lanes on a mesh's data
axis through ``sample_sharded`` (and the guided pair on a size-2 cfg
axis); ``align_bucket_sizes`` rounds the buckets to the data axis,
``auto_mesh`` / ``auto_cfg_mesh`` build a mesh over every rank.
"""

from .batching import (MicroBatch, PAD_RID, Request, bucket_key,
                       choose_bucket, cond_struct, fold_keys,
                       form_microbatches, request_draws, retry_fold)
from .continuous import ContinuousBatcher, RunningBatch, bucket_label
from .engine import ServeEngine, ServeResult
from .faults import Fault, FaultInjector, FaultPlan, poison_lane
from .sharding import align_bucket_sizes, auto_mesh, data_axis_size
from .tiers import QualityTiers, default_tiers

__all__ = [
    "ContinuousBatcher",
    "Fault",
    "FaultInjector",
    "FaultPlan",
    "MicroBatch",
    "PAD_RID",
    "QualityTiers",
    "Request",
    "RunningBatch",
    "ServeEngine",
    "ServeResult",
    "bucket_label",
    "align_bucket_sizes",
    "auto_mesh",
    "bucket_key",
    "choose_bucket",
    "cond_struct",
    "data_axis_size",
    "default_tiers",
    "fold_keys",
    "form_microbatches",
    "poison_lane",
    "request_draws",
    "retry_fold",
]
