"""repro_torch.core.samplers — plan/execute sampling API of the port.

    from repro_torch.core import samplers

    s = samplers.make_sampler("sa", nfe=20, tau=0.4)
    g = torch.Generator("cuda").manual_seed(0)
    x0 = s.sample(model_fn, s.init_noise(g, (4096, 2)), g)

One registry covers the three multistep-core families ("sa", "seeds",
"dpmpp_multistep": see ``multistep`` for the shared executor and
``coefficients.TableBuilder`` for adding another) and the paper's six
baselines ("ddim", "ddpm_ancestral", "dpm_solver_pp_2m",
"euler_maruyama", "edm_heun", "edm_stochastic": see ``baselines``), each
with its step-granular adapter (``stepwise``: the tick the step scheduler
serves); ``list_samplers()`` enumerates them.
"""

from ..denoiser import (PREDICTION_TYPES, Denoiser, canonical_prediction,
                        convert_prediction)
from .base import (
    Sampler,
    SamplerFamily,
    SamplerPlan,
    SamplerSpec,
    build_plan,
    carry_dtype,
    clear_compile_cache,
    compile_cache_stats,
    cond_struct,
    eager,
    get_family,
    list_samplers,
    make_sampler,
    register_sampler,
    sample,
    sample_batched,
    sample_sharded,
    warmup,
)
from .stepwise import (
    StepAdapter,
    StepFns,
    clear_stepwise_cache,
    fresh_carry,
    make_stepfns,
    stepwise_adapter,
    stepwise_cache_stats,
    stepwise_supported,
)

# importing the family modules registers them
from . import sa as _sa_family  # noqa: F401
from . import seeds as _seeds_family  # noqa: F401
from . import dpmpp as _dpmpp_family  # noqa: F401
from . import baselines as _baseline_families  # noqa: F401
from .multistep import make_multistep_family, tables_to_arrays

__all__ = [
    "Denoiser", "PREDICTION_TYPES", "canonical_prediction",
    "convert_prediction", "Sampler", "SamplerFamily", "SamplerPlan",
    "SamplerSpec", "build_plan", "carry_dtype", "get_family",
    "list_samplers", "make_sampler", "register_sampler", "sample",
    "warmup", "compile_cache_stats", "clear_compile_cache", "eager",
    "make_multistep_family", "tables_to_arrays", "sample_batched",
    "sample_sharded", "cond_struct", "StepAdapter", "StepFns",
    "clear_stepwise_cache", "fresh_carry", "make_stepfns", "stepwise_adapter",
    "stepwise_cache_stats", "stepwise_supported",
]
