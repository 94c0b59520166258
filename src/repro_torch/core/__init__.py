"""repro_torch.core — SA-Solver on PyTorch: schedules, tau schedules, the
float64 coefficient engine, per-step solver programs, the multistep
sampler core (SA, SEEDS, DPM-Solver++), the paper's six baselines, the
legacy ``SASolver`` and ``baselines`` surface, the denoiser adapter, and
the analytic GMM oracle with its metric and inaccurate-model wrapper.

Sampling entry point: ``make_sampler(name, nfe=..., ...)``.
"""

from .coefficients import SolverTables, build_tables, exp_monomial_integrals
from .denoiser import (CachedNetwork, Denoiser, canonical_prediction,
                       convert_prediction)
from .oracle import GMM, gaussian_oracle, perturb_model
from .programs import (StepProgram, list_presets, parse_program,
                       program_preset)
from . import samplers
from .samplers import (Sampler, SamplerPlan, SamplerSpec,
                       clear_compile_cache, compile_cache_stats,
                       list_samplers, make_sampler, register_sampler, warmup)
from .schedules import (EDMSchedule, NoiseSchedule, VESchedule,
                        VPCosineSchedule, VPLinearSchedule, get_schedule,
                        timestep_grid)
from .solver import SASolver, SASolverConfig, sample
from .tau import BandedTau, ConstantTau, DDIMEtaTau, TauSchedule

__all__ = [
    "samplers", "CachedNetwork", "Denoiser", "canonical_prediction",
    "convert_prediction",
    "Sampler", "SamplerPlan", "SamplerSpec", "make_sampler",
    "register_sampler", "list_samplers", "warmup", "compile_cache_stats",
    "clear_compile_cache", "SolverTables", "build_tables",
    "exp_monomial_integrals", "NoiseSchedule", "VPLinearSchedule",
    "VPCosineSchedule", "VESchedule", "EDMSchedule", "get_schedule",
    "timestep_grid", "TauSchedule", "ConstantTau", "BandedTau", "DDIMEtaTau",
    "StepProgram", "program_preset", "list_presets", "parse_program",
    "GMM", "gaussian_oracle", "perturb_model", "SASolver", "SASolverConfig",
    "sample",
]
