"""SA-Solver (paper Algorithm 1) on the multistep-integrator core.

SA is the default :class:`repro_torch.core.coefficients.SATableBuilder`
rule registered through :mod:`repro_torch.core.samplers.multistep`; the
plan, executor and statics come from that core. ``spec.parameterization``
selects the prediction convention ("data" or "noise") directly, and
``spec.tau`` is the live stochasticity control (tau=0 is the ODE limit).
"""

from __future__ import annotations

from ..coefficients import SATableBuilder
from .base import SamplerSpec
from .multistep import make_multistep_family

__all__ = ["FAMILY"]


def _builder(spec: SamplerSpec) -> SATableBuilder:
    return SATableBuilder(spec.parameterization)


FAMILY = make_multistep_family("sa", _builder)
