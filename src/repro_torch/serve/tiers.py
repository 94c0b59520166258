"""Quality tiers: named program presets as the serving-side knob.

A request shouldn't have to spell out a :class:`SamplerSpec` — the
product-level contract is "draft / standard / best". A
:class:`QualityTiers` map resolves each tier name to a full spec (family
+ NFE-derived step count + :class:`~repro_torch.core.programs.StepProgram`),
and :meth:`ServeEngine.submit` accepts ``quality_tier=`` in place of a
spec. Resolution happens at submit time, so the tier joins the bucket
key *via the resolved spec* — tier requests reuse all existing
bucket/compile/warmup machinery, and a tier request is **bitwise
identical** to submitting its resolved spec explicitly (same spec →
same bucket → same per-rid generator seeds).

Tiers are plain data: build them from presets (:func:`default_tiers`),
from a finished autotuner artifact (:meth:`QualityTiers.from_artifact` —
the searched winner becomes ``"best"``; the artifact may come from this
package's autotuner or the reference's, whose format it shares), or by
hand from any specs.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

from ..core.programs import program_preset_for_nfe
from ..core.samplers import SamplerSpec, get_family

__all__ = ["QualityTiers", "default_tiers"]


@dataclasses.dataclass(frozen=True)
class QualityTiers:
    """Immutable tier-name -> SamplerSpec map."""

    specs: Mapping[str, SamplerSpec]

    def __post_init__(self):
        specs = dict(self.specs)
        for name, spec in specs.items():
            if not isinstance(spec, SamplerSpec):
                raise TypeError(
                    f"tier {name!r} must map to a SamplerSpec, got "
                    f"{type(spec).__name__}")
        object.__setattr__(self, "specs", specs)

    def names(self) -> list[str]:
        return sorted(self.specs)

    def resolve(self, tier: str) -> SamplerSpec:
        try:
            return self.specs[tier]
        except KeyError:
            raise ValueError(
                f"unknown quality tier {tier!r}; have {self.names()}")

    def with_tier(self, name: str, spec: SamplerSpec) -> "QualityTiers":
        return QualityTiers({**self.specs, name: spec})

    @classmethod
    def from_artifact(cls, path: str, *, tier: str = "best",
                      fc_tier: str | None = "draft",
                      base: "QualityTiers | None" = None,
                      **overrides) -> "QualityTiers":
        """Load a finished search artifact's winner(s) as tiers.

        The winner's spec is rebuilt exactly as the search evaluated it
        (family, NFE, spec_kw from the artifact's echoed config), so
        serving the tier reproduces the searched program bitwise;
        ``overrides`` adjust serving-only fields (e.g. ``combine``,
        ``precision``). When the artifact also records a feature-cache
        winner (a search run with ``fc_thresholds``), its tuned
        residual-threshold spec becomes the ``fc_tier`` tier — the
        cheap-eval draft rung, autotuned instead of hand-set (pass
        ``fc_tier=None`` to skip). The remaining tiers come from
        ``base`` (default: :func:`default_tiers` for the artifact's
        family on the winner's schedule)."""
        from ..tune.search import (fc_spec_from_state, load_state,
                                   spec_from_state)
        state = load_state(path)
        spec = spec_from_state(state, **overrides)
        if base is None:
            fam = (spec.name if get_family(spec.name).full_programs
                   else "sa")
            base = default_tiers(family=fam, schedule=spec.schedule)
        tiers = base.with_tier(tier, spec)
        if fc_tier and state.get("best_fc"):
            tiers = tiers.with_tier(fc_tier, fc_spec_from_state(state))
        return tiers


def default_tiers(*, family: str = "sa", schedule="vp_linear",
                  tau: float = 1.0, feature_cache=None,
                  **spec_kw) -> QualityTiers:
    """The out-of-the-box draft/standard/best ladder, per family.

    Hand-tuned presets over any multistep-core family (``family`` must
    have ``full_programs`` in the registry — the baselines only honor
    tau tracks, and a ladder of inert presets would be a lie): ``draft``
    spends 6 NFE on an annealed-tau program, ``standard`` 8 NFE on the
    recorded ``nfe8-gmm`` winner shape, ``best`` 20 NFE on the same
    shape (corrector through the coarse phase, predictor-only tail, tau
    annealed to 0). Override ``best`` with a searched program via
    :meth:`QualityTiers.from_artifact`.

    The ``seeds`` ladder is predictor-only (``corrector_order=0``) at
    every rung: the published SEEDS solvers have no corrector, and at
    large tau a high-order corrector amplifies the injected noise (see
    ``repro_torch.core.samplers.seeds``). For ``dpmpp_multistep`` the tau
    tracks are inert (its builder zeroes them) and the order/mode
    structure of the presets carries the ladder.

    ``feature_cache`` (an int refresh interval or ``("residual",
    thresh)``) turns the draft tier into the cheap-eval preset: draft
    keeps its 6-NFE budget but trades the tau-anneal *program* for
    DeepCache-style feature reuse inside the backbone (the two knobs
    don't compose — a program's per-step cond dispatch would nest with
    the cached-eval dispatch). Standard/best stay uncached: the tier
    ladder then spans eval-cost as well as solver quality.
    """
    if not get_family(family).full_programs:
        raise ValueError(
            f"default_tiers needs a full-programs family (the multistep "
            f"core: sa, seeds, dpmpp_multistep); {family!r} only honors "
            "tau tracks, so the preset ladder would be inert")

    if family == "seeds":
        # predictor-only ladder (see docstring); no step program — the
        # presets' corrector segments are exactly what seeds must avoid
        def spec(nfe):
            return SamplerSpec.from_nfe(
                family, nfe, schedule=schedule, tau=tau,
                corrector_order=0, mode="PEC", **spec_kw)
        draft, standard, best = spec(6), spec(8), spec(20)
        if feature_cache is not None:
            draft = draft.replace(feature_cache=feature_cache)
    else:
        def spec(nfe, preset):
            return SamplerSpec.from_nfe(
                family, nfe, schedule=schedule,
                program=program_preset_for_nfe(preset, nfe, tau=tau),
                **spec_kw)
        if feature_cache is None:
            draft = spec(6, "tau-anneal")
        else:
            draft = SamplerSpec.from_nfe(
                family, 6, schedule=schedule, tau=tau,
                feature_cache=feature_cache, **spec_kw)
        standard, best = spec(8, "nfe8-gmm"), spec(20, "nfe8-gmm")
    return QualityTiers({
        "draft": draft,
        "standard": standard,
        "best": best,
    })
