"""Exponentially-weighted stochastic-Adams coefficients (paper Eqs. 14-18).

Everything here runs on the host in float64: the coefficients involve
differences of exponentials at nearly-equal log-SNRs whose cancellation is
O(h^s), which f32 or bf16 on the device would destroy. Tables are small
(M x (s+1) scalars) and are shipped to the solve's device as f32 tensors.

Derivation (data prediction, tau constant = tau_i on each interval): with
a = 1 + tau^2, h_i = lambda_{t_{i+1}} - lambda_{t_i} > 0 and the
substitution u = lambda - lambda_{t_{i+1}} in Eq. (15):

    b_{i-j} = alpha_{t_{i+1}} * Int_{-h_i}^{0} e^{a u} l_j(u) du

where l_j is the Lagrange basis over nodes u_k = lambda_{t_{i-k}} -
lambda_{t_{i+1}} (predictor) or additionally u = 0 (corrector, Eq. 18).
The monomial integrals I_k(a, h) = Int_{-h}^{0} e^{a u} u^k du have the
closed-form recursion I_0 = (1 - e^{-a h})/a, I_k = -(-h)^k e^{-a h}/a -
(k/a) I_{k-1}, plus a series form used when a*h is small (the recursion
loses ~k digits of cancellation there).

For noise prediction (Prop. A.1, with the sign of the paper's Eq. (38)
fixed as its own Eq. (41) carries it):

    b^eps_{i-j} = -sigma_{t_{i+1}} * Int_{-h}^{0} a e^{-u} l_j(u) du
    noise_scale^2 = sigma_{t_{i+1}}^2 * 2 tau^2 * (e^{2h} - 1)/2.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .schedules import NoiseSchedule
from .tau import ConstantTau, TauSchedule

__all__ = [
    "IntervalContext", "SATableBuilder", "SolverTables", "TableBuilder",
    "build_tables", "exp_monomial_integrals", "lagrange_coeff_matrix",
    "newton_exp_row",
]


def exp_monomial_integrals(a: float, h: float, k_max: int) -> np.ndarray:
    """I_k = Int_{-h}^{0} e^{a u} u^k du for k = 0..k_max, float64.

    ``a`` may be any real (a >= 1 for data prediction, a = -1 for the
    noise-prediction weight e^{-u}); ``h > 0``.
    """
    if h <= 0:
        raise ValueError("h must be > 0")
    I = np.zeros(k_max + 1, dtype=np.float64)
    if abs(a) * h < 0.5:
        # series: I_k = sum_m a^m (-1)^{k+m} h^{k+m+1} / (m! (k+m+1))
        for k in range(k_max + 1):
            term = 0.0
            am = 1.0  # a^m / m!
            for m in range(0, 40):
                term += am * ((-1.0) ** (k + m)) * h ** (k + m + 1) / (k + m + 1)
                am *= a / (m + 1)
                if abs(am) * h ** (k + m + 2) < 1e-300:
                    break
            I[k] = term
    else:
        E = math.exp(-a * h)
        I[0] = (1.0 - E) / a
        for k in range(1, k_max + 1):
            I[k] = -((-h) ** k) * E / a - (k / a) * I[k - 1]
    return I


def lagrange_coeff_matrix(nodes: np.ndarray) -> np.ndarray:
    """Monomial coefficients of the Lagrange basis over ``nodes``.

    Returns C with shape [n, n]: l_j(u) = sum_m C[j, m] u^m.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    C = np.zeros((n, n), dtype=np.float64)
    for j in range(n):
        others = np.delete(nodes, j)
        # polynomial with roots = others, normalized at nodes[j]
        poly = np.poly(others) if n > 1 else np.array([1.0])
        denom = np.prod(nodes[j] - others) if n > 1 else 1.0
        poly = poly / denom
        # np.poly returns highest-degree first -> reverse to u^m order
        C[j, : n] = poly[::-1]
    return C


def newton_exp_row(nodes: np.ndarray, h: float, a: float) -> np.ndarray:
    """``Int_{-h}^0 e^{a u} l_j(u) du`` over the Lagrange basis on ``nodes``,
    reduced through the Newton (divided-difference) form of the
    interpolant instead of the monomial expansion of each basis
    polynomial: the coefficient of ``f(v_j)`` is ``sum_{k>=j} N_k /
    prod_{m<=k, m!=j}(v_j - v_m)`` with ``N_k = Int_{-h}^0 e^{a u}
    prod_{m<k}(u - v_m) du``.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    I = exp_monomial_integrals(a, h, n - 1)
    b = np.zeros(n, dtype=np.float64)
    for k in range(n):
        pk = np.poly(nodes[:k]) if k else np.array([1.0])
        N_k = float(pk[::-1] @ I[: k + 1])
        for j in range(k + 1):
            w = 1.0
            for m in range(k + 1):
                if m != j:
                    w /= nodes[j] - nodes[m]
            b[j] += w * N_k
    return b


@dataclasses.dataclass(frozen=True)
class IntervalContext:
    """Host-side view of one grid interval ``t_i -> t_{i+1}`` (float64),
    handed to a :class:`TableBuilder` for every interval."""

    i: int
    lams: np.ndarray    # full grid log-SNRs (M+1,)
    alphas: np.ndarray  # schedule alpha on the grid (M+1,)
    sigmas: np.ndarray  # schedule sigma on the grid (M+1,)
    tau: float          # this interval's tau (already through map_taus)

    @property
    def h(self) -> float:
        """Log-SNR step ``lambda_{i+1} - lambda_i > 0``."""
        return float(self.lams[self.i + 1] - self.lams[self.i])

    @property
    def alpha_next(self) -> float:
        return float(self.alphas[self.i + 1])

    @property
    def sigma_next(self) -> float:
        return float(self.sigmas[self.i + 1])


class TableBuilder:
    """Per-family coefficient rule: turns grid intervals into table rows.

    - ``parameterization``: which prediction convention the rows weight
      ("data" or "noise").
    - ``map_taus(taus)``: family-level tau semantics (identity by default).
    - ``decay_noise(ctx)``: ``(decay_i, noise_i)`` — coefficient of the
      carried state and std-dev of the injected Gaussian for interval i.
    - ``row(ctx, order, include_new)``: length-``order`` (+1 when
      ``include_new``) coefficient row for the newest-first history nodes;
      with ``include_new`` entry 0 weights the predicted-point eval.

    The warm-up ramp (effective order ``min(i+1, requested)``) and the
    padding to the shared buffer width R live in :func:`build_tables`.
    """

    parameterization: str = "data"

    def map_taus(self, taus: np.ndarray) -> np.ndarray:
        return taus

    def decay_noise(self, ctx: IntervalContext) -> tuple[float, float]:
        raise NotImplementedError

    def row(self, ctx: IntervalContext, order: int, include_new: bool) -> np.ndarray:
        raise NotImplementedError


class SATableBuilder(TableBuilder):
    """SA-Solver rows (paper Eqs. 14-18)."""

    def __init__(self, parameterization: str = "data"):
        if parameterization not in ("data", "noise"):
            raise ValueError(parameterization)
        self.parameterization = parameterization

    def decay_noise(self, ctx: IntervalContext) -> tuple[float, float]:
        i = ctx.i
        h = ctx.lams[i + 1] - ctx.lams[i]
        t2 = ctx.tau ** 2
        if self.parameterization == "data":
            decay = (ctx.sigmas[i + 1] / ctx.sigmas[i]) * math.exp(-t2 * h)
            noise = ctx.sigmas[i + 1] * math.sqrt(
                max(-math.expm1(-2.0 * t2 * h), 0.0))
        else:
            # Prop A.1: alpha-ratio decay (no tau damping) and the Ito
            # variance sigma_next^2 * 2 tau^2 * (e^{2h} - 1)/2
            decay = ctx.alphas[i + 1] / ctx.alphas[i]
            j0 = (math.exp(2.0 * h) - 1.0) / 2.0 if h > 0 else 0.0
            noise = ctx.sigmas[i + 1] * math.sqrt(max(2.0 * t2 * j0, 0.0))
        return decay, noise

    def row(self, ctx: IntervalContext, order: int, include_new: bool) -> np.ndarray:
        return _interval_coeffs(
            ctx.lams, ctx.i, order, ctx.tau,
            ctx.alphas[ctx.i + 1], ctx.sigmas[ctx.i + 1],
            self.parameterization, include_new=include_new,
        )


@dataclasses.dataclass
class SolverTables:
    """Per-step constant tables consumed by the sampling loop.

    All arrays are float64 numpy on the host; the plan converts them to
    f32 tensors. M = number of intervals; P = predictor max order;
    C = corrector max order.

    decay[i]        : coefficient of x_{t_i} in both Eq. (14) and Eq. (17)
    noise[i]        : sigma-tilde_i  (std of the injected Gaussian)
    pred[i, j]      : coefficient of buffer eval at t_{i-j}  (j = 0..P-1)
    corr_new[i]     : b-hat_{i+1}, coefficient of the predicted-point eval
    corr[i, j]      : b-hat_{i-j}, coefficient of buffer eval at t_{i-j}
    ts, lams        : the grid (M+1,)
    taus            : per-interval tau (M,)
    """

    ts: np.ndarray
    lams: np.ndarray
    taus: np.ndarray
    decay: np.ndarray
    noise: np.ndarray
    pred: np.ndarray
    corr_new: np.ndarray
    corr: np.ndarray
    predictor_order: int
    corrector_order: int
    parameterization: str
    #: schedule values on the grid (M+1,)
    alphas: np.ndarray | None = None
    sigmas: np.ndarray | None = None
    #: per-interval *effective* orders after the warm-up clamp (M,);
    #: set for step-program builds, None for fixed-spec builds
    p_orders: np.ndarray | None = None
    c_orders: np.ndarray | None = None

    @property
    def n_steps(self) -> int:
        return len(self.ts) - 1


def _interval_coeffs(
    lams: np.ndarray,
    i: int,
    order: int,
    tau: float,
    alpha_next: float,
    sigma_next: float,
    parameterization: str,
    include_new: bool,
) -> np.ndarray:
    """Coefficients for one interval.

    Returns an array of length order (+1 if include_new): entry 0 is the
    coefficient of the *newest* node. Nodes (in u = lambda - lambda_{i+1}
    coordinates): optionally u=0 (the t_{i+1} predicted-point eval), then
    u_j = lambda_{i-j} - lambda_{i+1} for j = 0..order-1.
    """
    lam_next = lams[i + 1]
    h = lam_next - lams[i]
    nodes = []
    if include_new:
        nodes.append(0.0)
    nodes.extend(lams[i - j] - lam_next for j in range(order))
    nodes = np.asarray(nodes, dtype=np.float64)
    C = lagrange_coeff_matrix(nodes)  # [n, n]
    n = len(nodes)
    if parameterization == "data":
        # Eq. (15) weight (1+tau^2) e^{lambda} e^{-tau^2 (lam_next-lambda)}
        # = (1+tau^2) e^{lam_next} e^{(1+tau^2) u}; sigma_next e^{lam_next}
        # = alpha_next
        a = 1.0 + tau * tau
        I = exp_monomial_integrals(a, h, n - 1)
        return alpha_next * a * (C @ I)
    elif parameterization == "noise":
        # weight -(1+tau^2) e^{-u}; prefactor sigma_next
        a = 1.0 + tau * tau
        I = exp_monomial_integrals(-1.0, h, n - 1)
        return -sigma_next * a * (C @ I)
    raise ValueError(parameterization)  # pragma: no cover


def build_tables(
    schedule: NoiseSchedule,
    ts: np.ndarray,
    *,
    tau: TauSchedule | float = 0.0,
    predictor_order: int = 3,
    corrector_order: int = 0,
    parameterization: str = "data",
    program=None,
    builder: TableBuilder | None = None,
) -> SolverTables:
    """Precompute all per-step solver constants for the grid ``ts``.

    corrector_order = 0 disables the corrector (tables filled with zeros).
    Warm-up (Algorithm 1): at step i (0-based; i+1 prior evals available)
    the effective orders are min(i+1, predictor_order) and
    min(i+1, corrector_order).

    ``program`` (a :class:`repro_torch.core.programs.StepProgram`)
    overrides ``tau``/``predictor_order``/``corrector_order`` with
    *per-interval* tracks: each interval gets its own orders and tau,
    zero-padded into tables of one width ``R = max(P, C, 1,
    program.width)``, so variable-order tables are data to the executor.
    Requested orders are clamped to the same warm-up ramp; a program that
    pins constant order and tau gives byte-identical tables to the fixed
    arguments it shadows.

    ``builder`` selects the family's coefficient rule; the default is
    :class:`SATableBuilder` with the given ``parameterization``, and a
    passed builder's own ``parameterization`` wins over the argument.
    """
    if builder is None:
        builder = SATableBuilder(parameterization)
    parameterization = builder.parameterization
    ts = np.asarray(ts, dtype=np.float64)
    M = len(ts) - 1
    lams = schedule.lam(ts)
    alphas = schedule.alpha(ts)
    sigmas = schedule.sigma(ts)

    if program is not None:
        rp = program.resolve(schedule, ts)
        taus = rp.taus
        p_req = rp.p_orders
        c_req = rp.c_orders
        P = max(1, int(p_req.max()))
        Cn = int(c_req.max())
        R = max(P, Cn, 1, int(program.width))
    else:
        if isinstance(tau, (int, float)):
            tau = ConstantTau(float(tau))
        taus = tau.on_intervals(schedule, ts)
        p_req = np.full(M, max(1, predictor_order), dtype=int)
        c_req = np.full(M, corrector_order, dtype=int)
        P = max(1, predictor_order)
        Cn = corrector_order
        R = max(P, Cn, 1)  # buffer rows: both tables padded to this width
    if len(taus) != M:
        raise ValueError("tau schedule returned wrong length")
    taus = builder.map_taus(np.asarray(taus, dtype=np.float64))

    decay = np.zeros(M)
    noise = np.zeros(M)
    pred = np.zeros((M, R))
    corr_new = np.zeros(M)
    corr = np.zeros((M, R))
    p_eff = np.zeros(M, dtype=int)
    c_eff = np.zeros(M, dtype=int)

    for i in range(M):
        ctx = IntervalContext(
            i=i, lams=lams, alphas=alphas, sigmas=sigmas, tau=taus[i])
        decay[i], noise[i] = builder.decay_noise(ctx)

        p_ord = min(i + 1, max(1, int(p_req[i])))
        p_eff[i] = p_ord
        pred[i, :p_ord] = builder.row(ctx, p_ord, include_new=False)

        if c_req[i] > 0:
            c_ord = min(i + 1, int(c_req[i]))
            c_eff[i] = c_ord
            bc = builder.row(ctx, c_ord, include_new=True)
            corr_new[i] = bc[0]
            corr[i, :c_ord] = bc[1:]

    return SolverTables(
        ts=ts, lams=lams, taus=taus, decay=decay, noise=noise,
        pred=pred, corr_new=corr_new, corr=corr,
        predictor_order=P, corrector_order=Cn,
        parameterization=parameterization,
        alphas=alphas, sigmas=sigmas,
        p_orders=p_eff if program is not None else None,
        c_orders=c_eff if program is not None else None,
    )
