"""Fused dual-output SA-Solver combine: predictor and corrector partial sums
in one pass over the operands.

    x_pred    = decay * x + sum_j p_j * buf[j] + noise * xi     (predictor)
    corr_base = decay * x + sum_j c_j * buf[j] + noise * xi     (corrector,
                                                   without the new eval)

Coefficients arrive as one f32 matrix [2, P+2], each row packed like
``sa_update`` (row 0 predictor, row 1 corrector). With a ring-buffer
history the caller rotates the coefficient *columns* by the ring head, so
the [P, N] data is never rotated or re-stacked. ``sa_fused_update``
launches the Hopper kernel (``csrc/sa_combine.cu``: each operand read once,
two f32 accumulators, two writes); ``sa_fused_update_plain`` is the plain
PyTorch version. ``sa_fused_update_lanes`` launches the same kernel over L
lanes of their own operands and [2, P+2] coefficients (lane l's outputs
equal a solo launch on lane l bit for bit), beside
``sa_fused_update_lanes_plain``.
"""

from __future__ import annotations

import torch

from .sa_update import check_lane_operands, check_operands, launch_combine

__all__ = ["sa_fused_update", "sa_fused_update_plain",
           "sa_fused_update_lanes", "sa_fused_update_lanes_plain"]

#: kernel launches made by :func:`sa_fused_update` and
#: :func:`sa_fused_update_lanes` in this process
launches = 0


def sa_fused_update_plain(x, buf, xi, coeffs):
    """coeffs [2, P+2] -> ``(x_pred, corr_base)`` with x.dtype: two f32
    accumulators in the kernel's order and rounding, as
    :func:`repro_torch.kernels.sa_update.sa_update_plain` for each row."""
    c = coeffs.to(torch.float32)
    xf = x.float()
    xif = xi.float()
    acc_p = c[0, 0] * xf + c[0, 1] * xif
    acc_c = c[1, 0] * xf + c[1, 1] * xif
    for j in range(buf.shape[0]):
        bj = buf[j].float()
        acc_p = acc_p + c[0, 2 + j] * bj
        acc_c = acc_c + c[1, 2 + j] * bj
    return acc_p.to(x.dtype), acc_c.to(x.dtype)


def sa_fused_update_lanes_plain(x, buf, xi, coeffs):
    """x [L, *shape]; buf [L, P, *shape]; xi [L, *shape]; coeffs
    [L, 2, P+2] -> ``(x_pred, corr_base)``, each [L, *shape]:
    :func:`sa_fused_update_plain` of each lane on its own operands."""
    outs = [sa_fused_update_plain(x[l], buf[l], xi[l], coeffs[l])
            for l in range(x.shape[0])]
    return (torch.stack([p for p, _ in outs]),
            torch.stack([c for _, c in outs]))


def sa_fused_update(x, buf, xi, coeffs):
    """The Hopper kernel: same contract as :func:`sa_fused_update_plain`,
    CUDA tensors only (raises otherwise). coeffs must be float32 [2, P+2]."""
    global launches
    check_operands(x, buf, xi, coeffs, rows=2)
    pred = torch.empty_like(x)
    corr = torch.empty_like(x)
    launch_combine("sa_fused_launch", x, buf, xi, coeffs, (pred, corr))
    launches += 1
    return pred, corr


def sa_fused_update_lanes(x, buf, xi, coeffs):
    """The Hopper kernel over lanes: same contract as
    :func:`sa_fused_update_lanes_plain`, CUDA tensors only (raises
    otherwise). coeffs must be float32 [L, 2, P+2]."""
    global launches
    check_lane_operands(x, buf, xi, coeffs, rows=2)
    pred = torch.empty_like(x)
    corr = torch.empty_like(x)
    launch_combine("sa_fused_launch", x, buf, xi, coeffs, (pred, corr),
                   lanes=x.shape[0])
    launches += 1
    return pred, corr
