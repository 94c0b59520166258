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
PyTorch version.
"""

from __future__ import annotations

import torch

from . import _build
from .sa_update import _sms, check_operands, launch_args

__all__ = ["sa_fused_update", "sa_fused_update_plain"]

#: kernel launches made by :func:`sa_fused_update` in this process
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


def sa_fused_update(x, buf, xi, coeffs):
    """The Hopper kernel: same contract as :func:`sa_fused_update_plain`,
    CUDA tensors only (raises otherwise). coeffs must be float32 [2, P+2]."""
    global launches
    check_operands(x, buf, xi, coeffs, rows=2)
    pred = torch.empty_like(x)
    corr = torch.empty_like(x)
    lib = _build.load("sa_combine")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sa_fused_launch(
        *launch_args(x, buf, xi, coeffs, (pred, corr), _sms(x.device)), stream)
    _build.check(rc, "sa_fused_update")
    launches += 1
    return pred, corr
