"""Fused SA-Solver state update (the paper's per-step hot spot).

    x' = decay * x + sum_{j<P} b_j * buf[j] + noise * xi

Coefficients arrive as one f32 vector [P+2] = (decay, noise, b_0..b_{P-1}).
``sa_update`` launches the hand-written Hopper kernel
(``csrc/sa_combine.cu``): one pass over x, xi and the P stacked history
rows, f32 accumulation, one write. ``sa_update_plain`` is the same
function in plain PyTorch; the CPU path and the card-side checks use it.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["sa_update", "sa_update_plain", "MAX_ROWS", "DTYPE_CODES"]

#: most history rows the kernel is instantiated for
MAX_ROWS = 5
#: operand dtypes the combine kernels take, with their C codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches made by :func:`sa_update` in this process
launches = 0


def sa_update_plain(x, buf, xi, coeffs):
    """x [*shape]; buf [P, *shape]; xi [*shape]; coeffs [P+2] packed as
    (decay, noise, b_0..b_{P-1}). Returns x' with x.dtype.

    Dtype-gated like the reference oracle: at f32 one contraction over
    the rows; for narrow (bf16) histories an unrolled f32 multiply-add
    chain in the kernel's accumulation order."""
    c = coeffs.to(torch.float32)
    if buf.dtype == torch.float32:
        acc = torch.einsum("p,p...->...", c[2:], buf)
        return (c[0] * x.float() + acc + c[1] * xi.float()).to(x.dtype)
    acc = c[0] * x.float() + c[1] * xi.float()
    for j in range(buf.shape[0]):
        acc = acc + c[2 + j] * buf[j].float()
    return acc.to(x.dtype)


def check_operands(x, buf, xi, coeffs, rows: int) -> None:
    """Raise on what the combine kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"the combine kernels take CUDA tensors, got {x.device}")
    for name, t in (("buf", buf), ("xi", xi), ("coeffs", coeffs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"combine kernels take float32 or bfloat16, got {x.dtype}")
    if buf.dtype != x.dtype or xi.dtype != x.dtype:
        raise TypeError(f"x, buf and xi must share a dtype: {x.dtype}, "
                        f"{buf.dtype}, {xi.dtype}")
    P = buf.shape[0]
    if not 1 <= P <= MAX_ROWS:
        raise ValueError(f"history rows P={P}; the kernel takes 1..{MAX_ROWS}")
    if tuple(buf.shape[1:]) != tuple(x.shape) or xi.shape != x.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)}, buf {tuple(buf.shape)}, "
                         f"xi {tuple(xi.shape)}")
    if coeffs.dtype != torch.float32 or tuple(coeffs.shape) != (rows, P + 2):
        raise ValueError(f"coeffs must be float32 {(rows, P + 2)}, got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    for name, t in (("x", x), ("buf", buf), ("xi", xi), ("coeffs", coeffs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sa_update(x, buf, xi, coeffs):
    """The Hopper kernel: same contract as :func:`sa_update_plain`, CUDA
    tensors only (raises otherwise). coeffs must be float32 [P+2]."""
    global launches
    check_operands(x, buf, xi, coeffs.reshape(1, -1), rows=1)
    out = torch.empty_like(x)
    lib = _build.load("sa_combine")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.sa_update_launch(x.data_ptr(), buf.data_ptr(), xi.data_ptr(),
                              coeffs.data_ptr(), out.data_ptr(), x.numel(),
                              buf.shape[0], DTYPE_CODES[x.dtype], stream)
    _build.check(rc, "sa_update")
    launches += 1
    return out
