"""int8 gradient compression with error feedback.

The data-parallel gradient all-reduce is the dominant collective across
many ranks; int8 quantization cuts its bytes 4x (vs float32 gradients) at
the cost of quantization noise. Error feedback (Seide et al. / EF-SGD)
keeps the *accumulated* quantization error in a local residual buffer and
re-adds it before the next quantization, which restores convergence to
the uncompressed fixed point.

Two entry points, the reference's:
- ``compressed_psum(x, group)``: a drop-in for an all-reduce over the
  ranks of ``group`` — the scale is all-reduced by MAX first so every rank
  quantizes alike, then the int8 values are summed as int32 and
  dequantized.
- ``make_compressed_grad_transform()``: an ``optim.chain`` element that
  quantizes with error feedback outside any collective; its residual is
  float32 optimiser state shaped like the parameters.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..optim import Optimizer
from ..tree import leaves_like, tree_leaves, unflatten_like

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum",
           "make_compressed_grad_transform"]


def quantize_int8(x, scale=None):
    """Symmetric per-tensor int8 (round half to even, clipped to ±127).
    Returns (q, scale)."""
    x32 = x.float()
    if scale is None:
        scale = torch.max(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (the default group
    when None) as int8 on the wire: max |x| all-reduced by MAX, scale =
    max / 127 + 1e-12, ``round(x / scale)`` clipped to ±127 summed as
    int32, times the scale. Returns float32."""
    x32 = x.float()
    amax = torch.max(torch.abs(x32)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax[0] / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.float() * scale


def make_compressed_grad_transform(enabled: bool = True) -> Optimizer:
    """Optimizer-chain element: g <- Q(g + residual); residual <- input - g
    (the residual float32, shaped like each parameter)."""

    def init(params):
        if not enabled:
            return ()
        return unflatten_like(params, [
            torch.zeros_like(p, dtype=torch.float32,
                             memory_format=torch.contiguous_format)
            for p in tree_leaves(params)])

    @torch.no_grad()
    def update(grads, state, params=None, step=None, *, donate=False):
        del donate  # functional: new gradients and residuals
        if not enabled:
            return grads, state

        def one(g, r):
            target = g.float() + r
            q, s = quantize_int8(target)
            out = dequantize_int8(q, s)
            return out.to(g.dtype), target - out

        outs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                          leaves_like(grads, state))]
        return (unflatten_like(grads, [o[0] for o in outs]),
                unflatten_like(grads, [o[1] for o in outs]))

    return Optimizer(init, update)
