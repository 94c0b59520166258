"""Fused SA-Solver state update (the paper's per-step hot spot).

    x' = decay * x + sum_{j<P} b_j * buf[j] + noise * xi

Coefficients arrive as one f32 vector [P+2] = (decay, noise, b_0..b_{P-1}).
``sa_update`` launches the hand-written Hopper kernel
(``csrc/sa_combine.cu``): one pass over x, xi and the P stacked history
rows, f32 accumulation, one write. ``sa_update_plain`` is the same
function in plain PyTorch; the CPU path and the card-side checks use it.

P 1..5 run template instances of the kernel; P >= 6 one kernel with P
at run time (the reference's kernels take any P), with the same
arithmetic and rounding, so every P is bitwise the plain version.

``sa_update_lanes`` launches the same kernel over L lanes, each with its
own operands and coefficient vector (the reference's per-lane step calls
the Pallas kernel under ``jax.vmap``); a solo call is one lane. Lane l's
output equals a solo launch on lane l bit for bit;
``sa_update_lanes_plain`` is the loop of the plain version over the lanes.
"""

from __future__ import annotations

import functools

import torch

from . import _build

__all__ = ["sa_update", "sa_update_plain", "sa_update_lanes",
           "sa_update_lanes_plain", "combine_geometry", "launch_args",
           "launch_combine", "cost", "MAX_LANES", "DTYPE_CODES"]

#: shared memory the runtime-P kernel stages a lane's rows x (P+2)
#: float32 coefficients in (the static default of a block)
COEFF_BYTES = 48 * 1024
#: operand dtypes the combine kernels take, with their C codes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads per block at large n; the blocks of that size an SM keeps
#: resident on the vector path (``__launch_bounds__(256, 2)`` in
#: ``csrc/sa_combine.cu``), and the blocks per SM the scalar path may
#: launch (enough to fill every SM's resident threads with 4-byte loads)
BLOCK = 256
RESIDENT_BLOCKS = 2
SCALAR_BLOCKS = 16

#: most lanes one launch takes (the grid's y extent)
MAX_LANES = 65535

#: kernel launches made by :func:`sa_update` and :func:`sa_update_lanes`
#: in this process
launches = 0


def cost(n: int, P: int, itemsize: int, rows: int = 1,
         lanes: int = 1) -> tuple[int, int]:
    """``(flops, bytes)`` of one call over ``lanes`` lanes of ``n``
    elements: x, xi and the P history rows read once, ``rows`` outputs
    written once, each lane's ``rows`` x (P+2) float32 coefficients read
    once; per output row 3 + 2P flops an element (``c0 x + c1 xi``, then
    a multiply and an add per row)."""
    flops = lanes * rows * (2 * P + 3) * n
    nbytes = lanes * ((P + 2 + rows) * n * itemsize + rows * (P + 2) * 4)
    return flops, nbytes


def sa_update_plain(x, buf, xi, coeffs):
    """x [*shape]; buf [P, *shape]; xi [*shape]; coeffs [P+2] packed as
    (decay, noise, b_0..b_{P-1}). Returns x' with x.dtype.

    The kernel's arithmetic in plain PyTorch, for every dtype: an f32
    chain ``(c0*x + c1*xi) + c_j*b_j`` for j = 0..P-1, each product and
    sum rounded on its own (the kernel does not contract them into FMAs),
    so the two agree bit for bit. A reordered sum (one contraction over
    the rows) differs from it by an ulp of the largest partial sum, which
    exceeds the held tolerance of a result that cancels (SEEDS' noise-
    convention combines on DiT-XL/2)."""
    c = coeffs.to(torch.float32)
    acc = c[0] * x.float() + c[1] * xi.float()
    for j in range(buf.shape[0]):
        acc = acc + c[2 + j] * buf[j].float()
    return acc.to(x.dtype)


def sa_update_lanes_plain(x, buf, xi, coeffs):
    """x [L, *shape]; buf [L, P, *shape]; xi [L, *shape]; coeffs [L, P+2]:
    :func:`sa_update_plain` of each lane on its own operands."""
    return torch.stack([sa_update_plain(x[l], buf[l], xi[l], coeffs[l])
                        for l in range(x.shape[0])])


def combine_geometry(n: int, itemsize: int, vectorized: bool,
                     sms: int) -> tuple[int, int]:
    """``(blocks, threads)`` of one combine launch over ``n`` elements of
    ``itemsize`` bytes on a card with ``sms`` SMs.

    A work item is a 16-byte vector on the vector path, an element on the
    scalar one; each thread takes one item per step. While one step
    covers the items in blocks of up to ``BLOCK`` threads on every SM,
    the blocks hold the least power of two from 32 threads that spreads
    the items over every SM. Beyond that: blocks of ``BLOCK``, the grid
    capped at ``RESIDENT_BLOCKS`` per SM on the vector path and
    ``SCALAR_BLOCKS`` on the scalar one (the kernel's grid-stride loop
    covers the rest). The kernel covers item ``block * threads + thread +
    k * blocks * threads`` for k = 0, 1, ... while below the item count,
    on each path."""
    items = n // (16 // itemsize) if vectorized else n
    if items <= sms * BLOCK:
        threads = 32
        while threads < BLOCK and threads * sms < items:
            threads *= 2
        return max(1, -(-items // threads)), threads
    cap = sms * (RESIDENT_BLOCKS if vectorized else SCALAR_BLOCKS)
    return min(-(-items // BLOCK), cap), BLOCK


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_args(x, buf, xi, coeffs, outs, sms: int) -> tuple:
    """The C entry point's arguments but the stream, in its order: the
    x, buf, xi, coeffs and output pointers, n, P, the dtype code, the
    geometry (:func:`combine_geometry`) and whether the vector path runs
    (every operand and output pointer and the row stride n 16-byte
    aligned)."""
    n = x.numel()
    itemsize = x.element_size()
    data = [t.data_ptr() for t in (x, buf, xi, *outs)]
    vectorized = n % (16 // itemsize) == 0 and all(p % 16 == 0 for p in data)
    return (*data[:3], coeffs.data_ptr(), *data[3:], n, buf.shape[0],
            DTYPE_CODES[x.dtype], *combine_geometry(n, itemsize, vectorized, sms),
            int(vectorized))


def launch_combine(entry: str, x, buf, xi, coeffs, outs, lanes: int = 0):
    """Launch the C entry ``entry`` (``sa_update_launch`` or
    ``sa_fused_launch``) on the current stream and raise on its error.
    ``lanes`` 0: one combine of :func:`launch_args`' operands; else
    ``lanes`` combines stacked on a leading axis, passed as lane 0's
    pointers with one lane's n, P and geometry. Every lane's pointers are
    16-byte aligned exactly when lane 0's are and n is a multiple of the
    vector width, which is what the vector-path flag checks."""
    one = (lambda t: t[0]) if lanes else (lambda t: t)
    args = launch_args(one(x), one(buf), one(xi), coeffs,
                       [one(o) for o in outs], _sms(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_build.load("sa_combine"), entry)(*args, max(lanes, 1), stream)
    _build.check(rc, entry)


def check_lane_operands(x, buf, xi, coeffs, rows: int) -> None:
    """Raise on what the lane-batched entries do not take: x and xi
    [L, *shape], buf [L, P, *shape], coeffs float32 [L, rows, P+2]."""
    if x.dim() < 1 or not 1 <= x.shape[0] <= MAX_LANES:
        raise ValueError(f"x of shape {tuple(x.shape)}: the lane-batched "
                         f"entries take [L, *shape], 1 <= L <= {MAX_LANES}")
    L = x.shape[0]
    if buf.dim() < 2 or buf.shape[0] != L or \
            tuple(buf.shape[2:]) != tuple(x.shape[1:]):
        raise ValueError(f"shapes: x {tuple(x.shape)}, buf {tuple(buf.shape)}"
                         " (want [L, P, *x.shape[1:]])")
    if coeffs.dim() != 3 or coeffs.shape[0] != L:
        raise ValueError(f"coeffs of shape {tuple(coeffs.shape)}; want "
                         f"[{L}, {rows}, P+2]")
    check_operands(x[0], buf[0], xi[0], coeffs[0], rows)
    if xi.shape != x.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)}, xi {tuple(xi.shape)}")
    for name, t in (("x", x), ("buf", buf), ("xi", xi), ("coeffs", coeffs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    if P < 1:
        raise ValueError(f"history rows P={P}; the kernel takes P >= 1")
    if rows * (P + 2) * 4 > COEFF_BYTES:
        raise ValueError(f"history rows P={P}: {rows} x (P+2) float32 "
                         f"coefficients exceed the kernel's {COEFF_BYTES} "
                         "bytes of shared memory")
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
    _build.refuse_autograd("sa_update", x, buf, xi, coeffs)
    check_operands(x, buf, xi, coeffs.reshape(1, -1), rows=1)
    out = torch.empty_like(x)
    launch_combine("sa_update_launch", x, buf, xi, coeffs, (out,))
    launches += 1
    return out


def sa_update_lanes(x, buf, xi, coeffs):
    """The Hopper kernel over lanes: same contract as
    :func:`sa_update_lanes_plain`, CUDA tensors only (raises otherwise).
    coeffs must be float32 [L, P+2]."""
    global launches
    _build.refuse_autograd("sa_update_lanes", x, buf, xi, coeffs)
    check_lane_operands(x, buf, xi, coeffs.reshape(coeffs.shape[0], 1, -1),
                        rows=1)
    out = torch.empty_like(x)
    launch_combine("sa_update_launch", x, buf, xi, coeffs, (out,),
                   lanes=x.shape[0])
    launches += 1
    return out
