"""Named regions of a computation, and the hook through which the kernels
charge their own cost, for traces and for the op counter
(``launch.op_cost``).

:func:`named_scope` marks what runs inside it twice: as a
``torch.profiler.record_function`` range (a trace on the card shows it)
and on a stack of the port's own, which the counter reads (a
``TorchDispatchMode`` does not see ``record_function``). Neither launches
work on the device nor reads from it, so a scope may sit inside a CUDA
graph capture. The reference's counterpart is
``jax.named_scope("backbone")`` (``repro.core.denoiser``), which
``launch.hlo_cost`` reads from the HLO's op names.

:func:`charge_kernel` hands one call of a hand-written kernel (a ctypes
launch, or the abstract call of a fake tensor) to the counters that are
active: a launch is invisible to a dispatch mode, so each kernel states
its own floating-point operations and bytes (its module's ``cost``).
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["named_scope", "current_scopes", "charge_kernel",
           "active_counters"]

_SCOPES: list[str] = []
#: the counters that take kernel charges (``launch.op_cost`` registers
#: its own while it counts)
active_counters: list = []


@contextlib.contextmanager
def named_scope(name: str):
    """Run the body as region ``name``: a profiler range and a scope the
    op counter reads."""
    _SCOPES.append(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _SCOPES.pop()


def current_scopes() -> tuple[str, ...]:
    """The scopes around the current op, outermost first."""
    return tuple(_SCOPES)


def charge_kernel(name: str, flops: int, nbytes: int) -> None:
    """One call of kernel ``name`` doing ``flops`` operations and moving
    ``nbytes`` bytes, charged to every active counter."""
    for c in active_counters:
        c.charge_kernel(name, flops, nbytes)
