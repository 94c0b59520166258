"""Conditional execution decided on the device: ``run_if(pred, body)``.

The reference gates the feature cache's deep block segment with
``lax.cond`` on a traced predicate. Here ``body()`` runs when the 0-d
bool tensor ``pred`` is true:

- inside a CUDA graph capture, as a conditional IF node of the graph
  (``csrc/graph_gate.cu``): a one-thread kernel copies ``pred`` into the
  node's handle, the body's work is captured on a body stream of its own
  into the node's body graph, and each replay runs that work only where
  ``pred`` holds at that point of the replay. The host reads nothing;
- on a CUDA device outside a capture (a warm-up, or a solve inside
  ``samplers.eager()``), after one read of ``pred``;
- on the CPU, as a Python branch.

``body`` must write what it computes in place into tensors allocated
before the call: a tensor it allocates lives, under a capture, in the
body stream's own memory pool and is not to be read after the node. Its
kernels must have run once outside a capture (their builds and cuBLAS's
set-up may not run inside one). A failed capture raises.

Kernel launches captured inside a body are taken back from the launch
counts (``ops.add_launches``), so a replay adds only the launches it makes
whatever ``pred`` says; :func:`fires` counts, on the device, the bodies
that ran, and is read only by code that measures.
"""

from __future__ import annotations

import torch

from . import _build, ops

__all__ = ["run_if", "fires", "reset_fires"]

#: per CUDA device: the stream and memory pool of captured bodies
_BODY: dict = {}
#: per device: a one-element int64 tensor, the bodies run there
_FIRES: dict = {}


def _fire_counter(device: torch.device) -> torch.Tensor:
    counter = _FIRES.get(device)
    if counter is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "run_if was first called inside a CUDA graph capture; run "
                "the captured code once outside the capture first")
        counter = _FIRES[device] = torch.zeros(1, dtype=torch.long,
                                               device=device)
    return counter


def _body_of(device: torch.device):
    body = _BODY.get(device)
    if body is None:
        body = _BODY[device] = (torch.cuda.Stream(device),
                                torch.cuda.MemPool())
    return body


def run_if(pred: torch.Tensor, body) -> None:
    """Run ``body()`` where the 0-d bool tensor ``pred`` is true (see the
    module docstring for how each device decides)."""
    device = pred.device
    counter = _fire_counter(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        _capture_if(pred, body, counter)
    elif bool(pred):
        counter.add_(1)
        body()


def _capture_if(pred, body, counter) -> None:
    device = pred.device
    stream, pool = _body_of(device)
    capture = torch.cuda.current_stream(device)
    lib = _build.load("graph_gate")
    _build.check(lib.gate_if_begin(capture.cuda_stream, pred.data_ptr(),
                                   stream.cuda_stream),
                 "graph_gate: the conditional node")
    before = ops.launch_counts()
    try:
        with torch.cuda.stream(stream), torch.cuda.use_mem_pool(pool,
                                                                device):
            counter.add_(1)
            body()
    finally:
        rc = lib.gate_if_end(stream.cuda_stream)
        after = ops.launch_counts()
        ops.add_launches({k: before[k] - after[k] for k in after
                          if after[k] != before[k]})
    _build.check(rc, "graph_gate: the conditional node's body")


def fires(device) -> int:
    """Bodies run on ``device`` since the last :func:`reset_fires` (one
    device read)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _FIRES.get(device)
    return 0 if counter is None else int(counter.item())


def reset_fires() -> None:
    for counter in _FIRES.values():
        counter.zero_()
