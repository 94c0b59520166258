"""Fault-tolerant checkpointing: atomic commits, async writer, elastic
restore.

Layout (one directory per committed step), the reference's own, so a
checkpoint that either package writes restores in the other::

    ckpt_dir/
      step_00001200/
        index.json            # {path: {file, shape, dtype, raw_bytes}},
                              # step, wallclock
        <leaf>.npy            # one array per tree leaf

A leaf's path is the dict keys and sequence indexes down to it joined by
``/`` (its file name the same with ``__``). bfloat16 (and float8) leaves
are stored as their raw bytes (a uint8 ``.npy``) with the true dtype in the
index: ``.npy`` headers cannot name them.

Write protocol: everything lands in ``step_XXXXXXXX.tmp/``; the final
``os.rename`` to the committed name is atomic on POSIX — a writer killed
mid-save can never corrupt the latest-good checkpoint, and ``latest_step``
only ever sees committed directories. ``AsyncCheckpointer`` takes the
device->host copy on the caller's thread and the file I/O on a background
thread with a bounded queue, so the train loop does not block on disk.

Sharded state: a tree with DTensor leaves is saved as its *global*
arrays. Every rank of the default process group takes part in gathering
each DTensor (so every rank must call ``save`` with the same tree), rank 0
alone writes and commits, and the ranks meet at a barrier once the commit
is on disk (``save``; ``AsyncCheckpointer.wait``). ``restore`` places each
leaf under any target placement: a target DTensor's own mesh and
placements, or ``shardings`` (a tree of ``models.common.NamedSharding``),
so the save mesh does not constrain the restore mesh (elastic restore:
saved over 2 ranks, restored over 4). Each rank reads the global arrays
and keeps its shard, with no communication.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from ..models.common import distribute, is_dtensor
from ..tree import paths_and_leaves, tree_map, unflatten_like

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer", "all_steps"]

_STEP_RE = re.compile(r"^step_(\d{8})$")
#: dtypes stored as raw bytes (no numpy dtype names them)
_RAW = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _sanitize(key: str) -> str:
    return key.replace("/", "__")


def _sharded(tree) -> bool:
    """Whether ``tree`` holds a DTensor (then its save is collective)."""
    return any(is_dtensor(x) for _, x in paths_and_leaves(tree))


def _writer() -> bool:
    """Whether this process writes: rank 0 of the default group, or the
    one process without a group."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _barrier() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _host(leaf) -> torch.Tensor | np.ndarray:
    """A host copy of ``leaf`` (of a DTensor, its global array: a
    collective) that nothing else aliases: a later in-place update of the
    source (an optimiser step) cannot reach it."""
    if is_dtensor(leaf):
        return leaf.full_tensor().detach().to("cpu", copy=True)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Blocking atomic save. Returns the committed directory. A tree with
    DTensor leaves is gathered on every rank, written by rank 0, and the
    ranks return together once it is committed."""
    if _sharded(tree):
        tree = tree_map(_host, tree)
        final = _write(ckpt_dir, step, tree, keep) if _writer() else \
            os.path.join(ckpt_dir, f"step_{step:08d}")
        _barrier()
        return final
    return _write(ckpt_dir, step, tree, keep)


def _write(ckpt_dir: str, step: int, tree: Any, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = {"step": step, "time": time.time(), "leaves": {}}
    for key, leaf in paths_and_leaves(tree):
        fname = _sanitize(key) + ".npy"
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            shape = list(t.shape)
            raw = t.dtype in _RAW
            dtype_name = str(t.dtype).removeprefix("torch.")
            arr = (t.contiguous().reshape(-1).view(torch.uint8) if raw
                   else t).numpy()
        else:
            arr = np.asarray(leaf)
            shape, raw, dtype_name = list(arr.shape), False, str(arr.dtype)
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"][key] = {"file": fname, "shape": shape,
                                "dtype": dtype_name, "raw_bytes": raw}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for n in os.listdir(ckpt_dir):
        m = _STEP_RE.match(n)
        if m and os.path.exists(os.path.join(ckpt_dir, n, "index.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _prune(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def _load_leaf(d: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(d, meta["file"]))
    if meta.get("raw_bytes"):
        dt = getattr(torch, meta["dtype"], None)
        if dt not in _RAW:
            raise TypeError(f"raw leaf of dtype {meta['dtype']!r}: the port "
                            f"reads {[str(t) for t in _RAW]}")
        return torch.frombuffer(bytearray(arr.tobytes()),
                                dtype=torch.uint8).view(dt).reshape(
                                    meta["shape"])
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, target: Any, *, step: int | None = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``target`` (a tree of tensors): each
    leaf takes the target leaf's dtype and device, and its placement:
    ``shardings`` (a matching tree of ``models.common.NamedSharding``) or,
    without it, a target DTensor's own mesh and placements — the elastic
    path, on any mesh. Returns (tree, step).
    """
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)

    shard_list = None
    if shardings is not None:
        shard_list = [s for _, s in paths_and_leaves(shardings)]
    leaves = []
    for i, (key, leaf) in enumerate(paths_and_leaves(target)):
        meta = index["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint {d} missing leaf {key!r}")
        t = _load_leaf(d, meta)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {tuple(t.shape)} != target "
                f"{tuple(leaf.shape)}")
        t = t.to(device=leaf.device, dtype=leaf.dtype)
        if shard_list is not None:
            t = distribute(t, shard_list[i].mesh, shard_list[i].placements)
        elif is_dtensor(leaf):
            t = distribute(t, leaf.device_mesh, leaf.placements)
        leaves.append(t)
    return unflatten_like(target, leaves), step


class AsyncCheckpointer:
    """Non-blocking saver: device->host copy on the caller thread, file I/O
    on a daemon thread. ``wait()`` drains the queue (call before exit and
    in tests). A bounded queue (default 2) applies backpressure instead of
    accumulating unbounded host copies."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3, max_pending: int = 2):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: list[BaseException] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        #: a sharded tree was queued since the last ``wait``: the ranks
        #: meet there once rank 0 has committed it
        self._collective = False

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host_tree = item
            try:
                _write(self.ckpt_dir, step, host_tree, self.keep)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any):
        """Queue ``tree`` for writing. Its host copy is complete when this
        returns, so the caller may update the same tensors in place. A
        tree with DTensor leaves is gathered on every rank (each must
        call) and queued on rank 0 alone."""
        if self._err:
            raise RuntimeError("async checkpoint failed") from self._err[0]
        sharded = _sharded(tree)
        host = tree_map(_host, tree)
        self._collective |= sharded
        if not sharded or _writer():
            self._q.put((step, host))

    def wait(self):
        """Drain the queue; after a sharded save, every rank returns once
        rank 0 has committed (a barrier: each rank must call)."""
        self._q.join()
        if self._collective:
            self._collective = False
            _barrier()
        if self._err:
            raise RuntimeError("async checkpoint failed") from self._err[0]

    def close(self):
        """Stop the worker and surface any failure it hit.

        close() is the shutdown barrier: a write error after the last
        ``save()``/``wait()`` would otherwise vanish with the daemon
        thread, leaving a silently missing checkpoint."""
        self._q.put(None)
        self._q.join()
        self._thread.join(timeout=5.0)
        if self._err:
            raise RuntimeError("async checkpoint failed") from self._err[0]
