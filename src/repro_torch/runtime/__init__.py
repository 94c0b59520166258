"""Runtime services: straggler detection and a fault-tolerant training
loop with auto-resume.

Real multi-host preemption cannot be exercised in one process; the
harness exposes the same control flow (resume from the latest committed
checkpoint, failure injection at a chosen step) so the recovery path is
tested end to end, and the straggler monitor consumes measured per-step
wall times (a training step, a serving tick, a solve) exactly as it would
consume per-host heartbeat aggregates at scale.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from .. import checkpoint as ckpt
from ..tree import tree_leaves

__all__ = ["StragglerMonitor", "TrainLoop", "InjectedFailure"]


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerMonitor:
    """EMA + z-score detector over per-step wall time.

    At scale each entry is max-over-hosts step time (the straggler shows up
    as a fleet-wide slow step because of the collective barrier); a
    sustained z-score above ``z_thresh`` triggers ``action``.
    """

    alpha: float = 0.05
    z_thresh: float = 4.0
    warmup_steps: int = 5
    patience: int = 3
    action: Callable[[int, float, float], None] | None = None

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _strikes: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step was flagged as a straggler event."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # prime the EMA without flagging
            w = 1.0 / self._n
            self._mean = (1 - w) * self._mean + w * dt
            self._var = (1 - w) * self._var + w * (dt - self._mean) ** 2
            return False
        std = math.sqrt(self._var) + 1e-9
        z = (dt - self._mean) / std
        flagged = z > self.z_thresh
        if flagged:
            self._strikes += 1
            if self._strikes >= self.patience:
                self.events.append((step, dt, z))
                if self.action is not None:
                    self.action(step, dt, z)
                self._strikes = 0
        else:
            self._strikes = 0
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
            self._var = (1 - self.alpha) * self._var \
                + self.alpha * (dt - self._mean) ** 2
        return flagged


class TrainLoop:
    """Checkpointed training loop with auto-resume and failure injection.

    train_step: (state, batch) -> (state, metrics); state is any tree of
    tensors holding (params, opt_state, step), metrics a dict of 0-d
    tensors. batches: an iterator with a ``step`` attribute
    (``ShardedBatchIterator``) so the data position resumes too.
    """

    def __init__(self, train_step, init_state_fn, ckpt_dir: str, *,
                 save_every: int = 50, keep: int = 3,
                 async_save: bool = True, monitor: StragglerMonitor | None = None):
        self.train_step = train_step
        self.init_state_fn = init_state_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.monitor = monitor or StragglerMonitor()
        self.saver = ckpt.AsyncCheckpointer(ckpt_dir, keep=keep) \
            if async_save else None

    def resume_or_init(self):
        """Return (state, start_step): latest committed checkpoint or fresh."""
        last = ckpt.latest_step(self.ckpt_dir)
        state = self.init_state_fn()
        if last is None:
            return state, 0
        state, step = ckpt.restore(self.ckpt_dir, state)
        return state, step

    def run(self, batches, n_steps: int, *, fail_at: int | None = None,
            log_every: int = 20, log=print):
        """Train from the latest committed checkpoint to ``n_steps``;
        returns (state, per-step metrics). The async saver is drained
        before ``run`` returns or raises, so a resume in the same process
        (after an ``InjectedFailure``) sees every save handed to it, where
        the reference's writer may still be committing one."""
        try:
            return self._run(batches, n_steps, fail_at, log_every, log)
        finally:
            if self.saver is not None:
                self.saver.wait()

    def _run(self, batches, n_steps, fail_at, log_every, log):
        state, start = self.resume_or_init()
        if hasattr(batches, "step"):
            batches.step = start
        metrics_hist = []
        it = iter(batches)
        for step in range(start, n_steps):
            if fail_at is not None and step == fail_at:
                raise InjectedFailure(f"injected failure at step {step}")
            batch = next(it)
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batch)
            first = tree_leaves(metrics)[0]
            if first.is_cuda:  # the step is done when its metrics are
                torch.cuda.synchronize(first.device)
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            metrics_hist.append({k: float(v) for k, v in metrics.items()})
            if (step + 1) % self.save_every == 0 or step + 1 == n_steps:
                if self.saver is not None:
                    self.saver.save(step + 1, state)
                else:
                    ckpt.save(self.ckpt_dir, step + 1, state, keep=self.keep)
            if log and (step % log_every == 0 or step + 1 == n_steps):
                log(f"step {step}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in metrics_hist[-1].items()
                ) + f" ({dt*1e3:.0f} ms)")
        return state, metrics_hist
