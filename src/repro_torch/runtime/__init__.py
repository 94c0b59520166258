"""Runtime services: straggler detection and the injected-failure type.

The straggler monitor consumes measured per-step wall times (a serving
tick, a solve) exactly as it would consume per-host heartbeat aggregates
at scale. The reference's checkpointed ``TrainLoop`` comes with the
training slice of the port (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

__all__ = ["StragglerMonitor", "InjectedFailure"]


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
