"""Straggler detection and mitigation.

At 1000+ nodes, slow hosts (thermal throttling, failing NICs, noisy
neighbours) stall synchronous training.  The monitor keeps an EMA of step
times; a step exceeding ``threshold × EMA`` is flagged, repeated offenders
trigger the configured action: log, checkpoint-and-raise (so the cluster
scheduler replaces the host and the run auto-resumes), or callback.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class StragglerAbort(RuntimeError):
    """Raised to hand control back to the restart wrapper."""


@dataclass
class StragglerMonitor:
    threshold: float = 3.0          # step slower than 3× EMA ⇒ suspect
    ema_alpha: float = 0.1
    patience: int = 3               # consecutive slow steps before action
    action: str = "log"             # "log" | "abort" | "callback"
    deadline_s: Optional[float] = None   # hard per-step ceiling
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    ema: Optional[float] = field(default=None, init=False)
    slow_streak: int = field(default=0, init=False)
    events: list = field(default_factory=list, init=False)
    _t0: Optional[float] = field(default=None, init=False)

    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        if self.ema is None:
            self.ema = dt
            return dt
        slow = dt > self.threshold * self.ema or (
            self.deadline_s is not None and dt > self.deadline_s)
        if slow:
            self.slow_streak += 1
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
            if self.slow_streak >= self.patience:
                if self.action == "abort":
                    raise StragglerAbort(
                        f"step {step}: {dt:.3f}s vs EMA {self.ema:.3f}s "
                        f"({self.slow_streak} consecutive slow steps)")
        else:
            self.slow_streak = 0
            # only healthy steps update the EMA (a straggler must not
            # poison the baseline)
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        return dt
