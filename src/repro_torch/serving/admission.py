"""Admission control for ``KvBatchServer`` — the overload control loop.

The server's request queue was unbounded: under sustained overload (offered
load beyond what ``step()`` drains) the deque and per-request latency grow
without limit, and the eventual failure mode is an OOM or a timeout storm
instead of a controlled degradation.  ``AdmissionController`` closes the
loop at the submission edge with a cost-bounded queue:

- Each request kind carries a *cost* in abstract units — existence checks
  are cheaper than gets (they never touch the Value WAL, §3.2), writes pay
  a per-KB surcharge so one 10 MB put can't hide behind the unit cost of a
  4-byte put.
- Admission holds the invariant ``queued_cost + cost ≤ high_watermark``.
  Over the watermark, policy decides: ``"shed"`` raises :class:`Overloaded`
  to the submitter immediately (fail fast, serve the rest), while
  ``"backpressure"`` blocks the submitter until the queue drains to the
  *low* watermark (hysteresis: waiters resume in bulk well below the high
  mark, so admission doesn't thrash at the boundary) — no request is ever
  dropped, the client is simply slowed to the server's pace.  A request
  whose cost alone exceeds the low watermark admits once the queue drains
  to the low watermark (it could never fit *under* it, and waiting for an
  empty queue would starve it forever under continuous small traffic), so
  the accounted cost may transiently overshoot the high watermark by one
  oversized request.
- ``release`` returns a drained batch's cost in one step, waking waiters
  when the low watermark is crossed.

The controller is engine-agnostic and lock-cheap: one Condition guards a
float accumulator; the server calls ``admit`` once per submission and
``release`` once per drained batch.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


class Overloaded(RuntimeError):
    """Raised to the submitter when a request is shed: the queue is at the
    high watermark under policy="shed", or the engine is degraded
    (read-only) and refuses writes.  Carries the rejected request's cost;
    ``reason`` overrides the watermark message for non-queue sheds so
    clients keep one retry/backoff handler for both."""

    def __init__(self, cost: float, queued_cost: float = 0.0,
                 high: float = 0.0, reason: Optional[str] = None):
        super().__init__(
            reason if reason is not None else
            f"admission queue full: cost {cost:.1f} would push queued "
            f"{queued_cost:.1f} past the high watermark {high:.1f}")
        self.cost = cost
        self.queued_cost = queued_cost
        self.high_watermark = high


@dataclass(frozen=True)
class AdmissionConfig:
    """Cost model + watermarks.  Costs are abstract units ~ "one cached
    get"; the defaults make a queue of ``high_watermark`` plain gets."""

    high_watermark: float = 1024.0
    low_watermark: Optional[float] = None   # None = high / 2
    policy: str = "backpressure"            # "backpressure" | "shed"
    read_cost: float = 1.0
    exists_cost: float = 0.5                # index-only, never hits the WAL
    write_cost: float = 1.0
    write_cost_per_kb: float = 0.25         # payload surcharge per 1024 B
    max_wait_s: Optional[float] = None      # backpressure wait bound;
                                            # None = wait forever

    def __post_init__(self):
        if self.policy not in ("backpressure", "shed"):
            raise ValueError(f"unknown admission policy {self.policy!r}")
        if self.high_watermark <= 0:
            raise ValueError("high_watermark must be positive")
        for f in ("read_cost", "exists_cost", "write_cost",
                  "write_cost_per_kb"):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be non-negative")
        low = self.resolved_low
        if not 0 < low <= self.high_watermark:
            raise ValueError(
                f"low_watermark {low} must be in (0, high_watermark]")

    @property
    def resolved_low(self) -> float:
        return (self.high_watermark / 2.0 if self.low_watermark is None
                else self.low_watermark)


class AdmissionController:
    """Cost-bounded admission with shed or backpressure semantics."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self._cond = threading.Condition()
        self._queued_cost = 0.0
        # Counters (read under the condition's lock in stats()).
        self.admitted = 0
        self.shed = 0
        self.waits = 0
        self.wait_time_s = 0.0
        self.peak_cost = 0.0

    # ------------------------------------------------------------ cost model
    def cost_of(self, req) -> float:
        """Cost units for a KvRead/KvWrite (duck-typed on .op/.value)."""
        c = self.cfg
        op = getattr(req, "op", "get")
        if op == "exists":
            return c.exists_cost
        if op in ("put", "delete"):
            size = len(getattr(req, "value", b"") or b"")
            return c.write_cost + c.write_cost_per_kb * (size / 1024.0)
        return c.read_cost

    # ------------------------------------------------------------- admission
    def admit(self, cost: float) -> None:
        """Charge ``cost`` against the queue budget; raises ``Overloaded``
        (shed) or blocks until the low watermark (backpressure) when the
        high watermark would be exceeded."""
        high, low = self.cfg.high_watermark, self.cfg.resolved_low
        with self._cond:
            if self._queued_cost + cost <= high:
                self._charge(cost)
                return
            if self.cfg.policy == "shed":
                self.shed += 1
                raise Overloaded(cost, self._queued_cost, high)
            # Backpressure: wait for the drain side to pull the queue down
            # to the LOW watermark, then charge.  Hysteresis means a burst
            # of blocked submitters re-admits in bulk instead of one-per-
            # release ping-pong at the high mark.  An OVERSIZED request
            # (cost > low) could never satisfy the hysteresis predicate, so
            # it admits as soon as the queue itself drains to the low
            # watermark — under continuous small traffic the queue may
            # never empty, and requiring that would starve the large
            # submitter forever.  The charge may transiently overshoot the
            # high watermark (an oversized request has to land somewhere);
            # everyone behind it then waits for the drain.
            self.waits += 1
            t0 = time.monotonic()
            ok = self._cond.wait_for(
                lambda: self._queued_cost + cost <= low
                or (cost > low and self._queued_cost <= low),
                timeout=self.cfg.max_wait_s)
            self.wait_time_s += time.monotonic() - t0
            if not ok:
                self.shed += 1
                raise Overloaded(cost, self._queued_cost, high)
            self._charge(cost)

    def _charge(self, cost: float) -> None:
        self._queued_cost += cost
        self.admitted += 1
        if self._queued_cost > self.peak_cost:
            self.peak_cost = self._queued_cost

    def release(self, cost: float) -> None:
        """Return a drained batch's total cost; wakes backpressure waiters
        once the queue is at/below the low watermark."""
        if cost <= 0:
            return
        with self._cond:
            self._queued_cost = max(0.0, self._queued_cost - cost)
            if self._queued_cost <= self.cfg.resolved_low:
                self._cond.notify_all()

    # --------------------------------------------------------------- insight
    @property
    def queued_cost(self) -> float:
        with self._cond:
            return self._queued_cost

    def stats(self) -> dict:
        with self._cond:
            return {"admission_policy": self.cfg.policy,
                    "admission_high_watermark": self.cfg.high_watermark,
                    "admission_low_watermark": self.cfg.resolved_low,
                    "admission_queued_cost": self._queued_cost,
                    "admission_peak_cost": self.peak_cost,
                    "admission_admitted": self.admitted,
                    "admission_shed": self.shed,
                    "admission_waits": self.waits,
                    "admission_wait_s": self.wait_time_s}
