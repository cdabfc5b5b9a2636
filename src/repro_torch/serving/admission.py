"""Admission control: bounded queueing, per-client rate limits, tightening.

PyTorch port of ``repro.serving.admission`` (pure Python: copied so that
every float comparison happens in the same order).

The front door of the serve loop (DESIGN §10).  Everything here answers one
question per offered request — *does this request get to wait inside the
server?* — and answers it before the request touches any engine state:

  bounded queue   in-flight occupancy (ingress + bucketed-awaiting) is
                  capped.  An unbounded queue converts overload into
                  unbounded latency for *everyone*; a bounded one converts
                  it into explicit
                  :class:`~repro_torch.serving.request.RetryAfter`
                  backpressure for the marginal request while the admitted
                  ones keep their SLO.
  token buckets   per-client rate limiting so one hot client cannot starve
                  the rest: each client drains a :class:`TokenBucket`
                  (capacity = burst, refill = rate/s); an empty bucket
                  yields the exact refill wait as ``retry_after_s``.
  tightening      the bound shrinks multiplicatively while the mesh is
                  degraded (every distributed query is slower, so the same
                  queue represents more seconds of backlog) and again under
                  brownout level >= 2 — admission is the *last* rung of the
                  overload ladder, after adaptivity deferral.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .request import Request, RetryAfter

__all__ = ["TokenBucket", "AdmissionController"]


@dataclass
class TokenBucket:
    """Classic token bucket on an explicit timeline (works with both the
    virtual and the wall clock — time is always passed in, never sampled)."""

    rate_per_s: float
    burst: float
    tokens: float | None = None  # None -> starts full
    last_s: float | None = None

    def try_take(self, now: float, cost: float = 1.0) -> float:
        """Take ``cost`` tokens.  Returns 0.0 on success, else the seconds
        until the bucket will have refilled enough (the token is *not*
        taken — a rejected request costs the client nothing)."""
        if self.tokens is None:
            self.tokens = self.burst
        if self.last_s is not None and now > self.last_s:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last_s) * self.rate_per_s)
        self.last_s = now if self.last_s is None else max(self.last_s, now)
        if self.tokens >= cost:
            self.tokens -= cost
            return 0.0
        return (cost - self.tokens) / self.rate_per_s


@dataclass
class AdmissionController:
    """Stateless-per-request admission decision over stateful budgets."""

    queue_bound: int = 64
    client_rate_per_s: float | None = None  # None disables rate limiting
    client_burst: float = 8.0
    degraded_admit_factor: float = 0.5
    brownout_admit_factor: float = 0.5
    min_retry_after_s: float = 0.01
    buckets: dict[str, TokenBucket] = field(default_factory=dict)

    def bound(self, brownout_level: int, degraded: bool) -> int:
        """Effective in-flight cap after tightening (never below 1: a
        tightened server still serves, it just queues less)."""
        b = float(self.queue_bound)
        if degraded:
            b *= self.degraded_admit_factor
        if brownout_level >= 2:
            b *= self.brownout_admit_factor
        return max(1, int(b))

    def admit(self, req: Request, now: float, in_flight: int,
              brownout_level: int, degraded: bool,
              drain_rate_qps: float) -> RetryAfter | None:
        """None admits the request; a :class:`RetryAfter` rejects it.

        ``drain_rate_qps`` is the loop's current throughput estimate; the
        queue-full retry hint is the time for the backlog above the bound to
        drain at that rate (at least ``min_retry_after_s`` so clients never
        busy-spin)."""
        bound = self.bound(brownout_level, degraded)
        if in_flight >= bound:
            overflow = in_flight - bound + 1
            wait = max(self.min_retry_after_s,
                       overflow / max(drain_rate_qps, 1e-9))
            if bound < self.queue_bound and in_flight < self.queue_bound:
                # only the tightening made this a reject — name the cause so
                # clients can distinguish "you are unlucky" from "we are sick"
                reason = "degraded" if degraded else "brownout"
            else:
                reason = "queue_full"
            return RetryAfter(req.rid, wait, reason)
        if self.client_rate_per_s is not None:
            tb = self.buckets.get(req.client)
            if tb is None:
                tb = self.buckets[req.client] = TokenBucket(
                    self.client_rate_per_s, self.client_burst)
            wait = tb.try_take(now)
            if wait > 0.0:
                return RetryAfter(req.rid,
                                  max(wait, self.min_retry_after_s),
                                  "rate_limited")
        return None


@dataclass
class BrownoutController:
    """Overload ladder with hysteresis (DESIGN §10).

    Driven by queue occupancy (in_flight / queue_bound), quantized into
    three rungs — the cheapest work is shed first, queries last:

      level 0  normal: full adaptivity (IRD, rebalancing) runs inline.
      level 1  defer adaptivity: the serve loop sets
               ``engine.adaptivity_paused`` — IRD and hot-key rebalancing
               stop consuming the collective budget, the heat map keeps
               counting, and the engine's degraded-mode catch-up path
               replays the backlog when the level drops back (load
               shedding of *background* work before any client-visible
               shedding).
      level 2  tighten admission: the in-flight bound shrinks by
               ``brownout_admit_factor`` so the marginal request gets
               backpressure instead of a doomed queue slot.

    Enter thresholds are crossed upward, exit thresholds downward
    (``exit[i] < enter[i]``), so occupancy noise around a threshold does not
    flap the ladder."""

    enter: tuple[float, float] = (0.5, 0.85)
    exit: tuple[float, float] = (0.25, 0.6)
    level: int = 0

    def __post_init__(self):
        for lo, hi in zip(self.exit, self.enter):
            if lo >= hi:
                raise ValueError(
                    f"hysteresis requires exit < enter, got {lo} >= {hi}")

    def update(self, occupancy: float) -> bool:
        """Feed the current queue occupancy; returns True on a level
        change (the caller's cue to toggle adaptivity / log the event)."""
        old = self.level
        while self.level < 2 and occupancy >= self.enter[self.level]:
            self.level += 1
        while self.level > 0 and occupancy < self.exit[self.level - 1]:
            self.level -= 1
        return self.level != old
