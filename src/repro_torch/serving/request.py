"""Request/result vocabulary of the online serving front-end (DESIGN §10).

PyTorch port of ``repro.serving.request``.  A served relation stays where
the engine computed it (on the card for a ``device="cuda"`` engine).

A served query has exactly four possible fates, and every one of them is an
explicit object — nothing is silent:

  :class:`RetryAfter`    rejected at admission (bounded queue full, client
                         over its token-bucket rate, or tightened admission
                         while the mesh is degraded / browned out).  The
                         request never entered the system; the client is
                         told when to come back.  This is *backpressure*,
                         not queueing: the queue has a bound, and beyond it
                         the caller — not the server — holds the work.
  :class:`SheddedResult` admitted, but its SLO deadline passed while it
                         waited in the ingress queue.  Dropped *before* the
                         control pass, so a shed request never touches the
                         adaptivity state machine and is never answered — a
                         request past its deadline is useless to its client
                         and serving it late only steals capacity from
                         requests that can still make theirs.
  :class:`ServedResult`  answered.  Bit-identical to what an offline
                         ``AdHashEngine.query_batch`` over the same admitted
                         subsequence computes.  ``late`` flags the rare
                         answer that completed past its deadline (counted,
                         never silent).
  in flight              still queued or batched; ``ServeLoop.drain``
                         resolves every remaining request into one of the
                         above.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.executor import QueryStats
from repro_torch.core.query import Query
from repro_torch.core.relation import Relation

__all__ = ["Request", "RetryAfter", "SheddedResult", "ServedResult",
           "ServeReport"]


@dataclass
class Request:
    """One client query with its arrival time and latency budget.

    ``deadline_s`` is absolute (same timeline as the serve loop's clock);
    when None the loop stamps ``arrival_s + ServeConfig.slo_s`` at offer
    time.  ``arrival_s`` of None means "arriving now" (stamped from the
    loop clock) — open-loop replays pre-stamp true arrival times so queueing
    delay counts against the SLO even when the loop notices the request
    late.  The loop stamps ``bucketed_s`` when the request leaves ingress
    for the control pass and ``dispatched_s`` when its bucket starts
    executing (an inline pattern-index hit: both at its control step)."""

    rid: int
    query: Query
    client: str = "default"
    arrival_s: float | None = None
    deadline_s: float | None = None
    bucketed_s: float | None = None
    dispatched_s: float | None = None


@dataclass(frozen=True)
class RetryAfter:
    """Admission rejection with explicit backpressure.

    ``retry_after_s`` is the server's estimate of when capacity frees up
    (queue drain time at the current service rate, or the client's token
    refill time).  ``reason`` is one of ``"queue_full"``, ``"rate_limited"``,
    ``"degraded"`` (the bound was tightened by a degraded-mesh episode) or
    ``"brownout"`` (tightened by the overload controller)."""

    rid: int
    retry_after_s: float
    reason: str


@dataclass(frozen=True)
class SheddedResult:
    """A deadline-shed request: admitted, never executed, never answered.

    ``reason`` is ``"deadline"`` for the SLO-expiry path; ``"unexecutable"``
    marks the pathological case where every execution attempt (batched and
    per-member sequential) raised — the serve loop stays up and reports the
    casualty instead of crashing the stream."""

    rid: int
    shed_at_s: float
    deadline_s: float
    reason: str = "deadline"


@dataclass(frozen=True)
class ServedResult:
    """An answered request: the relation, its stats, and SLO accounting.

    On the loop's clock: ``bucketed_s`` minus the arrival is the ingress
    wait, ``dispatched_s - bucketed_s`` the wait in the bucket,
    ``finished_s - dispatched_s`` the service; the three add up to
    ``latency_s``."""

    rid: int
    relation: Relation
    stats: QueryStats
    finished_s: float
    latency_s: float
    late: bool = False
    bucketed_s: float | None = None
    dispatched_s: float | None = None


@dataclass
class ServeReport:
    """Cumulative serving accounting (the front-end's ``EngineReport``).

    The ledger is conservation-checked: every offered request ends up in
    exactly one of rejected / shed / answered / still-in-flight."""

    offered: int = 0
    rejected_queue_full: int = 0
    rejected_rate_limited: int = 0
    rejected_degraded: int = 0
    rejected_brownout: int = 0
    shed: int = 0
    answered: int = 0
    late: int = 0
    unexecutable: int = 0
    flush_full: int = 0      # buckets popped because they hit batch_target
    flush_deadline: int = 0  # buckets popped by the SLO-deadline forcing path
    flush_pressure: int = 0  # oldest bucket popped because ingress backed up
    flush_drain: int = 0     # force-pops at end-of-stream drain
    flush_overlap: int = 0   # buckets evaluated inside an IRD collective
    adaptivity_deferrals: int = 0  # control steps run with adaptivity paused
    checkpoint_saves: int = 0
    checkpoint_failures: int = 0
    brownout_events: list[tuple[float, int]] = field(default_factory=list)
    latencies_s: list[float] = field(default_factory=list)

    @property
    def rejected(self) -> int:
        return (self.rejected_queue_full + self.rejected_rate_limited
                + self.rejected_degraded + self.rejected_brownout)

    @property
    def admitted(self) -> int:
        return self.offered - self.rejected

    @property
    def shed_rate(self) -> float:
        """Shed fraction of *admitted* requests — the load the server
        accepted and then could not serve in time."""
        return self.shed / max(self.admitted, 1)

    def latency_percentile(self, p: float) -> float:
        """p-th percentile (0..100) of answered-request latency, seconds."""
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        idx = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
        return xs[idx]

    @property
    def p50_s(self) -> float:
        return self.latency_percentile(50.0)

    @property
    def p99_s(self) -> float:
        return self.latency_percentile(99.0)
