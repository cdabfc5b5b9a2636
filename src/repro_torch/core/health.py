"""Worker health state and the degraded-route state machine (DESIGN §9).

PyTorch port of ``repro.core.health`` (pure Python, copied as is apart
from this docstring).

Production means workers die.  The engine's answer is *graceful
degradation*: queries stay exact, only the route changes.  A
:class:`HealthState` tracks which workers are currently believed failed —
fed either directly (tests, fault injection) or from a failure detector
via :meth:`sync` — and the engine consults it at routing time:

  HEALTHY     pattern-index hits run the zero-collective shard-local route
              (``QueryStats.route == "<substrate>-local"``).
  DEGRADED    one or more shards failed.  A PI hit would probe replica
              modules shard-locally, including on the dead shard, so the
              hit is *demoted* to the distributed all_to_all route over the
              main index (``route == "<substrate>-degraded"``).  Answers
              are bit-identical — every route computes the exact query
              answer — only communication changes.  Adaptivity writes
              (IRD, rebalancing) are suspended: both would place replica
              rows onto the failed shard.
  RECOVERED   the shard re-registers; the PI and its replica modules were
              never touched, so the very next PI hit returns to the
              shard-local route.

The set is keyed by *worker* index (the logical W axis), not device index:
on a mesh substrate each device owns a contiguous block of workers, and
losing a device fails all of its workers.
"""
from __future__ import annotations

__all__ = ["HealthState"]


class HealthState:
    """Failed-worker set + the degraded predicate the router consults."""

    def __init__(self, n_workers: int):
        self.w = n_workers
        self.failed: set[int] = set()

    # ------------------------------------------------------------ transitions
    def mark_failed(self, worker: int) -> None:
        if not 0 <= worker < self.w:
            raise ValueError(f"worker {worker} outside [0, {self.w})")
        self.failed.add(worker)

    def mark_recovered(self, worker: int) -> None:
        self.failed.discard(worker)

    def sync(self, monitor, now: float | None = None) -> bool:
        """Adopt a failure detector's view (anything with
        ``failed_workers(now)``, e.g. ``HeartbeatMonitor``).  Returns True
        when the view changed — the caller's cue to log the transition."""
        failed = {w for w in monitor.failed_workers(now) if w < self.w}
        changed = failed != self.failed
        self.failed = failed
        return changed

    # --------------------------------------------------------------- queries
    @property
    def degraded(self) -> bool:
        return bool(self.failed)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = f"degraded failed={sorted(self.failed)}" if self.failed \
            else "healthy"
        return f"HealthState({self.w} workers, {state})"
