"""Deterministic fault injection for the recovery tests and the card's
smoke run (DESIGN §9) — and the shared virtual clock the serving loop runs
on (DESIGN §10).

PyTorch port of ``repro.runtime.fault_injection``.

Three failure modes, all driven by a virtual clock so tests never sleep:

  worker loss     :class:`FaultInjector` kills a shard's heartbeats and
                  advances time past the detector deadline; the engine's
                  ``HealthState`` flips to DEGRADED and PI hits demote to
                  the distributed route.  ``restart`` re-registers the
                  worker and the engine returns to the shard-local route.
  master loss     simulated by simply dropping the engine object and
                  running ``recover_master`` against the checkpoint
                  directory (nothing to inject — the master is the test
                  process).
  crash mid-save  :func:`crash_before_publish` swaps the checkpoint
                  module's atomic-rename chokepoint for a raiser, so a
                  save dies *after* writing its temp data but *before*
                  publishing — the window where a non-atomic design would
                  corrupt the previous snapshot.

The clock is first-class: :class:`VirtualClock` is a tiny advance-only
timeline that the injector and the ``HeartbeatMonitor``/``StragglerPolicy``
``now=`` parameters share, and that a serving loop can share too — one test
can script request arrivals, heartbeats, straggler reports and worker kills
on a single deterministic timeline.  :class:`WallClock` is the
drop-in production counterpart (real time advances itself, so ``advance``
is the no-op that lets the serve loop charge modeled service time only on
virtual timelines).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

from repro_torch.checkpoint import checkpoint as _ckpt_mod
from repro_torch.core.engine import AdHashEngine
from .fault_tolerance import HeartbeatMonitor

__all__ = ["CheckpointCrash", "crash_before_publish", "FaultInjector",
           "run_with_failure", "VirtualClock", "WallClock"]


class VirtualClock:
    """Advance-only deterministic timeline (seconds, starts at 0).

    Everything time-driven in the failure/serving harnesses reads the same
    instance: the fault injector ticks it, the heartbeat monitor and the
    straggler policy receive it through their ``now=`` parameters, and the
    serve loop charges modeled service time to it.  Tests never sleep."""

    def __init__(self, now: float = 0.0):
        self._now = float(now)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual time cannot rewind (dt={dt})")
        self._now += float(dt)
        return self._now

    def advance_to(self, t: float) -> float:
        """Jump forward to absolute time ``t`` (no-op if already past)."""
        self._now = max(self._now, float(t))
        return self._now

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"VirtualClock(now={self._now:.6f})"


class WallClock:
    """The production clock: ``time.monotonic`` with a no-op ``advance``
    (real execution advances real time by itself — charging modeled service
    time is a virtual-timeline concept)."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> float:
        return self.now()

    def advance_to(self, t: float) -> float:
        return self.now()


class CheckpointCrash(RuntimeError):
    """Injected crash between writing checkpoint data and publishing it."""


@contextmanager
def crash_before_publish():
    """Make the next atomic publish raise instead of renaming.

    Patches ``repro_torch.checkpoint.checkpoint._atomic_publish`` — the single
    chokepoint every checkpoint write goes through — so the temp file/dir
    exists but the published name never appears.  ``restore_latest`` /
    ``load_adaptivity`` must still see the previous intact snapshot."""
    real = _ckpt_mod._atomic_publish

    def boom(src, dst):
        raise CheckpointCrash(f"injected crash before publishing {dst}")

    _ckpt_mod._atomic_publish = boom
    try:
        yield
    finally:
        _ckpt_mod._atomic_publish = real


@dataclass
class FaultInjector:
    """Virtual-clock failure harness around an engine + heartbeat monitor.

    ``tick`` advances the clock, beats every live worker and syncs the
    engine's health state — the one place the HEALTHY/DEGRADED transition
    happens, so tests and benches exercise the production path rather than
    poking ``health.mark_failed`` directly.

    The timeline lives in :attr:`clock` (a :class:`VirtualClock` by
    default) so other time-driven components — a serving loop, say — can
    share it: one test then scripts arrivals, heartbeats, straggler reports
    and failures against a single deterministic clock."""

    engine: AdHashEngine
    monitor: HeartbeatMonitor
    clock: VirtualClock = field(default_factory=VirtualClock)
    dead: set[int] = field(default_factory=set)

    @property
    def now(self) -> float:
        return self.clock.now()

    def tick(self, dt: float = 1.0) -> bool:
        """Advance time; returns True if the health state changed."""
        self.clock.advance(dt)
        for w in range(self.engine.w):
            if w not in self.dead:
                self.monitor.beat(w, now=self.now)
        return self.engine.health.sync(self.monitor, now=self.now)

    def sync(self) -> bool:
        """Re-sync health at the current time without beating anyone —
        the serve loop's per-pump detector poll (silent workers cross the
        deadline as the *loop's* clock advances, no tick needed)."""
        return self.engine.health.sync(self.monitor, now=self.now)

    def kill(self, worker: int) -> None:
        """Stop a worker's heartbeats (detector declares it failed once the
        timeout elapses — call ``tick`` past the deadline)."""
        self.dead.add(worker)

    def restart(self, worker: int) -> None:
        """Bring a worker back: re-register with the monitor and sync, so
        the engine leaves degraded mode immediately."""
        self.dead.discard(worker)
        self.monitor.register(worker, now=self.now)
        self.engine.health.sync(self.monitor, now=self.now)


def run_with_failure(
    engine: AdHashEngine,
    queries,
    kill_at: int,
    worker: int,
    recover_at: int | None = None,
    timeout_s: float = 5.0,
):
    """Run a workload, killing ``worker`` just before query ``kill_at`` and
    (optionally) restarting it just before ``recover_at``.

    Returns ``(results, routes)`` — per-query relations and the route each
    answer took, so callers can assert the healthy/degraded/recovered
    sequence and compare answers bit-for-bit against an uninterrupted
    twin."""
    monitor = HeartbeatMonitor(engine.w, timeout_s=timeout_s, now=0.0)
    inj = FaultInjector(engine, monitor)
    results, routes = [], []
    for i, q in enumerate(queries):
        if i == kill_at:
            inj.kill(worker)
            inj.tick(2 * timeout_s)  # cross the detector deadline
        elif recover_at is not None and i == recover_at:
            inj.restart(worker)
        else:
            inj.tick(0.5)
        rel, st = engine.query(q)
        results.append(rel)
        routes.append(st.route)
    return results, routes
