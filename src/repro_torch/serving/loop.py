"""The online serving loop: continuous batching under a latency SLO.

PyTorch port of ``repro.serving.loop``.  ``ServeLoop`` turns the offline
workload engine (``AdHashEngine.query_batch``) into a request-stream
front-end (DESIGN §10).  The pieces:

  ingress       a bounded FIFO the :class:`AdmissionController` guards;
                ``offer`` either enqueues a request or returns
                :class:`RetryAfter` backpressure.
  control pass  ``pump`` dequeues admitted requests one at a time through
                ``engine.stream_control_step`` — the *same* unit an offline
                ``query_batch`` repeats, so the adaptivity state machine
                (heat map, IRD, pattern index, LRU clocks) sees exactly the
                admission order and a served stream is bit-identical to an
                offline run of its admitted-and-answered subsequence.
                PI hits execute inline; everything else joins a
                ``WorkloadBatcher`` shape bucket.
  continuous batching
                a bucket is dispatched when it *fills* (``batch_target``),
                when its oldest member's SLO deadline approaches
                (``flush_margin``), when the member has waited ``max_wait_s``
                (age flush), or when ingress backs up while the bucket
                window is full (pressure flush) — batch sizes stay
                power-of-two quantized, so none of these paths mints a new
                jit cache entry once the shape set is warm.
  load shedding a request whose deadline expires while still in ingress is
                shed *before* the control pass: it never touches adaptivity
                state and is never answered (:class:`SheddedResult`, counted,
                never silent).  Answers that complete past deadline are
                flagged ``late``.
  overload ladder
                :class:`BrownoutController` watches queue occupancy.  Rung 1
                defers adaptivity (``engine.adaptivity_paused`` — the
                engine's degraded-mode pause+catch-up path, heat map keeps
                counting);
                rung 2 tightens admission.  Background work is shed before
                any query is.
  health        an optional ``HeartbeatMonitor`` is polled every pump on the
                loop clock; degraded episodes tighten admission
                (``degraded_admit_factor``) and demote PI hits exactly as in
                the offline engine.
  checkpointing an optional ``CheckpointManager`` persists the query log +
                a full adaptivity snapshot every ``checkpoint_interval_s``
                of loop time; a crash mid-save (``CheckpointCrash``/OSError)
                is counted and retried next interval, and ``recover_master``
                loses at most one interval of adaptivity learning.

Time is injected, never sampled: on a ``VirtualClock`` with a
``service_model`` the loop is a deterministic discrete-event simulation
(tests script arrivals/failures/heartbeats on one timeline and never
sleep); on a ``VirtualClock`` *without* a model, measured wall seconds are
charged to the virtual timeline (the benchmark's honest-latency mode); on a
``WallClock`` charges are no-ops and real time rules (production).

The engine's calls return before the card has finished their kernels, so in
measured mode the loop synchronizes the engine's device before it reads each
stop time: a charge covers the card's work, not only its enqueueing.  In
modelled mode it adds no sync, and the simulation is the reference's.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import torch

from repro_torch.core.batcher import Bucket, WorkloadBatcher
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.executor import ExecutorError
from repro_torch.core.tracing import span
from repro_torch.runtime.fault_injection import CheckpointCrash, WallClock
from .admission import AdmissionController, BrownoutController
from .request import (Request, RetryAfter, ServedResult, ServeReport,
                      SheddedResult)

__all__ = ["ServeConfig", "ServeLoop"]


@dataclass(frozen=True)
class ServeConfig:
    """Knobs of the serving front-end (defaults favour determinism-friendly
    moderate batching; the bench sweeps the interesting ones)."""

    slo_s: float = 0.5              # default latency budget per request
    queue_bound: int = 64           # max in-flight (ingress + bucketed)
    batch_target: int = 8           # flush a bucket at this occupancy
    bucket_window: int = 32         # max control-passed requests awaiting
    flush_margin_s: float | None = None   # deadline slack; None -> 2x svc est
    max_wait_s: float | None = None       # age flush; None -> deadline only
    shed_margin_s: float = 0.0      # shed when slack falls below this
    predictive_shed: bool = True    # also shed when slack < service estimate
    client_rate_per_s: float | None = None
    client_burst: float = 8.0
    degraded_admit_factor: float = 0.5
    brownout_admit_factor: float = 0.5
    brownout_enter: tuple[float, float] = (0.5, 0.85)
    brownout_exit: tuple[float, float] = (0.25, 0.6)
    min_retry_after_s: float = 0.01
    service_init_s: float = 0.02    # prior for the per-batch service EWMA
    service_ewma: float = 0.3
    checkpoint_interval_s: float | None = None


_REJECT_COUNTER = {
    "queue_full": "rejected_queue_full",
    "rate_limited": "rejected_rate_limited",
    "degraded": "rejected_degraded",
    "brownout": "rejected_brownout",
}


class ServeLoop:
    """Continuous-batching serve loop over one :class:`AdHashEngine`.

    Protocol: ``offer(request)`` at arrival (returns ``RetryAfter`` or
    None), ``pump()`` whenever the caller wants work done (runs everything
    due at the current clock time, returns newly resolved
    ``ServedResult``/``SheddedResult`` objects), ``next_due()`` for the next
    absolute time something becomes due (replays jump a virtual clock
    there), ``drain()`` at end-of-stream to resolve every remaining request.
    """

    def __init__(self, engine: AdHashEngine, cfg: ServeConfig | None = None,
                 clock=None, service_model=None, checkpoint=None,
                 monitor=None):
        self.engine = engine
        self.cfg = cfg or ServeConfig()
        self.clock = clock if clock is not None else WallClock()
        # service_model(batch_size) -> seconds charges *modeled* time to a
        # virtual clock (deterministic tests); None charges measured wall
        # seconds instead (the bench's honest mode; no-op on a WallClock)
        self.service_model = service_model
        self.checkpoint = checkpoint
        self.monitor = monitor
        self.batcher = WorkloadBatcher(
            engine.executor.locality_aware, engine.executor.pinned_opt,
            engine.placement.local_join_safe,
        )
        self.admission = AdmissionController(
            queue_bound=self.cfg.queue_bound,
            client_rate_per_s=self.cfg.client_rate_per_s,
            client_burst=self.cfg.client_burst,
            degraded_admit_factor=self.cfg.degraded_admit_factor,
            brownout_admit_factor=self.cfg.brownout_admit_factor,
            min_retry_after_s=self.cfg.min_retry_after_s,
        )
        self.brownout = BrownoutController(self.cfg.brownout_enter,
                                           self.cfg.brownout_exit)
        self.report = ServeReport()
        self.query_log: list = []   # admitted control order == replay order
        self.queue: deque[Request] = deque()
        self._waiting: dict = {}      # rid -> Request (bucketed, unexecuted)
        self._demoted: set = set()    # rids of degraded-demoted PI hits
        self._results: dict = {}      # execute_bucket target: rid -> triple
        self._completions: list = []
        self._svc_s = self.cfg.service_init_s   # EWMA seconds per dispatch
        self._qps = 1.0 / max(self.cfg.service_init_s, 1e-9)
        self._overlap_spent = 0.0   # service charged inside control steps
        self._last_ckpt: float | None = None
        self._ckpt_step = 0

    # ----------------------------------------------------------- occupancy
    def in_flight(self) -> int:
        """Requests inside the server: ingress + bucketed-awaiting."""
        return len(self.queue) + len(self._waiting)

    def take_completions(self) -> list:
        out, self._completions = self._completions, []
        return out

    # -------------------------------------------------------------- ingress
    def offer(self, req: Request) -> RetryAfter | None:
        """Admit or reject one arriving request (None == admitted)."""
        now = self.clock.now()
        if req.arrival_s is None:
            req.arrival_s = now
        if req.deadline_s is None:
            req.deadline_s = req.arrival_s + self.cfg.slo_s
        self._sync_health(now)
        self._update_brownout(now)
        self.report.offered += 1
        verdict = self.admission.admit(
            req, now, self.in_flight(), self.brownout.level,
            self.engine.health.degraded, self._qps,
        )
        if verdict is not None:
            counter = _REJECT_COUNTER[verdict.reason]
            setattr(self.report, counter, getattr(self.report, counter) + 1)
            return verdict
        self.queue.append(req)
        self._update_brownout(now)
        return None

    # ----------------------------------------------------------------- pump
    def pump(self) -> list:
        """Run everything due at the current clock time; return newly
        resolved results (served + shed, in resolution order)."""
        while self._step():
            pass
        self._maybe_checkpoint()
        return self.take_completions()

    def next_due(self) -> float | None:
        """Next absolute clock time at which ``pump`` will have work (None
        when nothing is pending) — virtual-clock replays jump here instead
        of busy-polling."""
        times = []
        margin = self._flush_margin()
        for k, (oldest, entered, _b) in enumerate(self._bucket_info()):
            # inverse of the EDF feasibility check in _due_bucket: position
            # k in the deadline chain becomes due k+1 service times early
            times.append(oldest - margin - (k + 1) * self._svc_s)
            if self.cfg.max_wait_s is not None:
                times.append(entered + self.cfg.max_wait_s)
        horizon = self._shed_horizon()
        for r in self.queue:
            times.append(r.deadline_s - horizon)
        if (self.checkpoint is not None
                and self.cfg.checkpoint_interval_s is not None
                and self._last_ckpt is not None):
            times.append(self._last_ckpt + self.cfg.checkpoint_interval_s)
        if not times:
            return None
        return max(self.clock.now(), min(times))

    def drain(self) -> list:
        """End-of-stream: resolve every remaining request (force-flushing
        buckets below target regardless of deadlines) and return the tail
        of results."""
        while True:
            while self._step():
                pass
            bucket = self.batcher.pop_bucket(force=True)
            if bucket is None:
                break
            self._run_bucket(bucket, "drain")
        self._maybe_checkpoint()
        return self.take_completions()

    # ------------------------------------------------------------ internals
    def _sync_health(self, now: float) -> None:
        if self.monitor is not None:
            self.engine.health.sync(self.monitor, now=now)

    def _update_brownout(self, now: float) -> None:
        occ = self.in_flight() / max(1, self.cfg.queue_bound)
        if self.brownout.update(occ):
            self.report.brownout_events.append((now, self.brownout.level))
        if self.engine.adaptive:
            # rung 1 of the ladder: shed background adaptivity work first
            # (the degraded-mode pause in the engine composes with this —
            # either condition defers, the heat map keeps counting)
            self.engine.adaptivity_paused = self.brownout.level >= 1

    def _flush_margin(self) -> float:
        m = self.cfg.flush_margin_s
        return m if m is not None else self._svc_s

    def _shed_horizon(self) -> float:
        """Slack below which a queued request is doomed: it cannot clear the
        dispatch backlog already ahead of it (every open bucket costs one
        service time) plus its own service before the deadline.  Predictive
        shedding on this horizon is what keeps *admitted* p99 under the SLO
        at 2x overload — serving a doomed request would be silent lateness
        plus stolen capacity."""
        if self.cfg.predictive_shed:
            backlog = self._svc_s * (1 + len(self.batcher))
            return max(self.cfg.shed_margin_s, backlog)
        return self.cfg.shed_margin_s

    def _step(self) -> bool:
        """One unit of due work; False when nothing is due *right now*."""
        now = self.clock.now()
        self._sync_health(now)
        self._shed_expired(now)
        self._update_brownout(now)
        due = self._due_bucket(now)
        if due is not None:
            bucket, reason = due
            self._run_bucket(bucket, reason)
            return True
        if self.queue:
            if len(self._waiting) < self.cfg.bucket_window:
                self._control(self.queue.popleft())
                return True
            # window full and ingress backing up: the server must not idle —
            # dispatch the oldest bucket at whatever size it reached
            forced = self.batcher.pop_bucket(force=True)
            if forced is not None:
                self._run_bucket(forced, "pressure")
                return True
        return False

    def _shed_expired(self, now: float) -> None:
        """Deadline shedding, strictly pre-control-pass: expired requests
        leave from ingress and never touch adaptivity state."""
        if not self.queue:
            return
        kept: deque[Request] = deque()
        horizon = self._shed_horizon()
        for r in self.queue:
            if r.deadline_s - horizon <= now:
                self._shed(r, now)
            else:
                kept.append(r)
        self.queue = kept

    def _shed(self, req: Request, now: float) -> None:
        self.report.shed += 1
        self._completions.append(
            SheddedResult(req.rid, now, req.deadline_s, "deadline"))

    def _bucket_info(self) -> list[tuple[float, float, Bucket]]:
        """(oldest deadline, oldest entry time, bucket), deadline-sorted."""
        info = [
            (min(self._waiting[t].deadline_s for t in b.tags),
             min(self._waiting[t].bucketed_s for t in b.tags), b)
            for b in self.batcher.buckets()
        ]
        info.sort(key=lambda x: x[0])
        return info

    def _due_bucket(self, now: float) -> tuple[Bucket, str] | None:
        """The most urgent dispatchable bucket.

        The deadline trigger is an EDF feasibility check over the *whole*
        dispatch chain, not a per-bucket margin: walking buckets in deadline
        order, if the k-th one cannot start late enough to finish by its
        deadline after the k-1 dispatches ahead of it (one service estimate
        each), the chain's head must go *now* — this is what keeps admitted
        p99 under the SLO when several buckets' deadlines land together
        (a per-bucket margin covers one dispatch, not the queue of them)."""
        info = self._bucket_info()
        if not info:
            return None
        margin = self._flush_margin()
        t = now
        for oldest, _entered, _b in info:
            t += self._svc_s
            # inclusive: next_due() reports the instant this becomes true,
            # and the replay wakes exactly then
            if t + margin >= oldest:
                head = info[0][2]
                reason = ("full" if len(head) >= self.cfg.batch_target
                          else "deadline")
                return self.batcher.pop(head.plan), reason
        for oldest, entered, b in info:   # age flush (max_wait_s)
            if (self.cfg.max_wait_s is not None
                    and now - entered >= self.cfg.max_wait_s):
                reason = ("full" if len(b) >= self.cfg.batch_target
                          else "deadline")
                return self.batcher.pop(b.plan), reason
        for oldest, _entered, b in info:  # size trigger, earliest deadline
            if len(b) >= self.cfg.batch_target:
                return self.batcher.pop(b.plan), "full"
        return None

    def _control(self, req: Request) -> None:
        """One admitted request through the shared control pass."""
        now = self.clock.now()
        if req.deadline_s - self._shed_horizon() <= now:
            self._shed(req, now)   # doomed while at the head of ingress
            return
        if self.engine.adaptive and (self.engine.adaptivity_paused
                                     or self.engine.health.degraded):
            self.report.adaptivity_deferrals += 1
        # registered *before* the control step: the overlapped-IRD callback
        # may pop and execute the very bucket this request joins
        self._waiting[req.rid] = req
        req.bucketed_s = now
        self.query_log.append(req.query)
        spent0 = self._overlap_spent
        t0 = time.perf_counter()
        with span("serve.control"):
            executed, demoted = self.engine.stream_control_step(
                req.query, self.batcher, req.rid, overlap=self._overlap)
            self._sync_measured()
        ctrl_s = time.perf_counter() - t0
        if executed is not None:
            # PI hit, executed inline over the replica index
            del self._waiting[req.rid]
            req.dispatched_s = now
            rel, qstats, dt = executed
            if self.service_model is not None:
                self.clock.advance(self.service_model(1))
            else:
                # measured mode: charge the control step minus whatever the
                # overlap callback already charged for bucket execution
                self.clock.advance(
                    max(0.0, ctrl_s - (self._overlap_spent - spent0)))
            self._finish(req, rel, qstats, dt, demoted=False)
        else:
            if demoted:
                self._demoted.add(req.rid)
            if self.service_model is None:
                self.clock.advance(
                    max(0.0, ctrl_s - (self._overlap_spent - spent0)))

    def _overlap(self) -> None:
        """Evaluate a ready multi-query bucket while IRD collectives are in
        flight (mirrors ``query_batch``'s overlap closure)."""
        bucket = self.batcher.pop_bucket()
        if bucket is not None:
            self._run_bucket(bucket, "overlap")

    def _run_bucket(self, bucket: Bucket, reason: str) -> None:
        """Dispatch one bucket, charge its service time, resolve members."""
        t0 = time.perf_counter()
        dispatched = self.clock.now()
        try:
            with span("serve.dispatch"):
                self.engine.execute_bucket(bucket, self._results)
                self._sync_measured()
        except ExecutorError:
            # even the per-member sequential fallback failed: report the
            # casualties and keep the stream alive
            now = self.clock.now()
            for rid in bucket.tags:
                req = self._waiting.pop(rid)
                self._demoted.discard(rid)
                self._results.pop(rid, None)
                self.report.unexecutable += 1
                self._completions.append(
                    SheddedResult(rid, now, req.deadline_s, "unexecutable"))
            return
        wall = time.perf_counter() - t0
        charge = (self.service_model(len(bucket))
                  if self.service_model is not None else wall)
        self.clock.advance(charge)
        self._overlap_spent += charge
        self._note_service(len(bucket), charge)
        setattr(self.report, f"flush_{reason}",
                getattr(self.report, f"flush_{reason}") + 1)
        for rid in bucket.tags:
            req = self._waiting.pop(rid)
            req.dispatched_s = dispatched
            rel, qstats, dt = self._results.pop(rid)
            demoted = rid in self._demoted
            self._demoted.discard(rid)
            self._finish(req, rel, qstats, dt, demoted=demoted)

    def _finish(self, req: Request, rel, qstats, dt: float,
                demoted: bool) -> None:
        if demoted:
            # tag only — record_served counts demotions by route suffix
            qstats.route = f"{self.engine.substrate.name}-degraded"
        now = self.clock.now()
        latency = now - req.arrival_s
        late = now > req.deadline_s + 1e-12
        self.engine.record_served(qstats, dt)
        self.report.answered += 1
        if late:
            self.report.late += 1
        self.report.latencies_s.append(latency)
        self._completions.append(
            ServedResult(req.rid, rel, qstats, now, latency, late,
                         req.bucketed_s, req.dispatched_s))

    def _sync_measured(self) -> None:
        """Measured mode: wait for the engine's device before a stop time
        is read, so the charge includes kernels still queued.  A no-op on
        the CPU and in modelled mode (the simulation adds no sync)."""
        if self.service_model is None and self.engine.device.type == "cuda":
            torch.cuda.synchronize(self.engine.device)

    def _note_service(self, n: int, charge: float) -> None:
        a = self.cfg.service_ewma
        self._svc_s = (1 - a) * self._svc_s + a * charge
        self._qps = (1 - a) * self._qps + a * (n / max(charge, 1e-9))

    def _maybe_checkpoint(self) -> None:
        if self.checkpoint is None or self.cfg.checkpoint_interval_s is None:
            return
        now = self.clock.now()
        if self._last_ckpt is None:
            self._last_ckpt = now   # interval starts at first pump
            return
        if now - self._last_ckpt < self.cfg.checkpoint_interval_s:
            return
        # the window advances even when the save fails (retry next interval,
        # don't turn one bad disk into a save storm)
        self._last_ckpt = now
        self._ckpt_step += 1
        try:
            self.checkpoint.save_engine_state(self.engine, self.query_log)
            self.checkpoint.save_adaptivity(self.engine, step=self._ckpt_step)
            self.report.checkpoint_saves += 1
        except (OSError, CheckpointCrash):
            self.report.checkpoint_failures += 1
