"""Fault tolerance & master recovery (DESIGN §9; paper §3.1).

PyTorch port of ``repro.runtime.fault_tolerance``.  The paper's recovery
story, mapped onto this framework:

  master state   dictionary + global statistics are read-only after
                 bootstrap -> persisted once, reloaded on master restart.
  heat map / PI  reconstructed by replaying the (append-only) query log —
                 :func:`replay_query_log` drives the engine's *own*
                 post-query adaptivity hook (``AdHashEngine.observe``), so
                 replay and live execution share one code path: heat-map
                 insert -> IRD -> hot-key rebalancing, with the PI
                 containment check ticking the LRU clock exactly as a live
                 query does.  ``CheckpointManager.save_adaptivity`` can
                 short-circuit the replay with a full snapshot;
                 :func:`recover_master` composes both.
  worker shards  hash placement is *stateless*: under the default policy
                 worker w owns H(s) mod W (a directory placement adds only
                 its small exception table — ``placement.fingerprint()`` —
                 to the recoverable state, persisted by
                 ``CheckpointManager.save_placement``).  On worker loss the
                 replacement re-derives its shard from the data source (or
                 a checkpoint); on elastic resize W -> W', shards are
                 re-derived with the new modulus (``rehash_assignments``).
                 Replica-index contents are disposable (cache semantics):
                 they are rebuilt by the IRD process as queries arrive —
                 the pay-as-you-go property makes replica loss a
                 performance event, not a correctness event.
  worker loss    while a shard is down (``HeartbeatMonitor`` silence past
                 the timeout -> ``engine.health``), the engine keeps
                 answering: PI hits are demoted from the zero-collective
                 shard-local route to the distributed route
                 (``QueryStats.route == "<substrate>-degraded"``), answers
                 bit-identical throughout.  See repro_torch.core.health.
  LM training    atomic checkpoints of the LM and its optimizer state
                 (repro_torch.checkpoint, the reference's leaf names) on
                 one device; the multi-pod loop needs data-parallel
                 training (ROADMAP.md §1 item 12d.2), and the policy below is the step-boundary
                 logic it will use.

Straggler mitigation (``StragglerPolicy``) lives at the step boundary:
per-step deadlines, skip-and-log for late pods (the gradient reduction over
pods tolerates a missing contribution by re-weighting), and eviction of a
pod that misses too many.  A pod that crashes hard and stops reporting
entirely is treated as past-deadline — silence is failure, not health — and
an evicted pod leaves the re-weighting denominator.  The policy is pure
host logic, tested with injected report times.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.engine import AdHashEngine
from repro_torch.core.partition import hash_ids
from repro_torch.core.query import Query

__all__ = ["replay_query_log", "recover_master", "rehash_assignments",
           "StragglerPolicy", "HeartbeatMonitor"]


def replay_query_log(engine: AdHashEngine, queries: list[Query]) -> None:
    """Rebuild heat map + pattern index by replaying the query log
    (paper §3.1: 'The PI can be easily recovered by reading the query log
    and reconstructing the heat map').

    Each query runs through ``engine.observe`` — the exact adaptivity
    suffix of a live ``engine.query`` (PI containment check with its LRU
    touch, heat-map insert, IRD, hot-key rebalancing) — so a replayed
    workload reproduces PI fingerprints, placement splits and replica
    footprints bit-identically, under hash *and* directory placement."""
    for q in queries:
        engine.observe(q)


def recover_master(
    mgr,
    triples: np.ndarray,
    n_workers: int,
    **engine_kwargs,
) -> AdHashEngine:
    """Full master recovery from a ``CheckpointManager`` directory.

    1. rebuild the placement policy from its snapshot (base shards
       re-derived under the new modulus when W changed),
    2. bootstrap a fresh engine over the data source,
    3. restore the newest adaptivity snapshot, if any (bit-identical on the
       same W; dropped on elastic restore),
    4. replay the query-log suffix the snapshot does not cover — or the
       whole log when there is no usable snapshot (pay-as-you-go).

    Returns the recovered engine; its PI fingerprint matches the crashed
    master's once the replay completes."""
    placement = mgr.load_placement(n_workers)
    engine = AdHashEngine(triples, n_workers, placement=placement,
                          **engine_kwargs)
    offset = mgr.restore_adaptivity(engine)
    replay_query_log(engine, mgr.load_query_log()[offset:])
    return engine


def rehash_assignments(subjects: np.ndarray, old_w: int, new_w: int
                       ) -> np.ndarray:
    """Elastic resize: which triples move when W changes (mod-W re-hash).

    Returns a boolean mask of triples whose owner changes; the expected
    fraction is 1 - old_w/new_w for growth (minimal movement is a property
    hash partitioning gives up; the paper accepts it for startup speed —
    consistent-hash variants can be layered on the same interface).
    """
    h = hash_ids(subjects)
    return (h % old_w) != (h % new_w)


@dataclass
class StragglerPolicy:
    """Step-boundary straggler handling for the multi-pod training loop.

    The policy tracks the *known* pod set: a pod that reported once and
    then goes silent (hard crash, network partition) keeps being classified
    — silence counts as a missed deadline — and is evicted after
    ``max_consecutive_skips`` exactly like a persistently slow pod.
    Evicted pods stay evicted and drop out of the re-weighting denominator
    (``reweight`` keeps the gradient unbiased over the *active* pods, not
    the original fleet)."""

    deadline_s: float = 30.0
    max_consecutive_skips: int = 3
    skipped: dict[int, int] = field(default_factory=dict)
    known_pods: set[int] = field(default_factory=set)
    evicted: set[int] = field(default_factory=set)

    def register(self, pods) -> None:
        """Declare the pod fleet up front (otherwise pods become known on
        their first report — too late for one that never reports)."""
        self.known_pods.update(int(p) for p in pods)

    def classify_at(self, report_times: dict[int, float], step_start: float,
                    now: float) -> dict[int, str]:
        """Virtual-clock variant of :meth:`classify`: ``report_times`` are
        *absolute* completion timestamps on the same timeline the fault
        injector shares (a
        ``repro_torch.runtime.fault_injection.VirtualClock``).  Only reports that
        have already happened by ``now`` are visible; a pod whose report
        lies in the future — or that never reported — is silent, exactly
        the hard-crash case :meth:`classify` treats as past-deadline.  Call
        it at (or after) the step deadline, like the step loop would."""
        if now < step_start:
            raise ValueError(f"now={now} precedes step_start={step_start}")
        return self.classify({
            pod: t - step_start
            for pod, t in report_times.items() if t <= now
        })

    def classify(self, pod_times: dict[int, float]) -> dict[int, str]:
        """'ok' | 'straggler' | 'evict' per known pod.  A pod missing from
        ``pod_times`` is past-deadline by definition — it never reported."""
        self.known_pods.update(pod_times)
        out: dict[int, str] = {}
        for pod in sorted(self.known_pods):
            if pod in self.evicted:
                out[pod] = "evict"
                continue
            t = pod_times.get(pod)
            if t is not None and t <= self.deadline_s:
                out[pod] = "ok"
                self.skipped[pod] = 0
            else:
                n = self.skipped.get(pod, 0) + 1
                self.skipped[pod] = n
                if n > self.max_consecutive_skips:
                    out[pod] = "evict"
                    self.evicted.add(pod)
                else:
                    out[pod] = "straggler"
        return out

    def reweight(self, statuses: dict[int, str]) -> dict[int, float]:
        """Gradient re-weighting when pods are skipped: surviving pods are
        scaled by n_active / n_ok — active excludes evicted pods, so the
        expected gradient stays unbiased over the pods still in the
        fleet."""
        ok = [p for p, s in statuses.items() if s == "ok"]
        if not ok:
            return {p: 0.0 for p in statuses}
        n_active = sum(1 for s in statuses.values() if s != "evict")
        w = n_active / len(ok)
        return {p: (w if s == "ok" else 0.0) for p, s in statuses.items()}


class HeartbeatMonitor:
    """Failure detector: workers report heartbeats; silence past the timeout
    marks a worker failed and triggers shard recovery (re-hash or restore).

    Registration time counts as the first sign of life, so a worker that
    *never* beats is declared failed one timeout after registration — not
    never.  A recovered (or replacement) worker re-enters the fleet through
    :meth:`register`, which opens a fresh timeout window; the engine picks
    the transition up via ``engine.health.sync(monitor)``."""

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 now: float | None = None):
        self.timeout = timeout_s
        start = now if now is not None else time.monotonic()
        self.last_seen = {w: start for w in range(n_workers)}

    def beat(self, worker: int, now: float | None = None) -> None:
        self.last_seen[worker] = now if now is not None else time.monotonic()

    def register(self, worker: int, now: float | None = None) -> None:
        """(Re-)register a worker after recovery or replacement: it leaves
        the failed set and gets a full timeout window to start beating."""
        self.last_seen[worker] = now if now is not None else time.monotonic()

    def failed_workers(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.monotonic()
        return sorted(
            w for w, t in self.last_seen.items() if now - t > self.timeout
        )

    def recovery_plan(self, failed: list[int], n_workers: int) -> dict:
        """Shard-recovery plan: failed worker shards are re-derivable from
        the deterministic partitioner; replicas rebuild lazily via IRD."""
        return {
            "restore": {w: f"subject-hash shard {w} of {n_workers}" for w in failed},
            "replicas": "rebuilt lazily by IRD (cache semantics)",
        }
