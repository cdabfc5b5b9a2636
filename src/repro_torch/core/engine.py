"""AdHash engine facade (paper §3, system overview §3.4).

PyTorch port of ``repro.core.engine``.  Bootstraps like the paper: encode
-> subject-hash partition -> load worker shards -> collect statistics ->
answer queries.  Per query:

  1. transform Q into its redistribution tree Q' (Algorithm 2),
  2. if Q' is contained in the Pattern Index -> parallel mode over the
     replica index (zero communication),
  3. else if Q is a subject-star -> parallel mode over the main index,
  4. else -> locality-aware DP plan + distributed execution (Algorithm 1),
  5. adaptivity: update the heat map, detect hot patterns, trigger IRD,
     enforce the replication budget via LRU eviction.

``adaptive=False`` yields the paper's AdHash-NA baseline.  The ablation
flags (§6.3.1) pass through to the distributed executor.  ``query_batch``
evaluates a workload with one batched pipeline per shape bucket.
``placement="directory"`` adds hot-key rebalancing: when one shard holds
more than ``skew_threshold`` times the mean load, the hottest subjects on
it are split over several shards and the main store is moved.
``substrate=MeshSubstrate(...)`` / ``DistributedSubstrate()`` splits W over
the ranks of a process group: every rank builds the same engine (SPMD),
loads its worker block, and runs every query; the exchanges are
collectives and every answer, stat and adaptivity decision is the single
device's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .backend import quantize_capacity, resolve_device
from .batcher import WorkloadBatcher
from .dictionary import Dictionary
from .executor import Executor, ExecutorError, QueryStats
from .health import HealthState
from .heatmap import HeatMap
from .ingest import StreamIngestor
from .ird import IncrementalRedistributor
from .pattern_index import ParallelExecutor, PatternIndex, ReplicaIndex
from .placement import resolve_placement
from .planner import LocalityAwarePlanner
from .query import Query, TriplePattern
from .relation import Relation
from .substrate import SingleDeviceSubstrate
from .transform import build_redistribution_tree

__all__ = ["AdHashEngine", "EngineReport"]


@dataclass
class EngineReport:
    """Cumulative workload accounting (paper Figs. 13/14)."""

    n_queries: int = 0
    n_parallel: int = 0
    n_parallel_replica: int = 0
    n_distributed: int = 0
    comm_cells: int = 0
    ird_comm_cells: int = 0
    ird_triples: int = 0
    n_redistributions: int = 0
    n_evictions: int = 0
    n_rebalances: int = 0  # hot-key splits published (directory placement)
    rebalance_comm_cells: int = 0  # main-store cells moved by rebalances
    n_degraded: int = 0  # shard-local queries (PI hits + main-index chains)
    # demoted to the distributed route by a dark shard (DESIGN §9/§11)
    n_batch_dispatches: int = 0  # batched-pipeline launches (query_batch)
    wall_time_s: float = 0.0
    history: list[tuple[str, int, float]] = field(default_factory=list)

    @property
    def comm_bytes(self) -> int:
        return (self.comm_cells + self.ird_comm_cells) * 4


class AdHashEngine:
    """``triples`` may be a host array (one-shot bootstrap) or an iterator
    of (n, 3) chunks (streaming bootstrap) — both flow through
    :class:`repro_torch.core.ingest.StreamIngestor`, so a chunked ingest
    produces a store bit-identical to the one-shot build.  The store and
    the replica modules live on ``device`` (default ``"cuda"``; ``"cuda"``
    without a card raises)."""

    def __init__(
        self,
        triples,
        n_workers: int,
        *,
        dictionary: Dictionary | None = None,
        adaptive: bool = True,
        frequency_threshold: int = 10,
        replication_budget: int | None = None,  # max replica triples / worker
        heuristic: str = "high_low",
        locality_aware: bool = True,
        pinned_opt: bool = True,
        capacity: int = 1 << 12,
        use_count_oracle: bool = True,
        substrate=None,
        placement=None,
        skew_threshold: float = 2.0,
        local_chain: bool = True,
        device: str | torch.device = "cuda",
    ):
        t0 = time.perf_counter()
        self.device = resolve_device(device)
        self.w = n_workers
        self.dictionary = dictionary
        self.adaptive = adaptive
        self.threshold = frequency_threshold
        self.budget = replication_budget
        self.heuristic = heuristic
        self.capacity = quantize_capacity(capacity)
        self.substrate = substrate if substrate is not None else \
            SingleDeviceSubstrate()
        self.substrate.check_workers(n_workers)
        sub_dev = getattr(self.substrate, "device", None)
        if sub_dev is not None and sub_dev.type != self.device.type:
            raise ValueError(f"the substrate's rank device {sub_dev} is not "
                             f"the engine's device {self.device}")
        self.placement = resolve_placement(placement, n_workers)
        self.skew_threshold = float(skew_threshold)

        # bootstrap (paper §3.4): partition, load, collect statistics — one
        # code path for a host array (one chunk) and a chunk iterator
        ingestor = StreamIngestor(n_workers, placement=self.placement,
                                  substrate=self.substrate)
        if isinstance(triples, (np.ndarray, list, tuple)):
            arr = np.asarray(triples)
            if arr.size:
                ingestor.add_chunk(arr)
        else:
            for chunk in triples:
                ingestor.add_chunk(chunk)
        self.store, self.stats, self.n_ids = ingestor.finish(self.device)

        # split-candidate pool for the skew detector: the top subjects by
        # out-degree (star size == data-balance impact), scored against the
        # heat map at trigger time.  Only built for policies that can split.
        self._split_candidates: tuple[np.ndarray, np.ndarray] | None = (
            ingestor.split_candidates()
            if self.placement.supports_split else None
        )

        # worker health: while any shard is failed, PI hits and main-index
        # chains are demoted from the shard-local routes to the distributed
        # route and adaptivity writes are suspended (DESIGN §9) — created
        # before the Executor so route selection can consult it
        self.health = HealthState(n_workers)

        oracle = self._count_pattern if use_count_oracle else None
        self.planner = LocalityAwarePlanner(self.stats, n_workers, oracle)
        self.executor = Executor(
            self.store, n_workers, locality_aware, pinned_opt,
            substrate=self.substrate, placement=self.placement,
            health=self.health, local_chain=local_chain,
        )
        self.heatmap = HeatMap()
        self.pattern_index = PatternIndex()
        self.replicas = ReplicaIndex(n_workers, substrate=self.substrate)
        self.parallel_exec = ParallelExecutor(
            self.store, self.replicas, n_workers, substrate=self.substrate,
        )
        self.ird = IncrementalRedistributor(
            self.store, self.replicas, n_workers, self.capacity,
            substrate=self.substrate, placement=self.placement,
        )
        self._no_redistribute: set = set()
        # brownout rung 1 (DESIGN §10): a serving front-end sets this under
        # overload to shed *adaptivity* work before shedding queries — IRD
        # is deferred exactly like a degraded episode (the heat map keeps
        # counting, catch-up fires on the first unpaused query)
        self.adaptivity_paused = False
        self.report = EngineReport()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.startup_time_s = time.perf_counter() - t0

    # ------------------------------------------------------------- streaming
    @classmethod
    def ingest_stream(cls, chunks, n_workers: int, **kwargs) -> "AdHashEngine":
        """Bootstrap from an iterable of (n, 3) triple chunks: hash-places
        and buffers chunk by chunk, never holding the concatenated array;
        the store is bit-identical to a one-shot ``AdHashEngine(
        np.concatenate(chunks), ...)``."""
        return cls(iter(chunks), n_workers, **kwargs)

    # ------------------------------------------------------------ cardinality
    def _count_pattern(self, q: TriplePattern) -> int:
        """Exact pattern count via a cheap index probe (planner oracle).  On
        a mesh the per-block sums are summed over the ranks, so every rank
        plans the same join order."""
        from . import dsj

        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, self.device)
        none = torch.full_like(consts[0], -1)
        ranges = self.substrate.match_ranges
        if spec.p_const and spec.s_const:
            lo, hi = ranges(self.store, consts[1], consts[0], False,
                            self.n_ids)
        elif spec.p_const and spec.o_const:
            lo, hi = ranges(self.store, consts[1], consts[2], True,
                            self.n_ids)
        elif spec.p_const:
            lo, hi = ranges(self.store, consts[1], none, False, self.n_ids)
        else:
            lo, hi = ranges(self.store, none, none, False, self.n_ids)
        return int(self.substrate.reduce_sum(torch.sum(hi - lo)))

    # ------------------------------------------------------------------ query
    def query(self, q: Query) -> tuple[Relation, QueryStats]:
        t0 = time.perf_counter()
        # the redistribution tree only feeds the adaptivity machinery
        tree = (
            build_redistribution_tree(q, self.stats, self.heuristic)
            if self.adaptive else None
        )

        # (2) pattern-index hit -> parallel mode over replicas.  While a
        # shard is failed the hit is *demoted*: replica modules would be
        # probed shard-locally — including on the dead shard — so the query
        # runs the distributed route over the main index instead, exact but
        # with communication (DESIGN §9).
        matches = self.pattern_index.match(tree) if self.adaptive else None
        degraded = matches is not None and self.health.degraded
        if matches is not None and not degraded:
            rel, qstats = self.parallel_exec.execute(
                tree, matches, self.capacity
            )
            self.report.n_parallel_replica += 1
        else:
            plan = self.planner.plan(q)
            rel, qstats = self.executor.execute(
                q, plan.ordering, plan.join_vars,
                capacity=max(self.capacity, plan.capacity_hint()),
            )
            if degraded:
                qstats.route = f"{self.substrate.name}-degraded"
            # count every demotion once, by route suffix: PI hits demoted
            # here and main-index chains demoted inside the Executor
            if qstats.route.endswith("-degraded"):
                self.report.n_degraded += 1
            if qstats.mode == "parallel":
                self.report.n_parallel += 1
            else:
                self.report.n_distributed += 1

        # (5) adaptivity: monitor + IRD + hot-key rebalancing
        if self.adaptive:
            self._post_query_adaptivity(tree)

        dt = time.perf_counter() - t0
        self.report.n_queries += 1
        self.report.comm_cells += qstats.comm_cells
        self.report.wall_time_s += dt
        self.report.history.append((qstats.mode, qstats.comm_cells, dt))
        return rel, qstats

    # ------------------------------------------------------------ batch query
    def query_batch(
        self, queries: list[Query]
    ) -> list[tuple[Relation, QueryStats]]:
        """Evaluate a workload with batched multi-query execution.

        Semantically identical to ``[self.query(q) for q in queries]`` —
        results, per-query communication accounting and the adaptivity loop
        (heat-map inserts, IRD triggers, pattern-index state, evictions) all
        behave as if the queries ran sequentially — but same-shape queries
        are stacked on a leading batch axis and evaluated by one pass of
        the batched DSJ stages (one kernel launch per stage for the bucket).

        Two-pass structure, exact by construction:

        1. *Control pass* (sequential, host-side): per query, in order —
           transform, pattern-index match, plan, then heat-map insert + IRD.
           This replays the adaptivity state machine exactly: the routing
           decision for query i sees precisely the redistributions triggered
           by queries 0..i-1.  Pattern-index hits execute immediately (the
           sequential fallback — their replica modules could be evicted by a
           later query's budget enforcement); distributed/parallel queries
           are deferred into :class:`WorkloadBatcher` shape buckets, which is
           safe because they only read the immutable main index.
        2. *Execution pass*: one batched pipeline per bucket (singleton
           buckets run on the sequential executor), then the workload
           report is filled in query order.

        *Overlapped IRD*: when the control pass triggers a redistribution,
        its device work is enqueued without waiting
        (``redistribute_deferred``) and the oldest ready shape bucket is
        planned and launched while that work runs (same stream: the
        overlap hides host work); the barrier
        (``PendingRedistribution.finalize``) runs before the pattern index
        publishes the new entries, so routing decisions for later queries —
        and hence the whole adaptivity state machine — are identical to the
        sequential order.  Overlap only changes *when* already-decided
        buckets execute (they read nothing but the immutable main index),
        never what any query computes.

        Error semantics differ from the sequential loop: if a query is
        genuinely unexecutable (retry budget exhausted even sequentially)
        the same ``ExecutorError`` propagates, but the adaptivity control
        pass has by then processed the *whole* workload — equivalent to the
        failing query having been last — and no partial results or report
        entries are recorded.  That holds on the overlapped path too: an
        error from a bucket evaluated inside an IRD window is deferred until
        the control pass completes, then re-raised.  Only ``ExecutorError``
        is handled so: any other error (out of memory, a CUDA error)
        propagates at once.
        """
        # per query: (Relation, QueryStats, wall seconds)
        results: list[tuple | None] = [None] * len(queries)
        batcher = WorkloadBatcher(
            self.executor.locality_aware, self.executor.pinned_opt,
            self.placement.local_join_safe,
        )
        t_all = time.perf_counter()

        # an overlapped bucket hitting a genuinely unexecutable query must
        # not abort the control pass mid-workload: the error is deferred and
        # re-raised once adaptivity has processed every query, preserving
        # the documented error semantics ("equivalent to the failing query
        # having been last")
        deferred_errors: list[ExecutorError] = []

        def overlap():
            # evaluate the oldest ready multi-query bucket while the IRD
            # work runs; popped buckets are closed — later same-shape
            # queries open a fresh bucket, which only affects grouping, not
            # results.  Singletons stay put (see WorkloadBatcher.pop_bucket:
            # no batched work to overlap, and popping them would perturb the
            # steady-state batch shapes).
            bucket = batcher.pop_bucket()
            if bucket is not None:
                try:
                    self.execute_bucket(bucket, results)
                except ExecutorError as e:
                    deferred_errors.append(e)

        # ---- pass 1: adaptivity control, replica-mode execution, bucketing
        demoted: list[int] = []  # PI hits deferred to the distributed route
        for i, q in enumerate(queries):
            executed, was_demoted = self.stream_control_step(
                q, batcher, i, overlap=overlap
            )
            if executed is not None:
                results[i] = executed
            elif was_demoted:
                demoted.append(i)

        # the adaptivity control pass is complete for the whole workload;
        # now surface any failure an overlapped bucket hit (no results or
        # report entries are recorded, matching the sequential error path)
        if deferred_errors:
            raise deferred_errors[0]

        # ---- pass 2: one dispatch per remaining shape bucket
        for bucket in batcher.buckets():
            self.execute_bucket(bucket, results)

        # route-tag the demoted PI hits (each bucket member carries its own
        # QueryStats instance, so the tag never leaks to healthy queries)
        for i in demoted:
            assert results[i] is not None
            results[i][1].route = f"{self.substrate.name}-degraded"

        # ---- workload report, in original query order
        out: list[tuple[Relation, QueryStats]] = []
        for item in results:
            assert item is not None
            rel, qstats, dt = item
            # demotions counted once by route suffix — covers PI hits tagged
            # above and main-index chains demoted inside the Executor
            if qstats.route.endswith("-degraded"):
                self.report.n_degraded += 1
            if qstats.mode == "parallel-replica":
                self.report.n_parallel_replica += 1
            elif qstats.mode == "parallel":
                self.report.n_parallel += 1
            else:
                self.report.n_distributed += 1
            self.report.n_queries += 1
            self.report.comm_cells += qstats.comm_cells
            self.report.history.append((qstats.mode, qstats.comm_cells, dt))
            out.append((rel, qstats))
        self.report.wall_time_s += time.perf_counter() - t_all
        return out

    def stream_control_step(self, q: Query, batcher: WorkloadBatcher,
                            tag, overlap=None):
        """One admitted request through the ``query_batch`` control pass —
        the unit an online serving loop repeats per dequeued request, so a
        served stream and an offline ``query_batch`` of the same query
        sequence drive one state machine by construction.

        In order: transform, pattern-index match (a healthy hit executes
        inline over the replica index and is returned), otherwise plan and
        file the query into ``batcher`` under ``tag``; finally the shared
        post-query adaptivity hook (heat-map insert -> IRD -> rebalancing,
        suspended while degraded or ``adaptivity_paused``).

        Returns ``(executed, demoted)``: ``executed`` is the
        ``(relation, stats, seconds)`` triple when the query ran inline
        (PI hit), else None once the query joined its shape bucket;
        ``demoted`` flags a PI hit deferred to the distributed route because
        the mesh is degraded (DESIGN §9) — the caller route-tags its stats
        after the bucket executes."""
        tree = (
            build_redistribution_tree(q, self.stats, self.heuristic)
            if self.adaptive else None
        )
        matches = self.pattern_index.match(tree) if self.adaptive else None
        executed = None
        demoted = False
        if matches is not None and not self.health.degraded:
            t0 = time.perf_counter()
            rel, qstats = self.parallel_exec.execute(
                tree, matches, self.capacity
            )
            executed = (rel, qstats, time.perf_counter() - t0)
        else:
            # degraded demotion (DESIGN §9): the PI hit joins the shape
            # buckets like any distributed query — it only reads the
            # immutable main index
            demoted = matches is not None
            plan = self.planner.plan(q)
            batcher.add(tag, q, plan.ordering, plan.join_vars,
                        max(self.capacity, plan.capacity_hint()))
        if self.adaptive:
            self._post_query_adaptivity(tree, overlap=overlap)
        return executed, demoted

    def record_served(self, qstats: QueryStats, dt: float) -> None:
        """Fold one answered request into the workload report — the serving
        front-end's per-completion accounting, the same counters
        ``query_batch`` fills in for an offline workload."""
        if qstats.route.endswith("-degraded"):
            self.report.n_degraded += 1
        if qstats.mode == "parallel-replica":
            self.report.n_parallel_replica += 1
        elif qstats.mode == "parallel":
            self.report.n_parallel += 1
        else:
            self.report.n_distributed += 1
        self.report.n_queries += 1
        self.report.comm_cells += qstats.comm_cells
        self.report.wall_time_s += dt
        self.report.history.append((qstats.mode, qstats.comm_cells, dt))

    def execute_bucket(self, bucket, results) -> None:
        """Evaluate one shape bucket and fill its members' result slots
        (``results[tag] = (relation, stats, seconds)`` — any indexable
        container keyed by the tags the bucket was filed under)."""
        t0 = time.perf_counter()
        if len(bucket) == 1:
            rels_stats = [self._run_sequential(bucket, 0)]
        else:
            try:
                rels, stats_l = self.executor.execute_batch(
                    bucket.plan, bucket.stacked_consts()
                )
                self.report.n_batch_dispatches += 1
                rels_stats = list(zip(rels, stats_l))
            except ExecutorError:
                # overflow pathologies: per-query sequential fallback (only
                # ExecutorError; any other failure propagates)
                rels_stats = [
                    self._run_sequential(bucket, j)
                    for j in range(len(bucket))
                ]
        dt = (time.perf_counter() - t0) / max(len(bucket), 1)
        for tag, (rel, qstats) in zip(bucket.tags, rels_stats):
            results[tag] = (rel, qstats, dt)

    def _run_sequential(self, bucket, j: int) -> tuple[Relation, QueryStats]:
        """Sequential-executor fallback for one bucket member."""
        rel, qstats = self.executor.execute(
            bucket.queries[j], bucket.orderings[j], bucket.join_vars[j],
            capacity=max(self.capacity, bucket.capacities[j]),
        )
        return rel, qstats

    # ------------------------------------------------------------- adaptivity
    def observe(self, q: Query) -> None:
        """Feed one query through the adaptivity state machine *without*
        executing it — the replay path of the paper's §3.1 recovery story.

        Performs exactly the adaptivity side effects of :meth:`query` in the
        same order: the pattern-index containment check (whose LRU touch
        ticks the PI clock on a hit, just like a live query), then the
        shared post-query hook (heat-map insert -> IRD -> rebalancing).  A
        replayed workload therefore reproduces heat-map state, PI
        fingerprints (structure, storage ids, LRU timestamps), placement
        and replica footprints bit-identically."""
        if not self.adaptive:
            return
        tree = build_redistribution_tree(q, self.stats, self.heuristic)
        self.pattern_index.match(tree)  # LRU touch, as in query()
        self._post_query_adaptivity(tree)

    def _post_query_adaptivity(self, tree, overlap=None) -> None:
        """The single post-query adaptivity hook: heat-map insert, then IRD,
        then hot-key rebalancing.  ``query``, ``query_batch`` and the
        recovery replay all come through here — one code path, one state
        machine.  While the mesh is degraded the monitor keeps counting but
        redistribution and rebalancing are suspended: both would place
        replica rows onto the failed shard (DESIGN §9); they resume — and
        catch up from the accumulated heat-map counts — once the shard
        recovers."""
        self.heatmap.insert(tree)
        if self.health.degraded or self.adaptivity_paused:
            return
        self._maybe_redistribute(overlap=overlap)
        self._maybe_rebalance(overlap=overlap)

    def _maybe_redistribute(self, overlap=None) -> None:
        """Trigger IRD for newly hot patterns.

        ``overlap``, when given, is a zero-argument callable run *between*
        enqueueing a redistribution and its barrier: the IRD device work is
        in flight while it executes (``query_batch`` passes a callback that
        evaluates the next ready shape bucket).  The barrier
        (``PendingRedistribution.finalize``) always precedes the pattern-
        index publication, so the adaptivity state machine is sequential-
        equivalent whether or not anything was overlapped."""
        for hot in self.heatmap.hot_patterns(self.threshold):
            key = tuple(sorted(map(tuple, hot.edge_paths)))
            if key in self._no_redistribute:
                continue
            if self.pattern_index.contains(hot.rtree):
                continue  # already redistributed (peek: no LRU touch)
            pending = self.ird.redistribute_deferred(hot)
            try:
                if overlap is not None:
                    overlap()  # IRD device work overlaps this evaluation
            finally:
                # the dispatched redistribution is completed and published
                # even if the overlapped bucket raised (ExecutorError on a
                # pathological member): its replica modules are already
                # registered in the ReplicaIndex, and skipping the publish
                # would orphan them — unevictable, silently inflating the
                # budget accounting forever
                storage, ird_stats = pending.finalize()  # barrier first
                self.pattern_index.insert(hot.rtree, storage)
                self.report.n_redistributions += 1
                self.report.ird_comm_cells += ird_stats.comm_cells
                self.report.ird_triples += ird_stats.triples_indexed
                self._enforce_budget()
                # pattern too large for the budget even alone: don't thrash
                if (
                    self.budget is not None
                    and not self.pattern_index.contains(hot.rtree)
                ):
                    self._no_redistribute.add(key)

    def _maybe_rebalance(self, overlap=None) -> None:
        """Detect hot-key skew and schedule directory-placement splits.

        Trigger: the loaded shard holds more than ``skew_threshold`` times
        the mean shard load (one host fetch of ``store.counts`` per query,
        as the reference's).  Candidates come from the bootstrap top-degree
        pool, filtered to unsplit subjects living on the hot shard whose
        star is large enough to matter (>= half the mean load), and scored
        by star size weighted with the heat map's vertex frequency — a hub
        that the workload actually queries outranks an idle one.

        The main-store move runs through ``IRD.rebalance_deferred``: like a
        redistribution it is enqueued, ``overlap`` (the query_batch bucket
        callback) runs while it is in flight, and the rebuilt store is
        published to every component only after the barrier.  In-flight
        queries stay correct throughout: probe values always include the
        base owner in their destination set, so a split registered before
        the move lands only adds probe replicas."""
        plc = self.placement
        if not plc.supports_split or self._split_candidates is None:
            return
        counts = self.substrate.fetch_global(self.store.counts).astype(
            np.int64)
        mean = float(counts.mean())
        if mean <= 0.0 or float(counts.max()) <= self.skew_threshold * mean:
            return
        hot_shard = int(counts.argmax())
        subs, degs = self._split_candidates
        on_hot = plc.owner_np(subs) == hot_shard
        big = degs >= 0.5 * mean
        vf = self.heatmap.vertex_frequencies()
        scored = sorted(
            (
                (int(s), int(dg) * (1 + vf[int(s)]))
                for s, dg in zip(subs[on_hot & big], degs[on_hot & big])
                if int(s) not in plc.entries
            ),
            key=lambda t: -t[1],
        )
        picks = [s for s, _ in scored[:4]]
        if not picks or not plc.add_splits(picks):
            return
        pending = self.ird.rebalance_deferred(plc)
        try:
            if overlap is not None:
                overlap()  # the rebalance's device work overlaps this
        finally:
            new_store, moved = pending.finalize()  # barrier first
            self._publish_store(new_store)
            self.report.n_rebalances += 1
            self.report.rebalance_comm_cells += moved

    def _publish_store(self, store) -> None:
        """Swap the main store into every component that holds a reference
        (host-side pointer swaps; device work already fenced)."""
        self.store = store
        self.executor.store = store
        self.parallel_exec.main = store
        self.ird.main = store

    def _enforce_budget(self) -> None:
        if self.budget is None:
            return
        guard = 0
        while self.replicas.max_per_worker() > self.budget and guard < 64:
            sids = self.pattern_index.evict_lru_root()
            if sids is None:  # nothing evictable remains
                break
            for sid in sids:
                self.replicas.drop(sid)
            self.report.n_evictions += 1
            guard += 1

    # ------------------------------------------------------------- inspection
    def replication_ratio(self) -> float:
        """Replicated triples as a fraction of the original data."""
        total = int(self.substrate.fetch_global(self.store.counts).astype(
            np.int64).sum())
        rep = int(self.replicas.per_worker_triples().sum())
        return rep / max(total, 1)

    def load_balance(self) -> dict:
        main = self.substrate.fetch_global(self.store.counts).astype(np.int64)
        rep = self.replicas.per_worker_triples()
        tot = main + rep
        return {
            "max": int(tot.max()),
            "min": int(tot.min()),
            "mean": float(tot.mean()),
            "std": float(tot.std()),
            "replication_ratio": self.replication_ratio(),
        }
