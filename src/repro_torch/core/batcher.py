"""Workload batching: shape buckets for multi-query execution.

PyTorch port of ``repro.core.batcher`` (host-side Python and numpy, copied
as is apart from this docstring).

AdHash's throughput claim (paper §6) is about workloads, not single-query
latency.  The power-of-two capacity classes make the DSJ stage *shapes*
shared across a warmed workload; this module exploits that by grouping
queries whose entire execution is structurally identical into *shape
buckets*, so one batched pipeline (the ``*_batch`` stages in dsj.py)
evaluates the whole bucket on a leading batch axis, one kernel launch per
stage for the bucket.

A bucket is keyed by the full static execution descriptor — everything the
sequential executor derives on the host before it launches anything:

  * the first pattern's :class:`PatternSpec` and kept-column layout,
  * per join step: the case kind (local / hash-DSJ / broadcast-DSJ), the
    :class:`PatternSpec`, the join columns c1/c2, the shared-variable
    verification checks and appended columns (join structure),
  * the quantized capacity class.

Queries in the same bucket therefore differ only in their pattern constants,
which stack into a (B, n_patterns, 3) int32 array.  Batch sizes are padded
to power-of-two classes (``quantize_batch``), as in the reference, so a
bucket's launch shapes take few distinct values.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .backend import quantize_capacity
from .dsj import PatternSpec
from .executor import step_descriptor
from .query import Query, Var

__all__ = ["StepPlan", "BatchPlan", "Bucket", "WorkloadBatcher",
           "quantize_batch"]


def quantize_batch(b: int) -> int:
    """Round a bucket size up to its power-of-two class (min 1).

    The batch axis is a launch shape exactly like the capacities; the
    reference quantizes it so that distinct workload sizes share compiled
    stages, and the port keeps its classes.  Padding entries replicate a
    real query and are discarded."""
    return quantize_capacity(b, floor=1)


@dataclass(frozen=True)
class StepPlan:
    """Static description of one join step (mirrors Executor._join_step)."""

    kind: str  # 'local' | 'hash' | 'bcast'
    spec: PatternSpec
    join_var: Var
    c1: int  # column of the intermediate relation carrying the join var
    c2: int  # column of the pattern carrying the join var
    checks: tuple[tuple[int, int], ...]
    append_cols: tuple[int, ...]
    out_vars: tuple[Var, ...]


@dataclass(frozen=True)
class BatchPlan:
    """Full static execution descriptor == the shape-bucket key."""

    capacity: int  # quantized capacity class
    first_spec: PatternSpec
    first_keep: tuple[int, ...]  # var-column dedup (?x p ?x patterns)
    first_vars: tuple[Var, ...]
    steps: tuple[StepPlan, ...]

    @property
    def n_patterns(self) -> int:
        return 1 + len(self.steps)

    @property
    def n_dsj(self) -> int:
        return sum(1 for s in self.steps if s.kind != "local")

    @property
    def local_chain(self) -> bool:
        """True when every step is case (i) — the whole bucket can ride the
        fused zero-collective main-index chain (DESIGN §11)."""
        return self.n_dsj == 0


@dataclass
class Bucket:
    """One shape bucket: the shared plan + the per-query dynamic parts."""

    plan: BatchPlan
    tags: list = field(default_factory=list)  # caller-chosen ids (positions)
    queries: list[Query] = field(default_factory=list)
    orderings: list[list[int]] = field(default_factory=list)  # for fallback
    join_vars: list[list[Var]] = field(default_factory=list)
    capacities: list[int] = field(default_factory=list)  # unquantized hints
    consts: list[np.ndarray] = field(default_factory=list)  # (n_pat, 3) each

    def __len__(self) -> int:
        return len(self.tags)

    def stacked_consts(self) -> np.ndarray:
        return np.stack(self.consts).astype(np.int32)


class WorkloadBatcher:
    """Groups planned queries into shape buckets for batched execution.

    The ablation flags must match the executor that will run the buckets:
    they decide the per-step case kind (paper §4.1.3), which is part of the
    bucket key."""

    def __init__(self, locality_aware: bool = True, pinned_opt: bool = True,
                 local_join_safe: bool = True):
        self.locality_aware = locality_aware
        self.pinned_opt = pinned_opt
        self.local_join_safe = local_join_safe
        self._buckets: dict[BatchPlan, Bucket] = {}

    # ------------------------------------------------------------- compile
    def compile(
        self,
        query: Query,
        ordering: list[int],
        join_vars: list[Var],
        capacity: int | None = None,
    ) -> tuple[BatchPlan, np.ndarray]:
        """Derive the static execution descriptor + the (n_pat, 3) constants.

        Mirrors ``Executor.execute``'s host-side derivation exactly: the
        descriptor determines every static argument the batched stages see,
        so bucket-mates are guaranteed to share one pipeline."""
        cap = quantize_capacity(capacity or query.capacity)
        q1 = query.patterns[ordering[0]]
        spec1 = PatternSpec.of(q1)
        keep, first_vars = q1.distinct_var_cols()
        pinned = q1.s if isinstance(q1.s, Var) else None

        rel_vars: tuple[Var, ...] = first_vars
        steps: list[StepPlan] = []
        for step, idx in enumerate(ordering[1:]):
            qj = query.patterns[idx]
            jv = join_vars[step]
            # single source of truth with Executor._join_step: the bucket
            # key is exactly what the sequential path would execute
            kind, c1, c2, checks, append_cols, out_vars = step_descriptor(
                rel_vars, qj, jv, pinned, self.locality_aware,
                self.pinned_opt, self.local_join_safe,
            )
            steps.append(StepPlan(kind, PatternSpec.of(qj), jv, c1, c2,
                                  checks, append_cols, out_vars))
            rel_vars = out_vars

        plan = BatchPlan(cap, spec1, tuple(keep), first_vars, tuple(steps))
        ordered = [query.patterns[i] for i in ordering]
        consts = np.array(
            [[t.id if not isinstance(t, Var) else -1
              for t in (q.s, q.p, q.o)] for q in ordered],
            dtype=np.int32,
        )
        return plan, consts

    # ----------------------------------------------------------- grouping
    def add(
        self,
        tag,
        query: Query,
        ordering: list[int],
        join_vars: list[Var],
        capacity: int | None = None,
    ) -> BatchPlan:
        """Compile and file one query into its shape bucket."""
        plan, consts = self.compile(query, ordering, join_vars, capacity)
        bucket = self._buckets.get(plan)
        if bucket is None:
            bucket = self._buckets[plan] = Bucket(plan)
        bucket.tags.append(tag)
        bucket.queries.append(query)
        bucket.orderings.append(list(ordering))
        bucket.join_vars.append(list(join_vars))
        bucket.capacities.append(capacity or query.capacity)
        bucket.consts.append(consts)
        return plan

    def buckets(self) -> list[Bucket]:
        return list(self._buckets.values())

    def pop_bucket(self, min_size: int = 2, force: bool = False
                   ) -> Bucket | None:
        """Remove and return the oldest bucket holding at least ``min_size``
        queries (FIFO over bucket creation), or None.

        Used by the engine's overlapped-IRD path to evaluate an
        already-decided bucket while a redistribution's device work is in
        flight.  The popped bucket is *closed*: a later query with the same
        shape opens a fresh bucket.  That can split what a strict two-pass
        run would have batched together — changing dispatch counts, never
        results (bucket members only read the immutable main index, and
        per-query stats are computed per batch lane).  Singleton buckets are
        deliberately skipped: they would execute sequentially anyway (no
        batched pipeline to overlap), and popping them splits the
        steady-state bucket grouping — the batch shapes an IRD-free rerun of
        the same workload would launch.

        ``force=True`` ignores ``min_size`` and returns the oldest bucket of
        *any* occupancy — the serving loop's age/deadline flush:
        under a live stream a unique-shape request opens a singleton bucket
        that, with ``min_size=2`` alone, would wait forever for a bucket-mate
        that may never arrive.  The serve loop force-pops when the oldest
        member nears its SLO deadline; a forced singleton simply runs on the
        sequential path."""
        for plan, bucket in self._buckets.items():
            if force or len(bucket) >= min_size:
                return self._buckets.pop(plan)
        return None

    def pop(self, plan: BatchPlan) -> Bucket | None:
        """Remove and return the specific bucket keyed by ``plan`` (the
        serving loop pops exactly the bucket that filled or whose oldest
        member's deadline is due, not merely the oldest)."""
        return self._buckets.pop(plan, None)

    def __len__(self) -> int:
        return len(self._buckets)
