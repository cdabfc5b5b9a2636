"""The paper's adaptivity loop re-instantiated for LM sharding (DESIGN §2b).

The port's own copy of ``repro.core.adaptive`` (host numpy, the same
semantics): ``repro_torch.launch.serve.serve_loop`` drives it.

AdHash's pipeline is: *cheap hash partitioning -> heat map of accesses ->
hot-set detection (frequency threshold) -> incremental replication of the
hot slice within a budget -> LRU eviction*.  This module applies exactly that
control loop to the two sparse-access structures of an LM framework:

  * vocab-sharded embedding / LM-head rows (hot tokens — Zipf-distributed,
    like RDF predicates), consumed by ``repro.models.embedding``;
  * MoE expert placement (hot experts), consumed by ``repro.models.moe``.

The controller is host-side (the "master"); the data plane consumes its
*plan* as static arrays baked into the next compiled step (the analogue of
IRD rebuilding replica indexes).  Replanning is cheap and incremental; it is
the LM equivalent of the paper's pay-as-you-go adaptation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["AccessHeatMap", "ReplicationPlan", "AdaptiveShardingController"]


@dataclass
class AccessHeatMap:
    """Degenerate (depth-1) heat map: access counts per id, with exponential
    decay so the hot set tracks workload *changes* (the paper's heat map is
    timestamped for the same reason)."""

    n_ids: int
    decay: float = 0.9
    counts: np.ndarray = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.counts is None:
            self.counts = np.zeros(self.n_ids, dtype=np.float64)

    def update(self, batch_counts: np.ndarray) -> None:
        self.counts = self.counts * self.decay + np.asarray(
            batch_counts, dtype=np.float64
        )

    def hot_ids(self, k: int, threshold: float = 0.0) -> np.ndarray:
        """Top-k ids above threshold, ascending id order (stable plans)."""
        k = min(k, self.n_ids)
        if k <= 0:
            return np.zeros(0, dtype=np.int64)
        idx = np.argpartition(-self.counts, k - 1)[:k]
        idx = idx[self.counts[idx] > threshold]
        return np.sort(idx)


@dataclass(frozen=True)
class ReplicationPlan:
    """The LM 'pattern index': which ids are replicated everywhere.

    hot_ids is sorted; coverage is the (estimated) fraction of accesses the
    hot set absorbs — the knob that sizes the cold-path exchange capacity.
    """

    hot_ids: tuple[int, ...]
    coverage: float
    version: int

    @property
    def n_hot(self) -> int:
        return len(self.hot_ids)


class AdaptiveShardingController:
    """Redistribution controller for LM lookups (paper §3.1, adapted).

    budget      maximum replicated ids (the replication budget)
    threshold   minimum decayed access count to qualify as hot (frequency
                threshold of §5.4)
    """

    def __init__(
        self,
        n_ids: int,
        budget: int,
        threshold: float = 1.0,
        decay: float = 0.9,
    ):
        self.heat = AccessHeatMap(n_ids, decay)
        self.budget = int(budget)
        self.threshold = float(threshold)
        self._version = 0
        self.plan = ReplicationPlan((), 0.0, 0)

    def observe(self, ids: np.ndarray) -> None:
        """Account one batch of accessed ids (token ids / expert choices)."""
        counts = np.bincount(
            np.asarray(ids).reshape(-1), minlength=self.heat.n_ids
        )
        self.heat.update(counts)

    def replan(self) -> ReplicationPlan:
        """Detect the hot set and emit a new replication plan (IRD trigger).

        LRU eviction is implicit: decayed counts drop ids out of the top-k,
        which removes them from the next plan — bounded by the budget.
        """
        hot = self.heat.hot_ids(self.budget, self.threshold)
        total = self.heat.counts.sum()
        cov = float(self.heat.counts[hot].sum() / total) if total > 0 else 0.0
        self._version += 1
        self.plan = ReplicationPlan(tuple(int(i) for i in hot), cov, self._version)
        return self.plan

    def cold_capacity(self, tokens_per_shard: int, slack: float = 1.25) -> int:
        """Static capacity for the cold-path exchange, sized from measured
        coverage with head-room (the engine's retry-on-overflow applies on
        top, exactly like the RDF executor's capacity doubling)."""
        cold_frac = max(1.0 - self.plan.coverage, 0.05)
        cap = int(np.ceil(tokens_per_shard * cold_frac * slack))
        return max(8, min(cap, tokens_per_shard))
