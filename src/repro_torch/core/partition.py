"""Initial data partitioning (paper §3.1, "Data Partitioner"; Table 2).

PyTorch port of ``repro.core.partition``.  AdHash hash-partitions triples
on the subject: triple t goes to worker ``H(t.subject) mod W`` under the
default placement policy (``repro_torch.core.placement``).  The two
alternatives the paper evaluates in Table 2 -- hashing on objects and
random placement -- and a min-cut-style heavy baseline (``mincut_lite``,
the startup-cost benchmark's stand-in for METIS-class partitioners, paper
Table 9) are here too.  They are the startup baselines, host numpy as in
the reference, and give its results bit for bit (the same numpy calls in
the same order; ``partition_random`` and ``mincut_lite`` draw from
``np.random.default_rng(seed)``).

The paper's footnote uses ``subject mod W``; the mixed hash (splitmix64,
``placement.splitmix64_np``) keeps the same locality property while being
robust to structured id assignment.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .placement import splitmix64_np

__all__ = [
    "BalanceReport",
    "hash_ids",
    "partition_by_subject",
    "partition_by_object",
    "partition_random",
    "partition_balance",
    "mincut_lite",
    "edge_cut",
]


def hash_ids(ids: np.ndarray, mix: bool = True) -> np.ndarray:
    """Vectorized 64-bit integer mix (splitmix64 finalizer), non-negative;
    ``mix=False`` is the paper's plain ``subject mod W`` id."""
    if not mix:
        return np.asarray(ids, dtype=np.int64)
    return splitmix64_np(ids)


def partition_by_subject(triples: np.ndarray, w: int, mix: bool = True
                         ) -> np.ndarray:
    """Worker id per triple: H(subject) mod W (the AdHash default policy)."""
    return (hash_ids(triples[:, 0], mix) % w).astype(np.int32)


def partition_by_object(triples: np.ndarray, w: int, mix: bool = True
                        ) -> np.ndarray:
    return (hash_ids(triples[:, 2], mix) % w).astype(np.int32)


def partition_random(triples: np.ndarray, w: int, seed: int = 0
                     ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, w, size=len(triples), dtype=np.int32)


@dataclass
class BalanceReport:
    max: int
    min: int
    mean: float
    std: float

    def as_row(self) -> tuple[int, int, float, float]:
        return (self.max, self.min, self.mean, self.std)


def partition_balance(assign: np.ndarray, w: int) -> BalanceReport:
    """Triple-distribution statistics as in paper Table 2."""
    counts = np.bincount(assign, minlength=w)
    return BalanceReport(
        max=int(counts.max()),
        min=int(counts.min()),
        mean=float(counts.mean()),
        std=float(counts.std()),
    )


def mincut_lite(
    triples: np.ndarray, w: int, n_ids: int | None = None, passes: int = 8,
    seed: int = 0,
) -> np.ndarray:
    """A deliberately heavyweight min-cut-style vertex partitioner.

    Label propagation with balanced refinement over the entity graph, the
    stand-in for METIS in the startup-cost comparison (paper Table 9):
    O(passes * E) with real constant factors, which is the point of the
    benchmark.  Returns a worker id per *triple* (triples follow their
    subject's vertex label, the H-RDF-3X convention)."""
    triples = np.asarray(triples)
    if n_ids is None:
        n_ids = int(triples[:, [0, 2]].max()) + 1
    rng = np.random.default_rng(seed)
    label = rng.integers(0, w, size=n_ids, dtype=np.int32)
    src = triples[:, 0].astype(np.int64)
    dst = triples[:, 2].astype(np.int64)
    cap = int(np.ceil(n_ids / w * 1.10)) + 1  # 10% imbalance tolerance

    for _ in range(passes):
        # histogram of neighbor labels per vertex (E x W scatter)
        hist = np.zeros((n_ids, w), dtype=np.int32)
        np.add.at(hist, (src, label[dst]), 1)
        np.add.at(hist, (dst, label[src]), 1)
        best = hist.argmax(axis=1).astype(np.int32)
        gain = hist[np.arange(n_ids), best] - hist[np.arange(n_ids), label]
        order = np.argsort(-gain)  # move best-gain vertices first
        sizes = np.bincount(label, minlength=w)
        moved = 0
        for v in order:
            if gain[v] <= 0:
                break
            b = best[v]
            if b != label[v] and sizes[b] < cap:
                sizes[label[v]] -= 1
                sizes[b] += 1
                label[v] = b
                moved += 1
        if moved == 0:
            break
    return label[triples[:, 0]].astype(np.int32)


def edge_cut(triples: np.ndarray, vertex_label: np.ndarray) -> float:
    """Fraction of edges whose endpoints live on different workers."""
    cut = vertex_label[triples[:, 0]] != vertex_label[triples[:, 2]]
    return float(cut.mean()) if len(triples) else 0.0
