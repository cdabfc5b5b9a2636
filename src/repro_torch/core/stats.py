"""Global predicate statistics (paper §3.3) + Chauvenet outlier filtering (§5.1).

Storage is linear in the number of unique predicates.  For each predicate p:

  |p|     cardinality (triples with predicate p)
  |p.s|   unique subjects appearing with p
  |p.o|   unique objects appearing with p
  pS      subject score: avg (in+out) degree of subjects s with (s, p, ?) in D
  pO      object  score: avg (in+out) degree of objects  o with (?, p, o) in D
  Pps     |p| / |p.s|  (triples with p per unique subject)
  Ppo     |p| / |p.o|  (triples with p per unique object)

Statistics are "collected in a distributed manner during bootstrapping": every
quantity below is a sum/bincount over triples, so each worker computes it on
its shard and the master aggregates (associative reductions).  We expose the
single-shot computation plus `merge` for the distributed path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["PredicateStats", "GlobalStats", "chauvenet_mask", "compute_stats"]


@dataclass
class PredicateStats:
    card: int  # |p|
    n_subj: int  # |p.s|
    n_obj: int  # |p.o|
    subj_score: float  # pS (avg degree of subjects of p)
    obj_score: float  # pO (avg degree of objects of p)

    @property
    def pps(self) -> float:  # predicates-per-subject
        return self.card / max(self.n_subj, 1)

    @property
    def ppo(self) -> float:  # predicates-per-object
        return self.card / max(self.n_obj, 1)


def chauvenet_mask(values: np.ndarray) -> np.ndarray:
    """Chauvenet's criterion (paper §5.1): True = outlier.

    A sample x is rejected when the expected number of samples at least as
    extreme, N * P(|X - mu| >= |x - mu|), is below 1/2 under a normal model.
    """
    x = np.asarray(values, dtype=np.float64)
    n = x.size
    if n < 3:
        return np.zeros(n, dtype=bool)
    mu = x.mean()
    sd = x.std()
    if sd == 0.0:
        return np.zeros(n, dtype=bool)
    z = np.abs(x - mu) / sd
    # two-sided tail probability
    tail = np.array([math.erfc(zi / math.sqrt(2.0)) for zi in z])
    return n * tail < 0.5


@dataclass
class GlobalStats:
    """Master-side aggregated statistics (read-only after bootstrap)."""

    per_pred: dict[int, PredicateStats] = field(default_factory=dict)
    n_triples: int = 0
    # degree of every vertex id (in + out); used for scores and tests
    _degree: np.ndarray | None = None

    # ----------------------------------------------------------- accessors
    def predicates(self) -> list[int]:
        return sorted(self.per_pred)

    def get(self, p: int) -> PredicateStats | None:
        return self.per_pred.get(p)

    def card(self, p: int) -> int:
        st = self.per_pred.get(p)
        return st.card if st else 0

    # Scores with Chauvenet outlier rejection applied lazily (paper §5.1):
    # outlier predicates get score -inf so they are never picked as cores.
    def filtered_scores(self) -> dict[int, tuple[float, float]]:
        preds = self.predicates()
        if not preds:
            return {}
        ps = np.array([self.per_pred[p].subj_score for p in preds])
        po = np.array([self.per_pred[p].obj_score for p in preds])
        out = chauvenet_mask(ps) | chauvenet_mask(po)
        res: dict[int, tuple[float, float]] = {}
        for i, p in enumerate(preds):
            if out[i]:
                res[p] = (-math.inf, -math.inf)
            else:
                res[p] = (float(ps[i]), float(po[i]))
        return res


def _degrees(triples: np.ndarray, n_ids: int) -> np.ndarray:
    """in+out degree per vertex id over the whole graph."""
    deg = np.zeros(n_ids, dtype=np.int64)
    np.add.at(deg, triples[:, 0], 1)  # out-degree
    np.add.at(deg, triples[:, 2], 1)  # in-degree
    return deg


def compute_stats(triples: np.ndarray, n_ids: int | None = None) -> GlobalStats:
    """Compute §3.3 statistics for an (N, 3) int triple array."""
    triples = np.asarray(triples)
    if triples.size == 0:
        return GlobalStats()
    if n_ids is None:
        n_ids = int(triples.max()) + 1
    deg = _degrees(triples, n_ids)

    gs = GlobalStats(n_triples=len(triples))
    gs._degree = deg
    for p in np.unique(triples[:, 1]):
        rows = triples[triples[:, 1] == p]
        subs = np.unique(rows[:, 0])
        objs = np.unique(rows[:, 2])
        gs.per_pred[int(p)] = PredicateStats(
            card=int(len(rows)),
            n_subj=int(len(subs)),
            n_obj=int(len(objs)),
            subj_score=float(deg[subs].mean()),
            obj_score=float(deg[objs].mean()),
        )
    return gs


def merge_stats(parts: list[GlobalStats]) -> GlobalStats:
    """Associative merge used by the distributed bootstrap path.

    Degree arrays add; per-predicate counts add; scores are re-derived from the
    merged degree arrays by the caller when exact values are needed.  For the
    purposes of planning, the weighted average of scores is an adequate merge
    (the paper aggregates at the master; we keep the same contract).
    """
    out = GlobalStats()
    for g in parts:
        out.n_triples += g.n_triples
        if g._degree is not None:
            if out._degree is None:
                out._degree = g._degree.copy()
            else:
                n = max(len(out._degree), len(g._degree))
                a = np.zeros(n, dtype=np.int64)
                a[: len(out._degree)] += out._degree
                a[: len(g._degree)] += g._degree
                out._degree = a
        for p, st in g.per_pred.items():
            cur = out.per_pred.get(p)
            if cur is None:
                out.per_pred[p] = PredicateStats(
                    st.card, st.n_subj, st.n_obj, st.subj_score, st.obj_score
                )
            else:
                tot = cur.card + st.card
                cur.subj_score = (
                    cur.subj_score * cur.card + st.subj_score * st.card
                ) / max(tot, 1)
                cur.obj_score = (
                    cur.obj_score * cur.card + st.obj_score * st.card
                ) / max(tot, 1)
                cur.card = tot
                # unique counts: upper bound (exact dedup needs the id sets;
                # the planner only needs upper-bound cardinalities, §4.3)
                cur.n_subj = min(tot, cur.n_subj + st.n_subj)
                cur.n_obj = min(tot, cur.n_obj + st.n_obj)
    return out
