"""Hierarchical workload heat map (paper §5.4).

Queries are transformed into redistribution trees (Algorithm 2), then into
*templates* — constants are replaced by variables, with the constant values
and their frequencies retained as vertex metadata.  Templates are merged into
a prefix-tree-like structure whose edges carry access counts; subtrees whose
edges all reach the frequency threshold are *hot patterns*.

Dominant constants are re-substituted into hot patterns using the Boyer-Moore
majority-vote algorithm (paper §5.4), verified against the exact counts kept
in the metadata (MJRTY needs a verification pass).

PyTorch port of ``repro.core.heatmap``: pure Python, copied as is (the
iteration orders decide the pattern index's and heat map's state, which
the port holds equal to the reference's).
"""
from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field

from .query import Const, Query, Term, TriplePattern, Var
from .transform import RTree, TreeEdge, TreeNode

__all__ = ["BoyerMoore", "EdgeKey", "HeatEdge", "HeatMap", "HotPattern"]


class BoyerMoore:
    """MJRTY streaming majority candidate + exact verification counter."""

    def __init__(self) -> None:
        self.candidate: int | None = None
        self.count = 0
        self.freq: Counter[int] = Counter()  # vertex metadata {const: freq}
        self.total = 0

    def update(self, value: int) -> None:
        self.freq[value] += 1
        self.total += 1
        if self.count == 0:
            self.candidate, self.count = value, 1
        elif value == self.candidate:
            self.count += 1
        else:
            self.count -= 1

    def majority(self) -> int | None:
        """The dominant constant, if one truly dominates (> half)."""
        if self.candidate is None:
            return None
        if self.freq[self.candidate] * 2 > self.total:
            return self.candidate
        return None


# Edge identity in the template: (predicate, orientation).
# pred is the constant id, or -1 for an unbounded (variable) predicate.
@dataclass(frozen=True)
class EdgeKey:
    pred: int
    parent_is_subject: bool


@dataclass
class HeatEdge:
    key: EdgeKey
    count: int = 0
    last_ts: int = 0
    child_meta: BoyerMoore = field(default_factory=BoyerMoore)
    child_var_seen: int = 0  # times the child vertex was a variable
    children: dict[EdgeKey, "HeatEdge"] = field(default_factory=dict)

    def n_edges(self) -> int:
        return 1 + sum(c.n_edges() for c in self.children.values())


@dataclass
class HotPattern:
    """A hot subtree extracted from the heat map, ready for IRD."""

    query: Query  # reconstructed pattern (dominant constants substituted)
    rtree: RTree  # its redistribution tree (root = core)
    edge_paths: list[tuple[EdgeKey, ...]]  # heat-map paths, for bookkeeping


class HeatMap:
    """Single anonymous root (the core); each template inserted from the top."""

    def __init__(self) -> None:
        self.children: dict[EdgeKey, HeatEdge] = {}
        self.root_meta = BoyerMoore()
        self.root_var_seen = 0
        self._clock = itertools.count(1)

    # -------------------------------------------------------------- insert
    @staticmethod
    def _edge_key(e: TreeEdge) -> EdgeKey:
        pred = e.pred.id if isinstance(e.pred, Const) else -1
        return EdgeKey(pred, e.parent_is_subject)

    def insert(self, tree: RTree) -> int:
        """Merge a query's template into the map; returns the timestamp."""
        ts = next(self._clock)
        self._meta(tree.root, self.root_meta, is_root=True)

        def rec(node: TreeNode, table: dict[EdgeKey, HeatEdge]) -> None:
            for e in node.children:
                k = self._edge_key(e)
                he = table.get(k)
                if he is None:
                    he = HeatEdge(k)
                    table[k] = he
                he.count += 1
                he.last_ts = ts
                if isinstance(e.child.term, Const):
                    he.child_meta.update(e.child.term.id)
                else:
                    he.child_var_seen += 1
                rec(e.child, he.children)

        rec(tree.root, self.children)
        return ts

    def _meta(self, node: TreeNode, bm: BoyerMoore, is_root: bool) -> None:
        if isinstance(node.term, Const):
            bm.update(node.term.id)
        elif is_root:
            self.root_var_seen += 1

    # --------------------------------------------------------- checkpointing
    # The heat map is part of the master's recoverable adaptivity state
    # (DESIGN §9): a snapshot captures every edge count, LRU timestamp and
    # Boyer-Moore verification counter so a restored map is bit-equivalent —
    # hot-pattern detection resumes exactly where the crashed master stopped.
    @staticmethod
    def _bm_state(bm: BoyerMoore) -> dict:
        return {
            "candidate": bm.candidate,
            "count": bm.count,
            "freq": sorted((int(k), int(v)) for k, v in bm.freq.items()),
            "total": bm.total,
        }

    @staticmethod
    def _bm_from(state: dict) -> BoyerMoore:
        bm = BoyerMoore()
        bm.candidate = state["candidate"]
        bm.count = state["count"]
        bm.freq = Counter(dict(
            (int(k), int(v)) for k, v in state["freq"]
        ))
        bm.total = state["total"]
        return bm

    def to_state(self) -> dict:
        """JSON-serializable snapshot of the full map (clock included)."""

        def rec(table: dict[EdgeKey, HeatEdge]) -> list[dict]:
            return [
                {
                    "pred": k.pred,
                    "pis": k.parent_is_subject,
                    "count": he.count,
                    "last_ts": he.last_ts,
                    "meta": self._bm_state(he.child_meta),
                    "var_seen": he.child_var_seen,
                    "children": rec(he.children),
                }
                for k, he in he_sorted(table)
            ]

        def he_sorted(table):
            return sorted(table.items(),
                          key=lambda kv: (kv[0].pred, kv[0].parent_is_subject))

        max_ts = [0]

        def scan(table):
            for he in table.values():
                max_ts[0] = max(max_ts[0], he.last_ts)
                scan(he.children)

        scan(self.children)
        return {
            "root_meta": self._bm_state(self.root_meta),
            "root_var_seen": self.root_var_seen,
            "clock": max_ts[0] + 1,  # only insert() ticks -> max ts is last
            "children": rec(self.children),
        }

    @classmethod
    def from_state(cls, state: dict) -> "HeatMap":
        hm = cls()
        hm.root_meta = cls._bm_from(state["root_meta"])
        hm.root_var_seen = state["root_var_seen"]
        hm._clock = itertools.count(state["clock"])

        def rec(entries: list[dict], table: dict[EdgeKey, HeatEdge]) -> None:
            for e in entries:
                k = EdgeKey(e["pred"], e["pis"])
                he = HeatEdge(
                    k, count=e["count"], last_ts=e["last_ts"],
                    child_meta=cls._bm_from(e["meta"]),
                    child_var_seen=e["var_seen"],
                )
                table[k] = he
                rec(e["children"], he.children)

        rec(state["children"], hm.children)
        return hm

    # ----------------------------------------------------- vertex frequency
    def vertex_frequencies(self) -> Counter:
        """Aggregate constant-vertex access counts across the whole map.

        Sums the Boyer-Moore verification counters of the root and of every
        edge's child metadata — i.e. how often each constant id appeared as
        a query vertex.  The engine's skew detector uses this to prioritize
        *workload-hot* hub subjects when choosing directory-placement
        splits."""
        total: Counter[int] = Counter(self.root_meta.freq)

        def rec(table: dict[EdgeKey, HeatEdge]) -> None:
            for he in table.values():
                total.update(he.child_meta.freq)
                rec(he.children)

        rec(self.children)
        return total

    # -------------------------------------------------------- hot detection
    def hot_patterns(self, threshold: int) -> list[HotPattern]:
        """Maximal root-anchored subtrees whose every edge count >= threshold.

        Constants are substituted for template variables where a value truly
        dominates (Boyer-Moore verified), as in §5.4.
        """
        out: list[HotPattern] = []
        names = (f"v{i}" for i in itertools.count())

        def dominant(bm: BoyerMoore, var_seen: int) -> int | None:
            m = bm.majority()
            if m is not None and bm.freq[m] > var_seen:
                return m
            return None

        for k, he in self.children.items():
            if he.count < threshold:
                continue
            root_const = dominant(self.root_meta, self.root_var_seen)
            root_term: Term = (
                Const(root_const) if root_const is not None else Var(next(names))
            )
            root_node = TreeNode(root_term, 0)
            patterns: list[TriplePattern] = []
            paths: list[tuple[EdgeKey, ...]] = []
            uid = itertools.count(1)

            def build(
                he_: HeatEdge,
                parent: TreeNode,
                path: tuple[EdgeKey, ...],
            ) -> None:
                d = dominant(he_.child_meta, he_.child_var_seen)
                child_term: Term = (
                    Const(d) if d is not None else Var(next(names))
                )
                child = TreeNode(child_term, next(uid))
                pred: Term = (
                    Const(he_.key.pred) if he_.key.pred >= 0 else Var(next(names))
                )
                if he_.key.parent_is_subject:
                    patterns.append(TriplePattern(parent.term, pred, child_term))
                else:
                    patterns.append(TriplePattern(child_term, pred, parent.term))
                parent.children.append(
                    TreeEdge(pred, child, he_.key.parent_is_subject,
                             len(patterns) - 1)
                )
                paths.append(path + (he_.key,))
                for ck, ce in he_.children.items():
                    if ce.count >= threshold:
                        build(ce, child, path + (he_.key,))

            build(he, root_node, ())
            q = Query(patterns, name="hot")
            out.append(HotPattern(q, RTree(root_node, q), paths))
        return out
