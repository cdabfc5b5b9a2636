"""Query-pattern transformation (paper §5.1, §5.2).

* Vertex scores (Definition 1) from the Chauvenet-filtered predicate scores.
* Core-vertex selection (Definition 2): highest-score vertex.
* Algorithm 2: transform a query graph into a *redistribution tree* rooted at
  the core — a modified BFS that (i) spans all *edges* (vertices may be
  duplicated to break cycles) and (ii) explores high-score vertices first via
  a priority queue ordered by (vertex score, predicate label).

Alternative heuristics evaluated in paper Fig. 16 are provided:
``high_low`` (default), ``low_high`` and ``qdegree``.

PyTorch port of ``repro.core.transform``: pure Python, copied as is (the
iteration orders decide the pattern index's and heat map's state, which
the port holds equal to the reference's).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Literal

from .query import O, Query, S, Term, TriplePattern, Var
from .stats import GlobalStats

__all__ = [
    "TreeNode",
    "TreeEdge",
    "RTree",
    "vertex_scores",
    "select_core",
    "build_redistribution_tree",
]

Heuristic = Literal["high_low", "low_high", "qdegree"]


@dataclass
class TreeNode:
    term: Term
    uid: int
    children: list["TreeEdge"] = field(default_factory=list)


@dataclass
class TreeEdge:
    pred: Term
    child: TreeNode
    # True  -> original pattern is (parent, pred, child)  [parent is subject]
    # False -> original pattern is (child, pred, parent)  [child  is subject]
    parent_is_subject: bool
    pattern_idx: int


@dataclass
class RTree:
    """Redistribution tree: root = core vertex; spans every query edge once."""

    root: TreeNode
    query: Query

    # ------------------------------------------------------------- traversal
    def iter_edges(self) -> list[tuple[TreeNode, TreeEdge, int]]:
        """(parent, edge, depth) in DFS pre-order — the IRD walk order (§5.3)."""
        out: list[tuple[TreeNode, TreeEdge, int]] = []

        def rec(node: TreeNode, depth: int) -> None:
            for e in node.children:
                out.append((node, e, depth))
                rec(e.child, depth + 1)

        rec(self.root, 0)
        return out

    def paths(self) -> list[list[tuple[TreeNode, TreeEdge]]]:
        """Root-to-leaf paths (IRD redistributes along paths, Algorithm 3)."""
        out: list[list[tuple[TreeNode, TreeEdge]]] = []

        def rec(node: TreeNode, prefix: list[tuple[TreeNode, TreeEdge]]) -> None:
            if not node.children:
                if prefix:
                    out.append(prefix)
                return
            for e in node.children:
                rec(e.child, prefix + [(node, e)])

        rec(self.root, [])
        return out

    def n_edges(self) -> int:
        return len(self.iter_edges())


# --------------------------------------------------------------------- scores
def vertex_scores(
    query: Query, stats: GlobalStats, heuristic: Heuristic = "high_low"
) -> dict[Term, float]:
    """Definition 1: score(v) = max over incident edges of pS (outgoing edges)
    or pO (incoming edges), after Chauvenet outlier rejection.

    ``qdegree``: score = out-degree of the vertex in the *query* graph
    (paper §6.4.3) — uses no data statistics.
    """
    scores: dict[Term, float] = {}
    if heuristic == "qdegree":
        for q in query.patterns:
            scores[q.s] = scores.get(q.s, 0.0) + 1.0
            scores.setdefault(q.o, 0.0)
        return scores

    filt = stats.filtered_scores()
    if filt:
        finite = [v for pair in filt.values() for v in pair if math.isfinite(v)]
        default = float(sum(finite) / len(finite)) if finite else 0.0
    else:
        default = 0.0

    def pred_scores(p: Term) -> tuple[float, float]:
        if isinstance(p, Var):  # unbounded predicate: neutral score
            return (default, default)
        return filt.get(p.id, (default, default))

    for q in query.patterns:
        ps, po = pred_scores(q.p)
        scores[q.s] = max(scores.get(q.s, -math.inf), ps)
        scores[q.o] = max(scores.get(q.o, -math.inf), po)
    return scores


def select_core(
    query: Query, stats: GlobalStats, heuristic: Heuristic = "high_low"
) -> Term:
    """Definition 2 (core vertex).  ``low_high`` picks the minimum instead.

    Vertices whose every incident predicate was Chauvenet-rejected carry
    score -inf; they are never core candidates (paper §5.1: outlier hubs
    such as rdf:type objects cause imbalance) — under either heuristic.
    """
    scores = vertex_scores(query, stats, heuristic)
    # Prefer variables: heat-map templates variable-ize constants anyway (§5.4)
    pool = [t for t in scores if isinstance(t, Var)] or list(scores)
    finite = [t for t in pool if math.isfinite(scores[t])]
    pool = finite or pool
    key = (lambda t: (scores[t], _stable(t)))
    if heuristic == "low_high":
        return min(pool, key=key)
    return max(pool, key=key)


def _stable(t: Term) -> str:
    return getattr(t, "name", None) or str(getattr(t, "id", ""))


# ---------------------------------------------------------------- Algorithm 2
def build_redistribution_tree(
    query: Query,
    stats: GlobalStats,
    heuristic: Heuristic = "high_low",
    core: Term | None = None,
) -> RTree:
    """Algorithm 2 — spans all query edges; duplicates vertices to break cycles.

    Differences from textbook BFS (as in the paper): spans *edges* not
    vertices; exploration order driven by a priority queue on (vertex score,
    predicate); cycle-closing edges attach a *duplicate* of the pending vertex.
    """
    scores = vertex_scores(query, stats, heuristic)
    if core is None:
        core = select_core(query, stats, heuristic)
    sign = -1.0 if heuristic != "low_high" else 1.0  # max-heap by default

    # adjacency: vertex -> list of (nbr, pred, parent_is_subject, pattern_idx)
    adj: dict[Term, list[tuple[Term, Term, bool, int]]] = {}
    for i, q in enumerate(query.patterns):
        adj.setdefault(q.s, []).append((q.o, q.p, True, i))
        adj.setdefault(q.o, []).append((q.s, q.p, False, i))

    uid_gen = itertools.count()
    root = TreeNode(core, next(uid_gen))
    node_of: dict[Term, TreeNode] = {core: root}
    visited: set[Term] = {core}
    pending: set[Term] = set()
    used_edges: set[int] = set()
    tie = itertools.count()

    heap: list[tuple[float, str, int, Term, Term, Term, bool, int]] = []

    def push(parent: Term, child: Term, pred: Term, pis: bool, idx: int) -> None:
        heapq.heappush(
            heap,
            (
                sign * scores.get(child, 0.0),
                _stable(pred),
                next(tie),
                parent,
                child,
                pred,
                pis,
                idx,
            ),
        )

    def add_edge(parent: Term, child: Term, pred: Term, pis: bool, idx: int,
                 duplicate: bool) -> TreeNode:
        pnode = node_of[parent]
        cnode = TreeNode(child, next(uid_gen))
        pnode.children.append(TreeEdge(pred, cnode, pis, idx))
        if not duplicate:
            node_of[child] = cnode
        return cnode

    # seed with core-incident edges (Algorithm 2 lines 5-9)
    for nbr, pred, pis, idx in adj.get(core, []):
        if idx in used_edges:
            continue
        used_edges.add(idx)
        if nbr in visited or nbr in pending or nbr == core:
            add_edge(core, nbr, pred, pis, idx, duplicate=True)
        else:
            add_edge(core, nbr, pred, pis, idx, duplicate=False)
            pending.add(nbr)
            push(core, nbr, pred, pis, idx)

    # main loop (lines 10-20)
    while heap:
        _, _, _, parent, vertex, pred, pis, idx = heapq.heappop(heap)
        if vertex in visited:
            continue
        visited.add(vertex)
        pending.discard(vertex)
        for nbr, npred, npis, nidx in adj.get(vertex, []):
            if nidx in used_edges:
                continue
            used_edges.add(nidx)
            if nbr in visited or nbr in pending:
                # cycle-closing edge -> duplicate the endpoint (break cycle)
                add_edge(vertex, nbr, npred, npis, nidx, duplicate=True)
            else:
                add_edge(vertex, nbr, npred, npis, nidx, duplicate=False)
                pending.add(nbr)
                push(vertex, nbr, npred, npis, nidx)

    tree = RTree(root=root, query=query)
    assert tree.n_edges() == len(query.patterns), (
        "redistribution tree must span every query edge exactly once "
        f"({tree.n_edges()} != {len(query.patterns)}); query={query.patterns}"
    )
    return tree
