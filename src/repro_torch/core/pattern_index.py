"""Pattern Index + Replica Index (paper §5.5) and the parallel-mode executor.

The Pattern Index (PI) lives at the master and mirrors the heat-map
structure, but only stores *redistributed* patterns.  Each PI edge may be
specialized to a dominant constant at the child vertex; edges carry LRU
timestamps.  A query is answerable in parallel mode iff its redistribution
tree is contained in the PI starting at the root (core).

The Replica Index is the worker-side dual: one segregated *storage module*
per PI edge (its own ShardedTripleStore), never merged into the main indexes
— the four reasons of §5.5.  Edges whose subject is the core are not
replicated: their data comes straight from the main index (initial
subject-hash locality).

Eviction: LRU over root-level PI subtrees under a per-worker triple budget.

PyTorch port of ``repro.core.pattern_index``.  ``PatternIndex`` is
host-side Python, copied as is: its fingerprint (structure, storage ids,
LRU clocks) is held equal to the reference's.  The replica modules are the
port's ``ShardedTripleStore``s on the engine's device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from . import dsj
from .backend import quantize_capacity
from .executor import ExecutorError, QueryStats, _append_plan, _shared_checks
from .heatmap import EdgeKey
from .query import Const, O, S, Var
from .relalg import select_cols
from .relation import Relation
from .transform import RTree, TreeEdge, TreeNode
from .triples import ShardedTripleStore

__all__ = ["PatternIndex", "ReplicaIndex", "ParallelExecutor", "PIEdge"]

_MAX_RETRIES = 7


@dataclass
class PIEdge:
    key: EdgeKey
    child_const: int | None  # dominant-constant specialization (or generic)
    storage_id: str | None  # replica module; None -> served by main index
    last_ts: int = 0
    children: dict[tuple[EdgeKey, int | None], "PIEdge"] = field(
        default_factory=dict
    )

    def iter_edges(self):
        yield self
        for c in self.children.values():
            yield from c.iter_edges()


class PatternIndex:
    """Master-side index of redistributed patterns (forest by root spec)."""

    def __init__(self) -> None:
        # (root_const | None) -> {(EdgeKey, child_const) -> PIEdge}
        self.roots: dict[int | None, dict[tuple[EdgeKey, int | None], PIEdge]] = {}
        self._clock = itertools.count(1)

    # ---------------------------------------------------------------- insert
    @staticmethod
    def _key_of(e: TreeEdge) -> EdgeKey:
        pred = e.pred.id if isinstance(e.pred, Const) else -1
        return EdgeKey(pred, e.parent_is_subject)

    def insert(self, tree: RTree, storage_ids: dict[int, str | None]) -> None:
        """Insert a redistributed pattern; storage_ids maps pattern_idx ->
        replica module id (None when the edge is served by the main index)."""
        ts = next(self._clock)
        root_const = (
            tree.root.term.id if isinstance(tree.root.term, Const) else None
        )
        table = self.roots.setdefault(root_const, {})

        def rec(node: TreeNode, tbl: dict) -> None:
            for e in node.children:
                ck = (
                    e.child.term.id
                    if isinstance(e.child.term, Const)
                    else None
                )
                k = (self._key_of(e), ck)
                pie = tbl.get(k)
                if pie is None:
                    pie = PIEdge(k[0], ck, storage_ids.get(e.pattern_idx))
                    tbl[k] = pie
                elif storage_ids.get(e.pattern_idx) is not None:
                    pie.storage_id = storage_ids[e.pattern_idx]
                pie.last_ts = ts
                rec(e.child, pie.children)

        rec(tree.root, table)

    # ----------------------------------------------------------------- match
    def match(self, tree: RTree) -> list[tuple[TreeEdge, PIEdge]] | None:
        """Containment check (§5.5): every edge of ``tree`` must exist in the
        PI from the root down, with compatible constant specializations.
        Returns the matched (query edge, PI edge) pairs, or None."""
        root_specs: list[int | None] = [None]
        if isinstance(tree.root.term, Const):
            root_specs.insert(0, tree.root.term.id)
        for spec in root_specs:
            table = self.roots.get(spec)
            if table is None:
                continue
            out: list[tuple[TreeEdge, PIEdge]] = []
            if self._match_level(tree.root, table, out):
                ts = next(self._clock)
                for _, pie in out:
                    pie.last_ts = ts  # LRU touch
                return out
        return None

    def contains(self, tree: RTree) -> bool:
        """Non-ticking containment peek: the same check as :meth:`match`
        but without the LRU touch.  The IRD trigger uses it to ask "already
        redistributed?" — a bookkeeping probe, not a query serving from the
        replicas, so it must not refresh recency.  (It also keeps the
        query-log replay clock-exact: the trigger runs on healthy queries
        but is suspended while degraded, and a ticking probe would make the
        two histories diverge in LRU timestamps.)"""
        root_specs: list[int | None] = [None]
        if isinstance(tree.root.term, Const):
            root_specs.insert(0, tree.root.term.id)
        out: list[tuple[TreeEdge, PIEdge]] = []
        return any(
            self._match_level(tree.root, self.roots[spec], out)
            for spec in root_specs
            if spec in self.roots
        )

    def _match_level(self, node: TreeNode, tbl: dict, out: list) -> bool:
        for e in node.children:
            k = self._key_of(e)
            cands: list[tuple[EdgeKey, int | None]] = [(k, None)]
            if isinstance(e.child.term, Const):
                cands.insert(0, (k, e.child.term.id))
            hit = None
            for ck in cands:
                pie = tbl.get(ck)
                if pie is not None and self._match_level(
                    e.child, pie.children, out
                ):
                    hit = pie
                    break
            if hit is None:
                return False
            out.append((e, hit))
        return True

    # -------------------------------------------------------------- eviction
    def evict_lru_root(self) -> list[str] | None:
        """Drop the least-recently-used root-level subtree that actually
        holds replicated data; returns its storage ids, or None when nothing
        evictable remains (paper §5.5: the hierarchical modules make eviction
        cheap and local; zero-replica patterns cost nothing to keep)."""
        lru: tuple[int | None, tuple, int] | None = None
        for rspec, tbl in self.roots.items():
            for key, pie in tbl.items():
                if not any(e.storage_id for e in pie.iter_edges()):
                    continue
                ts = max(e.last_ts for e in pie.iter_edges())
                if lru is None or ts < lru[2]:
                    lru = (rspec, key, ts)
        if lru is None:
            return None
        pie = self.roots[lru[0]].pop(lru[1])
        if not self.roots[lru[0]]:
            del self.roots[lru[0]]
        return [e.storage_id for e in pie.iter_edges() if e.storage_id]

    def n_edges(self) -> int:
        return sum(
            sum(1 for _ in pie.iter_edges())
            for tbl in self.roots.values()
            for pie in tbl.values()
        )

    # ---------------------------------------------------------- comparison
    def fingerprint(self) -> tuple:
        """Canonical snapshot of the PI: structure, specializations, replica
        storage ids and LRU timestamps.  Two engines that processed the same
        workload through different execution paths (sequential vs batched)
        must produce equal fingerprints — the parity tests' definition of
        "identical pattern-index state"."""

        def rec(tbl: dict) -> tuple:
            return tuple(sorted(
                (
                    (pie.key.pred, pie.key.parent_is_subject),
                    -1 if ck is None else ck,
                    pie.storage_id or "",
                    pie.last_ts,
                    rec(pie.children),
                )
                for (_k, ck), pie in tbl.items()
            ))

        return tuple(sorted(
            (-1 if rspec is None else rspec, rec(tbl))
            for rspec, tbl in self.roots.items()
        ))

    # --------------------------------------------------------- checkpointing
    # The PI structure (edges, constant specializations, replica storage ids,
    # LRU timestamps, clock) is part of the master's recoverable adaptivity
    # state (DESIGN §9).  The replica module *contents* are checkpointed
    # separately (CheckpointManager.save_adaptivity) — this is structure only.
    def to_state(self) -> dict:
        """JSON-serializable snapshot (clock included)."""

        def rec(tbl: dict) -> list[dict]:
            return [
                {
                    "pred": pie.key.pred,
                    "pis": pie.key.parent_is_subject,
                    "child_const": ck,
                    "storage_id": pie.storage_id,
                    "last_ts": pie.last_ts,
                    "children": rec(pie.children),
                }
                for (_k, ck), pie in sorted(
                    tbl.items(),
                    key=lambda kv: (kv[0][0].pred,
                                    kv[0][0].parent_is_subject,
                                    -1 if kv[0][1] is None else kv[0][1]),
                )
            ]

        max_ts = [0]

        def scan(tbl):
            for pie in tbl.values():
                max_ts[0] = max(max_ts[0], pie.last_ts)
                scan(pie.children)

        for tbl in self.roots.values():
            scan(tbl)
        return {
            # insert() and match() both stamp last_ts with the fresh tick,
            # so the max timestamp is always the last clock value handed out
            "clock": max_ts[0] + 1,
            "roots": [
                {"root_const": rspec, "edges": rec(tbl)}
                for rspec, tbl in sorted(
                    self.roots.items(),
                    key=lambda kv: -1 if kv[0] is None else kv[0],
                )
            ],
        }

    @classmethod
    def from_state(cls, state: dict) -> "PatternIndex":
        pi = cls()
        pi._clock = itertools.count(state["clock"])

        def rec(entries: list[dict], tbl: dict) -> None:
            for e in entries:
                ck = e["child_const"]
                ck = None if ck is None else int(ck)
                pie = PIEdge(EdgeKey(e["pred"], e["pis"]), ck,
                             e["storage_id"], last_ts=e["last_ts"])
                tbl[(pie.key, ck)] = pie
                rec(e["children"], pie.children)

        for r in state["roots"]:
            rc = r["root_const"]
            rc = None if rc is None else int(rc)
            rec(r["edges"], pi.roots.setdefault(rc, {}))
        return pi


class ReplicaIndex:
    """Worker-side replica storage: one ShardedTripleStore per PI edge."""

    def __init__(self, n_workers: int, substrate=None) -> None:
        from .substrate import SingleDeviceSubstrate

        self.w = n_workers
        # gathers the per-worker counts of a mesh rank's blocks
        self.sub = substrate if substrate is not None else \
            SingleDeviceSubstrate()
        self.modules: dict[str, ShardedTripleStore] = {}
        # plain int, not itertools.count: checkpoint restore must set the
        # next id without consuming it ("rep3" handed out again over a
        # restored module of the same name would silently clobber it)
        self.next_id_n = 0

    def new_id(self) -> str:
        sid = f"rep{self.next_id_n}"
        self.next_id_n += 1
        return sid

    def put(self, sid: str, store: ShardedTripleStore) -> None:
        self.modules[sid] = store

    def get(self, sid: str) -> ShardedTripleStore:
        return self.modules[sid]

    def drop(self, sid: str) -> None:
        self.modules.pop(sid, None)

    # ------------------------------------------------------------ accounting
    def per_worker_triples(self) -> np.ndarray:
        """Replica triples per worker, summed over the modules (one host
        fetch of every module's counts; a mesh gathers every rank's
        workers, so eviction decides the same on every rank)."""
        if not self.modules:
            return np.zeros(self.w, dtype=np.int64)
        counts = torch.stack([st.counts for st in self.modules.values()])
        return self.sub.fetch_global(counts.sum(dim=0, dtype=torch.int64))

    def nbytes(self) -> int:
        """Bytes of every replica module on its device."""
        return sum(st.nbytes() for st in self.modules.values())

    def max_per_worker(self) -> int:
        t = self.per_worker_triples()
        return int(t.max()) if t.size else 0


class ParallelExecutor:
    """Parallel-mode evaluation (§3.2 "Parallel Mode", §5.5).

    Walks the query's redistribution tree in DFS order; every join is a
    local probe against either the main index (edges whose subject is the
    core) or the matched PI edge's replica module.  Zero communication: the
    stages dispatch through the substrate's *shard-local route*
    (``match_first_local`` / ``local_probe_join_local``; on one device the
    regular stages), and the host reduces the overflow totals through
    ``substrate.host_total``.  ``QueryStats.route`` records which route
    served the query.
    """

    def __init__(
        self,
        main: ShardedTripleStore,
        replicas: ReplicaIndex,
        n_workers: int,
        substrate=None,
    ):
        from .substrate import SingleDeviceSubstrate

        self.main = main
        self.replicas = replicas
        self.w = n_workers
        self.sub = substrate if substrate is not None else \
            SingleDeviceSubstrate()

    def _store_for(self, qedge: TreeEdge, pie: PIEdge, depth: int
                   ) -> ShardedTripleStore:
        # footnote-7 edges (subject-core under a collocating placement) are
        # recorded with storage_id None by IRD and served by the main index;
        # under a directory placement IRD materializes a replica module even
        # for subject-core edges, so the storage id alone routes correctly
        if pie.storage_id is None:
            return self.main
        return self.replicas.get(pie.storage_id)

    def execute(
        self,
        tree: RTree,
        matches: list[tuple[TreeEdge, PIEdge]],
        capacity: int = 1 << 12,
    ) -> tuple[Relation, QueryStats]:
        stats = QueryStats(mode="parallel-replica",
                           route=f"{self.sub.name}-local")
        capacity = quantize_capacity(capacity)
        pie_of = {id(qe): pie for qe, pie in matches}
        query = tree.query
        edges = tree.iter_edges()  # DFS pre-order: parents precede children
        rel: Relation | None = None

        for parent, edge, depth in edges:
            q = query.patterns[edge.pattern_idx]
            pie = pie_of[id(edge)]
            store = self._store_for(edge, pie, depth)
            spec = dsj.PatternSpec.of(q)
            consts = dsj.pattern_consts(q, self.main.device)
            if rel is None:
                rel = self._first(store, q, spec, consts, capacity, stats)
                # seed: if the root term is a variable it is bound by this
                # pattern; constants are enforced by the pattern itself
                continue
            join_term = parent.term
            child = edge.child.term
            if not edge.parent_is_subject and isinstance(child, Var) and \
                    child in rel.vars:
                # a cycle-closing edge whose subject is bound already: probe
                # the subject's few triples and check the parent, where the
                # reference probes the parent object and checks the subject
                # only after expanding all of the object's triples (at
                # LUBM-100 the triangle q2 needs 2^31 rows that way;
                # ROADMAP.md §3).  The matches, and their order, are the
                # same: one store, both ends fixed.
                rel = self._local_join(
                    store, rel, q, spec, consts, child, S, capacity, stats,
                )
            elif isinstance(join_term, Var) and join_term in rel.vars:
                rel = self._local_join(
                    store, rel, q, spec, consts, join_term,
                    S if edge.parent_is_subject else O, capacity, stats,
                )
            else:
                # parent is a constant vertex: the pattern is anchored by the
                # constant itself; semi-cartesian patterns are matched then
                # verified through shared variables (duplicated vertices)
                rel = self._anchored_join(
                    store, rel, q, spec, consts, capacity, stats
                )
            stats.n_local_joins += 1
        assert rel is not None
        return rel, stats

    # ------------------------------------------------------------- internals
    # Both stages go through the substrate's shard-local route; the host
    # reduces the overflow totals here (``sub.host_total``: on a mesh the
    # one all_reduce of the route) while deciding the overflow retry.
    def _first(self, store, q, spec, consts, cap, stats) -> Relation:
        for _ in range(_MAX_RETRIES):
            cols, valid, total = self.sub.match_first_local(
                store, consts, spec, cap
            )
            total = self.sub.host_total(total)
            if total <= cap:
                keep, vars_ = q.distinct_var_cols()
                if len(keep) != len(q.var_cols()):
                    cols = select_cols(cols, keep)
                return Relation(cols, valid, vars_, mesh=self.sub.mesh)
            cap = quantize_capacity(max(cap * 2, total))
            stats.n_retries += 1
        raise ExecutorError("parallel first match exceeded retries")

    def _local_join(
        self, store, rel, q, spec, consts, join_var, probe_col, cap, stats
    ) -> Relation:
        c1 = rel.col_of(join_var)
        checks = _shared_checks(rel.vars, q, join_var)
        append_cols, out_vars = _append_plan(rel.vars, q)
        for _ in range(_MAX_RETRIES):
            cols, valid, total = self.sub.local_probe_join_local(
                store, rel.cols, rel.valid, consts, spec, c1, probe_col,
                checks, append_cols, cap,
            )
            total = self.sub.host_total(total)
            if total <= cap:
                return Relation(cols, valid, out_vars, mesh=self.sub.mesh)
            cap = quantize_capacity(max(cap * 2, total))
            stats.n_retries += 1
        raise ExecutorError("parallel local join exceeded retries")

    def _anchored_join(self, store, rel, q, spec, consts, cap, stats
                       ) -> Relation:
        """Join with a constant-anchored pattern via any shared variable."""
        shared = [v for v in q.vars if v in rel.vars]
        if not shared:
            raise ExecutorError("disconnected parallel join")
        join_var = shared[0]
        probe_col = q.col_of(join_var)
        return self._local_join(
            store, rel, q, spec, consts, join_var, probe_col, cap, stats
        )
