"""SPARQL basic-graph-pattern query model (paper §1, §4).

A query is a set of triple patterns; each position is a variable or a
constant id.  We only model conjunctive BGPs (what AdHash evaluates); the
join graph, join variables and star/subject-star classification used by the
planner all live here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

__all__ = ["Term", "Var", "Const", "TriplePattern", "Query", "S", "P", "O"]

# column tags
S, P, O = 0, 1, 2
_COLS = ("subject", "predicate", "object")


@dataclass(frozen=True, order=True)
class Var:
    name: str

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"?{self.name}"


@dataclass(frozen=True, order=True)
class Const:
    id: int

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self.id}>"


Term = Var | Const


@dataclass(frozen=True)
class TriplePattern:
    s: Term
    p: Term
    o: Term

    def term(self, col: int) -> Term:
        return (self.s, self.p, self.o)[col]

    @property
    def vars(self) -> tuple[Var, ...]:
        return tuple(t for t in (self.s, self.p, self.o) if isinstance(t, Var))

    @property
    def n_vars(self) -> int:
        return len(self.vars)

    def var_cols(self) -> list[tuple[Var, int]]:
        return [(t, c) for c, t in enumerate((self.s, self.p, self.o)) if isinstance(t, Var)]

    def col_of(self, v: Var) -> int | None:
        """Column where variable v appears (subject preferred if repeated)."""
        for c, t in enumerate((self.s, self.p, self.o)):
            if t == v:
                return c
        return None

    def distinct_var_cols(self) -> tuple[tuple[int, ...], tuple["Var", ...]]:
        """First-occurrence positions (into ``var_cols()``) per distinct
        variable + the deduped variable tuple — the column-keep plan for
        repeated-variable patterns like (?x p ?x).  Shared by the sequential
        executors and the workload batcher so all paths agree on relation
        layout (the batched bucket key depends on it)."""
        keep: list[int] = []
        vars_: list[Var] = []
        for i, (v, _c) in enumerate(self.var_cols()):
            if v not in vars_:
                vars_.append(v)
                keep.append(i)
        return tuple(keep), tuple(vars_)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"({self.s} {self.p} {self.o})"


@dataclass
class Query:
    patterns: list[TriplePattern]
    name: str = ""
    # capacity hint for intermediate relations (rows); engine may retry larger.
    capacity: int = 4096

    def __post_init__(self) -> None:
        from .backend import quantize_capacity

        self._vars = sorted({v for q in self.patterns for v in q.vars})
        # capacities are static jit shapes: snap user hints to the shared
        # power-of-two classes so same-shape queries reuse compiled stages
        self.capacity = quantize_capacity(self.capacity)

    # ------------------------------------------------------------------ props
    @property
    def vars(self) -> list[Var]:
        return self._vars

    def __iter__(self) -> Iterator[TriplePattern]:
        return iter(self.patterns)

    def __len__(self) -> int:
        return len(self.patterns)

    # ------------------------------------------------------------- structure
    def shared_vars(self, i: int, j: int) -> list[Var]:
        vi = set(self.patterns[i].vars)
        vj = set(self.patterns[j].vars)
        return sorted(vi & vj)

    def adjacency(self) -> dict[int, set[int]]:
        """Pattern-level join graph: i ~ j iff they share a variable."""
        adj: dict[int, set[int]] = {i: set() for i in range(len(self.patterns))}
        for i in range(len(self.patterns)):
            for j in range(i + 1, len(self.patterns)):
                if self.shared_vars(i, j):
                    adj[i].add(j)
                    adj[j].add(i)
        return adj

    def is_connected(self) -> bool:
        if not self.patterns:
            return True
        adj = self.adjacency()
        seen = {0}
        stack = [0]
        while stack:
            for nb in adj[stack.pop()]:
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        return len(seen) == len(self.patterns)

    def is_subject_star(self) -> bool:
        """All patterns share one subject variable -> parallel mode for free
        under subject-hash partitioning (paper §3.1 / §4.1)."""
        if not self.patterns:
            return False
        s0 = self.patterns[0].s
        if not isinstance(s0, Var):
            return False
        return all(q.s == s0 for q in self.patterns)

    # --------------------------------------------------------------- vertices
    def graph_vertices(self) -> list[Term]:
        """Vertices of the query graph = all subject/object terms."""
        out: list[Term] = []
        seen = set()
        for q in self.patterns:
            for t in (q.s, q.o):
                if t not in seen:
                    seen.add(t)
                    out.append(t)
        return out

    def edges(self) -> list[tuple[Term, Term, Term, int]]:
        """(subject, predicate, object, pattern_idx) edges of the query graph."""
        return [(q.s, q.p, q.o, i) for i, q in enumerate(self.patterns)]

    # ---------------------------------------------------------- serialization
    # The master's query log (paper §3.1) is persisted as JSONL so a restarted
    # master can replay it; terms encode as {"v": name} / {"c": id}.
    def to_json(self) -> dict:
        def term(t: Term):
            return {"v": t.name} if isinstance(t, Var) else {"c": t.id}

        return {
            "name": self.name,
            "capacity": self.capacity,
            "patterns": [[term(q.s), term(q.p), term(q.o)]
                         for q in self.patterns],
        }

    @classmethod
    def from_json(cls, d: dict) -> "Query":
        def term(t: dict) -> Term:
            return Var(t["v"]) if "v" in t else Const(int(t["c"]))

        return cls(
            patterns=[TriplePattern(*(term(t) for t in p))
                      for p in d["patterns"]],
            name=d.get("name", ""),
            capacity=int(d.get("capacity", 4096)),
        )
