"""Locality-aware query planning: DP + cost model (paper §4.2, §4.3).

States are identified by the *set* of joined patterns; each keeps the
cheapest ordering (ties broken first by the number of synchronizing steps —
a zero-cost case-(i) step runs on the fused zero-collective chain route,
DESIGN §11 — then by cumulative cardinality, as in the paper), the
estimated per-variable binding cardinalities B(v), and the pinned
subject.  The cost of expanding a state with pattern p_j follows §4.3:

  cost = 0                                          c_j subject & pinned
       = B(c_j) + nu * B(c_j) * Pps                 c_j subject, not pinned
       = B(c_j)*N + nu * N * B(c_j) * Ppo           c_j not subject

A branch whose cost exceeds the best complete plan found so far is pruned
(the cost function is monotone).  DP seeding starts from patterns connected
to the subject with the highest out-degree (paper §4.2) so good plans are
found early and pruning bites.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

from .backend import quantize_capacity
from .query import O, P, S, Query, TriplePattern, Var
from .stats import GlobalStats

__all__ = ["Plan", "LocalityAwarePlanner"]

INF = math.inf


@dataclass
class Plan:
    ordering: list[int]
    join_vars: list[Var]
    est_cost: float
    est_cards: list[float]  # running result-size estimate per step
    parallel: bool  # zero estimated communication (subject star etc.)

    def capacity_hint(self, floor: int = 64, ceil: int = 1 << 20) -> int:
        """Power-of-two capacity class covering 2x the estimated cardinality.

        Quantized so that queries with nearby estimates share jitted stages
        instead of each baking a fresh static shape (recompilation storm)."""
        est = max([1.0] + [c for c in self.est_cards if math.isfinite(c)])
        return quantize_capacity(2 * est, floor=floor, ceil=ceil)


@dataclass
class _State:
    cost: float
    cum_card: float
    card: float  # current (non-cumulative) result-size estimate
    ordering: tuple[int, ...]
    join_vars: tuple[Var, ...]
    cards: tuple[float, ...]
    bindings: dict[Var, float] = field(default_factory=dict)
    pinned: Var | None = None
    # synchronizing (non-case-(i)) steps.  A zero-cost step is a shard-local
    # join the fused chain route executes with no exchange and no host sync
    # (DESIGN §11); every other step pays at least one.  Among equal-cost
    # orderings the cheaper one at runtime is the one with fewer such steps.
    n_sync: int = 0


class LocalityAwarePlanner:
    def __init__(
        self,
        stats: GlobalStats,
        n_workers: int,
        # optional exact-count oracle for patterns with constants (§4.3:
        # "the master consults the workers to update the cardinalities")
        count_oracle: Callable[[TriplePattern], int] | None = None,
    ):
        self.stats = stats
        self.n = n_workers
        self.oracle = count_oracle
        # exact-query plan memo: stats and the main index are immutable, so
        # a query's plan is deterministic — workload throughput (query_batch)
        # would otherwise re-run the DP + oracle probes per repeat.  Keys
        # include constants (oracle counts depend on them), so a stream of
        # fresh constants would grow this forever: bounded, LRU-evicted.
        self._memo: dict[tuple, Plan] = {}
        self._memo_cap = 4096
        preds = stats.per_pred
        self._n_preds = max(len(preds), 1)
        if preds:
            self._avg_pps = sum(s.pps for s in preds.values()) / len(preds)
            self._avg_ppo = sum(s.ppo for s in preds.values()) / len(preds)
            self._avg_card = stats.n_triples / len(preds)
        else:
            self._avg_pps = self._avg_ppo = self._avg_card = 1.0

    # ------------------------------------------------------- predicate stats
    def _pred(self, q: TriplePattern) -> tuple[float, float, float, float, float]:
        """(|p|, |p.s|, |p.o|, Pps, Ppo) with averages for var predicates."""
        if isinstance(q.p, Var):
            return (
                self._avg_card * self._n_preds,
                self._avg_card * self._n_preds,
                self._avg_card * self._n_preds,
                self._avg_pps,
                self._avg_ppo,
            )
        st = self.stats.get(q.p.id)
        if st is None:
            return (0.0, 0.0, 0.0, 1.0, 1.0)
        return (float(st.card), float(st.n_subj), float(st.n_obj), st.pps, st.ppo)

    # ----------------------------------------------------------- init states
    def _init_state(self, i: int, q: TriplePattern) -> _State:
        card_p, ns, no, pps, ppo = self._pred(q)
        # §4.3: initial cumulative cardinality = the subquery's cardinality;
        # constants narrow it (workers are consulted when an oracle exists).
        card = card_p
        if not isinstance(q.s, Var):
            card = card / max(ns, 1.0)
        if not isinstance(q.o, Var):
            card = card / max(no, 1.0)
        if self.oracle is not None and (
            not isinstance(q.s, Var)
            or not isinstance(q.o, Var)
            or not isinstance(q.p, Var)
        ):
            card = float(self.oracle(q))
        b: dict[Var, float] = {}
        for v, c in q.var_cols():
            if c == S:
                b[v] = min(ns, card)
            elif c == O:
                b[v] = min(no, card)
            else:
                b[v] = float(self._n_preds)
        return _State(
            cost=0.0,
            cum_card=card,
            card=card,
            ordering=(i,),
            join_vars=(),
            cards=(card,),
            bindings=b,
            pinned=q.s if isinstance(q.s, Var) else None,
        )

    # ------------------------------------------------------------- expansion
    def _choose_join_var(self, st: _State, q: TriplePattern) -> Var | None:
        shared = [v for v in q.vars if v in st.bindings]
        if not shared:
            return None
        # case (iv): prefer the subject column of p_j when it is a join attr
        if isinstance(q.s, Var) and q.s in st.bindings:
            return q.s
        # otherwise prefer object over predicate, smallest bindings first
        shared.sort(key=lambda v: (q.col_of(v) == P, st.bindings[v]))
        return shared[0]

    def _expand(self, st: _State, j: int, q: TriplePattern) -> _State | None:
        cj = self._choose_join_var(st, q)
        if cj is None:
            return None
        col = q.col_of(cj)
        card_p, ns, no, pps, ppo = self._pred(q)
        nu = q.n_vars
        b_cj = st.bindings[cj]

        if col == S and cj == st.pinned:
            step_cost = 0.0
        elif col == S:
            step_cost = b_cj + nu * b_cj * pps
        else:
            step_cost = b_cj * self.n + nu * self.n * b_cj * ppo

        # ------- §4.3 cardinality re-estimation for the variables of p_j
        new_b = dict(st.bindings)
        for v, c in q.var_cols():
            pv = ns if c == S else (no if c == O else float(self._n_preds))
            ppv = pps if c == S else ppo
            prev = st.bindings.get(v, INF)
            if nu == 1:
                est = min(prev, card_p)
            elif v == cj:
                est = min(prev, pv)
            else:
                est = min(prev, (prev if math.isfinite(prev) else pv) * ppv, pv)
            new_b[v] = max(est, 1.0)

        ppc = pps if col == S else ppo
        has_const = not (
            isinstance(q.s, Var) and isinstance(q.o, Var) and isinstance(q.p, Var)
        )
        if has_const:
            ppc = min(ppc, 1.0) if nu == 1 else ppc
        # special case (§4.3): subquery with a constant -> P_pc_j := 1
        if not isinstance(q.o, Var) and col == S:
            ppc = 1.0
        if not isinstance(q.s, Var) and col == O:
            ppc = 1.0
        cum = st.cum_card * (1.0 + ppc)
        card = st.card * ppc if col != P else st.card

        return _State(
            cost=st.cost + step_cost,
            cum_card=cum,
            card=max(card, 1.0),
            ordering=st.ordering + (j,),
            join_vars=st.join_vars + (cj,),
            cards=st.cards + (card,),
            bindings=new_b,
            pinned=st.pinned,
            n_sync=st.n_sync + (0 if step_cost == 0.0 else 1),
        )

    # --------------------------------------------------------------- DP loop
    def plan(self, query: Query) -> Plan:
        key = tuple((q.s, q.p, q.o) for q in query.patterns)
        cached = self._memo.pop(key, None)
        if cached is None:
            cached = self._plan_uncached(query)
        self._memo[key] = cached  # (re-)insert: dict order is the LRU order
        while len(self._memo) > self._memo_cap:
            del self._memo[next(iter(self._memo))]
        # fresh lists per caller: a mutated return value must not poison
        # the memo for every future identical query
        return Plan(list(cached.ordering), list(cached.join_vars),
                    cached.est_cost, list(cached.est_cards), cached.parallel)

    def _plan_uncached(self, query: Query) -> Plan:
        n = len(query.patterns)
        if n == 0:
            raise ValueError("empty query")
        if n == 1:
            st = self._init_state(0, query.patterns[0])
            return Plan([0], [], 0.0, [st.card], True)

        # seed ordering: subjects with most outgoing edges first (§4.2)
        out_deg: dict = {}
        for q in query.patterns:
            out_deg[q.s] = out_deg.get(q.s, 0) + 1
        seeds = sorted(
            range(n), key=lambda i: -out_deg.get(query.patterns[i].s, 0)
        )

        best: dict[frozenset, _State] = {}
        for i in seeds:
            key = frozenset([i])
            best[key] = self._init_state(i, query.patterns[i])

        min_c = INF
        frontier = [frozenset([i]) for i in seeds]
        for _level in range(n - 1):
            nxt: list[frozenset] = []
            for key in frontier:
                st = best.get(key)
                if st is None or st.cost > min_c:
                    continue
                for j in range(n):
                    if j in key:
                        continue
                    ns_ = self._expand(st, j, query.patterns[j])
                    if ns_ is None or ns_.cost > min_c:
                        continue
                    nk = key | {j}
                    cur = best.get(nk)
                    # lexicographic (cost, n_sync, cum_card): the paper's
                    # tie-break on cumulative cardinality, refined to first
                    # prefer orderings with fewer synchronizing steps — an
                    # all-local ordering rides the one-sync fused chain
                    if cur is None or (
                        (ns_.cost, ns_.n_sync, ns_.cum_card)
                        < (cur.cost, cur.n_sync, cur.cum_card)
                    ):
                        best[nk] = ns_
                        if nk not in nxt:
                            nxt.append(nk)
                        if len(nk) == n:
                            min_c = min(min_c, ns_.cost)
            frontier = nxt

        full = best.get(frozenset(range(n)))
        if full is None:
            raise ValueError(
                "query is disconnected (cartesian products unsupported)"
            )
        return Plan(
            ordering=list(full.ordering),
            join_vars=list(full.join_vars),
            est_cost=full.cost,
            est_cards=list(full.cards),
            parallel=(full.cost == 0.0),
        )
