"""Locality-Aware Distributed Execution (paper Algorithm 1).

PyTorch port of ``repro.core.executor``: single-query execution and the
batched execution of a shape bucket.  For each join step the executor picks
the paper's four cases (§4.1.3):

  (i)   c2 = subject  and c2 = pinned_subject  -> local join, zero comm
  (ii)  c2 = subject  and c2 != pinned_subject -> DSJ, hash-distributed column
  (iii) c2 != subject                          -> DSJ, broadcast column
  (iv)  multiple join columns -> join on subject if possible (as (ii)),
        verify remaining columns during finalization

Capacities are sized from the planner's cardinality estimates and grown on
overflow along the power-of-two ladder ``quantize_capacity(max(2*cap,
total))``, exactly as in the JAX package, so capacity classes and
``n_retries`` match the reference.  Every stage's wire cells are
accumulated into QueryStats — the paper's communication metric.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import dsj
from .backend import quantize_capacity
from .query import S, Query, TriplePattern, Var
from .relalg import select_cols
from .relation import Relation
from .substrate import host_fetch
from .triples import ShardedTripleStore

__all__ = ["QueryStats", "Executor", "ExecutorError", "step_descriptor"]

_MAX_RETRIES = 7


class ExecutorError(RuntimeError):
    pass


@dataclass
class QueryStats:
    mode: str = "distributed"  # or "parallel" / "parallel-replica"
    comm_cells: int = 0  # int32 cells on the wire
    n_dsj: int = 0
    n_local_joins: int = 0
    n_retries: int = 0
    plan: list[str] = field(default_factory=list)
    # which substrate route executed the query: "" for the staged path,
    # "<substrate>-local" when a pattern-index hit ran over the replica
    # index, "<substrate>-local-main" when a case-(i) chain ran the fused
    # route over the main index, "<substrate>-degraded" when a dark shard
    # demoted either fast route to the staged path
    route: str = ""

    @property
    def comm_bytes(self) -> int:
        return self.comm_cells * 4


def _shared_checks(
    rel_vars: tuple[Var, ...], q: TriplePattern, join_var: Var
) -> tuple[tuple[int, int], ...]:
    """(rel_col, triple_col) equality checks for extra shared vars (case iv)."""
    checks = []
    for v, c in q.var_cols():
        if v != join_var and v in rel_vars:
            checks.append((rel_vars.index(v), c))
    return tuple(checks)


def _append_plan(rel_vars: tuple[Var, ...], q: TriplePattern
                 ) -> tuple[tuple[int, ...], tuple[Var, ...]]:
    """Triple columns to append (vars not yet bound) + resulting var tuple."""
    append: list[int] = []
    out = list(rel_vars)
    for v, c in q.var_cols():
        if v not in out:
            append.append(c)
            out.append(v)
    return tuple(append), tuple(out)


@dataclass(frozen=True)
class _ChainPlan:
    """Host-static description of a fully-local (case-(i)) query chain —
    the unit the fused main-index route executes in one pass.  Shape-level
    only (no constants), so queries differing only in constants share one
    memoized instance."""

    first_spec: dsj.PatternSpec
    first_keep: tuple[int, ...]
    steps: tuple[dsj.ChainStep, ...]
    join_vars: tuple[Var, ...]  # per-step join variable, for plan strings
    out_vars: tuple[Var, ...]


def step_descriptor(
    rel_vars: tuple[Var, ...],
    q: TriplePattern,
    join_var: Var,
    pinned: Var | None,
    locality_aware: bool,
    pinned_opt: bool,
    local_join_safe: bool = True,
) -> tuple[str, int, int, tuple, tuple, tuple[Var, ...]]:
    """Static description of one join step: the §4.1.3 case selection plus
    the join-column/check/append layout.

    ``local_join_safe`` is the placement policy's guarantee that a
    subject's whole star lives on one shard.

    Returns (kind 'local'|'hash'|'bcast', c1, c2, checks, append_cols,
    out_vars)."""
    c1 = rel_vars.index(join_var)
    c2 = q.col_of(join_var)  # subject preferred by col_of
    checks = _shared_checks(rel_vars, q, join_var)
    append_cols, out_vars = _append_plan(rel_vars, q)
    if (
        c2 == S
        and pinned is not None
        and join_var == pinned
        and pinned_opt
        and locality_aware
        and local_join_safe
    ):
        kind = "local"  # case (i): zero communication
    elif c2 == S and locality_aware:
        kind = "hash"  # case (ii): Observation 1 fast path
    else:
        kind = "bcast"  # case (iii)
    return kind, c1, c2, checks, append_cols, out_vars


class Executor:
    """Evaluates one ordered query against a ShardedTripleStore.

    The two ablation flags reproduce the configurations of paper §6.3.1:
      locality_aware=False  -> projected columns are always broadcast
                               (disables Observation 1 hash distribution)
      pinned_opt=False      -> joins on the pinned subject still run as
                               synchronized DSJs (disables Observation 2)

    The executor never calls a dsj stage directly: all data-plane dispatch
    goes through the substrate.  ``health`` (an object with a ``degraded``
    flag, optional) demotes the fused chain route to the staged path while
    a shard is dark.
    """

    def __init__(
        self,
        store: ShardedTripleStore,
        n_workers: int,
        locality_aware: bool = True,
        pinned_opt: bool = True,
        substrate=None,
        placement=None,
        health=None,
        local_chain: bool = True,
    ):
        from .placement import HashPlacement
        from .substrate import SingleDeviceSubstrate

        self.store = store
        self.w = n_workers
        self.locality_aware = locality_aware
        self.pinned_opt = pinned_opt
        self.placement = placement if placement is not None else \
            HashPlacement(n_workers)
        self.sub = substrate if substrate is not None else \
            SingleDeviceSubstrate()
        self.sub.check_workers(n_workers)
        self.health = health
        self.local_chain = local_chain
        # chain-plan memo keyed by the query's *shape* (constants excluded),
        # bounded: a stream of fresh shapes cannot grow it forever
        self._chain_memo: dict[tuple, _ChainPlan | None] = {}
        self._chain_memo_cap = 4096
        # device-resident stage-constant tensors keyed by the ordered id
        # tuple: repeated queries pay no host->device copy
        self._consts_memo: dict[tuple, torch.Tensor] = {}

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ------------------------------------------------------------ first match
    def _match_first(self, q: TriplePattern, cap: int, stats: QueryStats
                     ) -> Relation:
        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, self.device)
        for _ in range(_MAX_RETRIES):
            cols, valid, total = self.sub.match_first(self.store, consts,
                                                      spec, cap)
            t = self.sub.host_total(total)
            if t <= cap:
                # keep one column per distinct variable (handles ?x p ?x)
                keep, vars_ = q.distinct_var_cols()
                if len(keep) != len(q.var_cols()):
                    cols = select_cols(cols, keep)
                return Relation(cols, valid, vars_, mesh=self.sub.mesh)
            cap = quantize_capacity(max(cap * 2, t))
            stats.n_retries += 1
        raise ExecutorError("match_first exceeded retry budget")

    # ------------------------------------------------------------- join steps
    def _join_step(
        self,
        rel: Relation,
        q: TriplePattern,
        join_var: Var,
        pinned: Var | None,
        cap: int,
        stats: QueryStats,
        comm: list,
    ) -> Relation:
        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, self.device)
        kind, c1, c2, checks, append_cols, out_vars = step_descriptor(
            rel.vars, q, join_var, pinned, self.locality_aware,
            self.pinned_opt, self.placement.local_join_safe,
        )

        # ---------------------------------------------------------- case (i)
        if kind == "local":
            stats.n_local_joins += 1
            stats.plan.append(f"local-join on {join_var}")
            for _ in range(_MAX_RETRIES):
                cols, valid, total = self.sub.local_probe_join(
                    self.store, rel.cols, rel.valid, consts, spec,
                    c1, c2, checks, append_cols, cap,
                )
                t = self.sub.host_total(total)
                if t <= cap:
                    return Relation(cols, valid, out_vars,
                                    mesh=self.sub.mesh)
                cap = quantize_capacity(max(cap * 2, t))
                stats.n_retries += 1
            raise ExecutorError("local join exceeded retry budget")

        # --------------------------------------------------- cases (ii)/(iii)
        stats.n_dsj += 1
        hash_mode = kind == "hash"
        stats.plan.append(
            f"dsj[{'hash' if hash_mode else 'bcast'}] on {join_var}"
        )
        cap_proj = quantize_capacity(cap)
        for _ in range(_MAX_RETRIES):
            proj, pvalid, nuniq = self.sub.project_unique(
                rel.cols, rel.valid, c1, cap_proj)
            nu = self.sub.host_total(nuniq)
            if nu <= cap_proj:
                break
            cap_proj = quantize_capacity(max(cap_proj * 2, nu))
            stats.n_retries += 1
        else:
            raise ExecutorError("projection exceeded retry budget")

        # wire-cell counts stay on the device (``comm``): the executor
        # fetches the per-query sum once instead of syncing per exchange
        if hash_mode:
            cap_peer = cap_proj
            # table fetched per call: a rebalance between queries swaps in a
            # fresh exception table (built on the device once per version)
            pspec = self.placement.stage_spec
            ptable = self.placement.device_table(self.store.device)
            for _ in range(_MAX_RETRIES):
                recv, rvalid, cells, maxb = self.sub.exchange_hash(
                    proj, pvalid, cap_peer, spec=pspec, table=ptable)
                mb = self.sub.host_total(maxb)
                if mb <= cap_peer:
                    break
                cap_peer = quantize_capacity(max(cap_peer * 2, mb))
                stats.n_retries += 1
            else:
                raise ExecutorError("hash exchange exceeded retry budget")
            comm.append(cells)
        else:
            recv, rvalid, cells = self.sub.exchange_broadcast(proj, pvalid)
            comm.append(cells)

        cap_flat = cap_cand = quantize_capacity(cap)
        for _ in range(_MAX_RETRIES):
            cand, cvalid, cells, maxf, maxc = self.sub.probe_and_reply(
                self.store, recv, rvalid, consts, spec, c2, cap_flat,
                cap_cand,
            )
            mf, mc = self.sub.host_total(maxf), self.sub.host_total(maxc)
            if mf <= cap_flat and mc <= cap_cand:
                break
            if mf > cap_flat:
                cap_flat = quantize_capacity(max(cap_flat * 2, mf))
            if mc > cap_cand:
                cap_cand = quantize_capacity(max(cap_cand * 2, mc))
            stats.n_retries += 1
        else:
            raise ExecutorError("probe/reply exceeded retry budget")
        comm.append(cells)

        for _ in range(_MAX_RETRIES):
            cols, valid, total = self.sub.finalize_join(
                rel.cols, rel.valid, cand, cvalid, c1, c2, checks,
                append_cols, cap,
            )
            t = self.sub.host_total(total)
            if t <= cap:
                return Relation(cols, valid, out_vars, mesh=self.sub.mesh)
            cap = quantize_capacity(max(cap * 2, t))
            stats.n_retries += 1
        raise ExecutorError("finalize exceeded retry budget")

    # --------------------------------------------- fused case-(i) chain route
    def _chain_plan(
        self, query: Query, ordering: list[int], join_vars: list[Var],
        pinned: Var | None,
    ) -> _ChainPlan | None:
        """The whole-query chain descriptor when *every* join is case (i)
        (subject star under a local-join-safe placement) — else None.

        Runs the same ``step_descriptor`` as the staged path, so route
        eligibility can never drift from the per-step case selection.
        Single-pattern queries are trivially eligible."""
        if not self.local_chain:
            return None
        key = (
            tuple(
                tuple(t if isinstance(t, Var) else None
                      for t in (p.s, p.p, p.o))
                for p in (query.patterns[i] for i in ordering)
            ),
            tuple(join_vars), pinned,
        )
        if key in self._chain_memo:
            return self._chain_memo[key]
        q1 = query.patterns[ordering[0]]
        keep, first_vars = q1.distinct_var_cols()
        rel_vars = first_vars
        steps: list[dsj.ChainStep] = []
        out_vars = first_vars
        plan: _ChainPlan | None = None
        for step, idx in enumerate(ordering[1:]):
            qj = query.patterns[idx]
            kind, c1, c2, checks, append_cols, out_vars = step_descriptor(
                rel_vars, qj, join_vars[step], pinned, self.locality_aware,
                self.pinned_opt, self.placement.local_join_safe,
            )
            if kind != "local":
                break
            steps.append(dsj.ChainStep(dsj.PatternSpec.of(qj), c1, c2,
                                       checks, append_cols))
            rel_vars = out_vars
        else:  # every join (or none: single pattern) is case (i)
            plan = _ChainPlan(dsj.PatternSpec.of(q1), tuple(keep),
                              tuple(steps), tuple(join_vars),
                              tuple(out_vars))
        if len(self._chain_memo) >= self._chain_memo_cap:
            self._chain_memo.clear()  # rare full flush beats an LRU walk
        self._chain_memo[key] = plan
        return plan

    def _execute_local_chain(
        self, patterns: list[TriplePattern], pinned: Var | None,
        chain: _ChainPlan, cap: int, stats: QueryStats,
    ) -> tuple[Relation, QueryStats]:
        """Speculative one-sync execution of a fused case-(i) chain.

        All stages run at their current capacity classes in one pass; the
        stacked per-stage overflow totals are fetched in ONE host sync at
        chain end.  On overflow, only the first overflowed stage has
        trustworthy inputs, so its capacity class grows (same ladder as the
        staged retry loops, so ``n_retries`` matches) and the chain re-runs
        from that stage, seeded by the last accepted intermediate."""
        ckey = tuple(-1 if isinstance(t, Var) else t.id
                     for p in patterns for t in (p.s, p.p, p.o))
        consts = self._consts_memo.get(ckey)
        if consts is None:
            consts = torch.from_numpy(
                np.array(ckey, dtype=np.int32).reshape(len(patterns), 3)
            ).to(self.device)
            if len(self._consts_memo) >= self._chain_memo_cap:
                self._consts_memo.clear()
            self._consts_memo[ckey] = consts
        n_stages = 1 + len(chain.steps)
        caps = [cap] * n_stages
        tries = [0] * n_stages
        rels: list = [None] * n_stages
        start = 0
        while True:
            if start == 0:
                out, totals = self.sub.local_chain(
                    self.store, consts, chain.first_spec, chain.first_keep,
                    chain.steps, tuple(caps),
                )
                rels[:] = list(out)
            else:
                seed_cols, seed_valid = rels[start - 1]
                out, totals = self.sub.local_chain_from(
                    self.store, seed_cols, seed_valid, consts[start:],
                    chain.steps[start - 1:], tuple(caps[start:]),
                )
                rels[start:] = list(out)
            tots = self.sub.host_chain_totals(totals)  # THE host sync
            bad = next(
                (j for j in range(start, n_stages)
                 if int(tots[j - start]) > caps[j]),
                None,
            )
            if bad is None:
                break
            stats.n_retries += 1
            tries[bad] += 1
            if tries[bad] >= _MAX_RETRIES:
                raise ExecutorError("local chain exceeded retry budget")
            caps[bad] = quantize_capacity(
                max(caps[bad] * 2, int(tots[bad - start]))
            )
            start = bad
        stats.plan.append(f"match {patterns[0]} (pinned={pinned})")
        for v in chain.join_vars:
            stats.plan.append(f"local-join on {v}")
        stats.n_local_joins += len(chain.steps)
        stats.mode = "parallel"
        stats.route = f"{self.sub.name}-local-main"
        cols, valid = rels[-1]
        return Relation(cols, valid, chain.out_vars,
                        mesh=self.sub.mesh), stats

    # -------------------------------------------------------------- top level
    def execute(
        self,
        query: Query,
        ordering: list[int],
        join_vars: list[Var],
        capacity: int | None = None,
    ) -> tuple[Relation, QueryStats]:
        """Algorithm 1: evaluate ``query`` under a planner-chosen ordering.

        ``join_vars[i]`` is the join variable for step i (joining pattern
        ordering[i+1] into the running intermediate result).  All-local
        (case-(i)) chains take the fused route over the main index unless
        a shard is dark."""
        stats = QueryStats()
        cap = quantize_capacity(capacity or query.capacity)
        q1 = query.patterns[ordering[0]]
        pinned = q1.s if isinstance(q1.s, Var) else None
        chain = self._chain_plan(query, ordering, join_vars, pinned)
        if chain is not None:
            if self.health is None or not self.health.degraded:
                return self._execute_local_chain(
                    [query.patterns[i] for i in ordering], pinned, chain,
                    cap, stats)
            stats.route = f"{self.sub.name}-degraded"
        return self._execute_staged(query, ordering, join_vars, pinned,
                                    cap, stats)

    def _execute_staged(
        self, query: Query, ordering: list[int], join_vars: list[Var],
        pinned: Var | None, cap: int, stats: QueryStats,
    ) -> tuple[Relation, QueryStats]:
        """The per-stage path: match-first, then one (possibly distributed)
        join step per pattern, with the capacity ladder per stage."""
        q1 = query.patterns[ordering[0]]
        rel = self._match_first(q1, cap, stats)
        stats.plan.append(f"match {q1} (pinned={pinned})")

        comm: list = []
        for step, idx in enumerate(ordering[1:]):
            qj = query.patterns[idx]
            rel = self._join_step(rel, qj, join_vars[step], pinned, cap,
                                  stats, comm)
        if comm:
            # a mesh rank's cells are its senders': summed over the ranks
            stats.comm_cells += int(host_fetch(
                self.sub.reduce_sum(torch.stack(comm).sum())))

        if stats.n_dsj == 0:
            stats.mode = "parallel"
        return rel, stats

    # ---------------------------------------------------- batched execution
    def execute_batch(
        self, bplan, consts: np.ndarray
    ) -> tuple[list[Relation], list[QueryStats]]:
        """Evaluate one shape bucket in a single batched pipeline.

        ``bplan`` is a :class:`repro_torch.core.batcher.BatchPlan`;
        ``consts`` is (B, n_patterns, 3) pattern constants in plan order.
        Same retry discipline as ``execute`` — a stage retries with a
        doubled capacity class when *any* bucket member overflows (results
        are unchanged: a stage is only accepted once no query drops rows).
        Communication is accounted per query from the stages' (B,) cell
        counts.  Each returned Relation is a view of lane i of the bucket's
        output, on the device."""
        from .batcher import quantize_batch

        b = consts.shape[0]
        b_pad = quantize_batch(b)
        consts = np.asarray(consts, dtype=np.int32)
        if b_pad != b:
            # pad with copies of the last query: real data, discarded outputs
            consts = np.concatenate([consts, np.broadcast_to(
                consts[-1:], (b_pad - b,) + consts.shape[1:])])
        consts_t = torch.from_numpy(np.ascontiguousarray(consts)).to(
            self.device)
        stats = [QueryStats() for _ in range(b)]

        # all-local bucket -> the fused chain route, unless a shard is dark
        # (then the staged path runs, with every member route-tagged as
        # demoted — mirroring ``execute``).  The reference also runs the
        # staged path once per bucket shape while healthy, to compile it
        # for a later failover; there is nothing to compile here.
        if self.local_chain and bplan.local_chain:
            if self.health is None or not self.health.degraded:
                return self._execute_batch_local_chain(bplan, consts_t, b,
                                                       stats)
            for st in stats:
                st.route = f"{self.sub.name}-degraded"
        return self._execute_batch_staged(bplan, consts_t, b, stats)

    def _execute_batch_staged(self, bplan, consts_t, b, stats):
        """The per-stage batched path (see ``execute_batch``)."""
        cap = bplan.capacity
        for _ in range(_MAX_RETRIES):
            cols, valid, totals = self.sub.match_first_batch(
                self.store, consts_t[:, 0], bplan.first_spec, cap)
            t = self.sub.host_total(totals)
            if t <= cap:
                break
            cap = quantize_capacity(max(cap * 2, t))
            for st in stats:
                st.n_retries += 1
        else:
            raise ExecutorError("batched match_first exceeded retry budget")
        if len(bplan.first_keep) != cols.shape[-1]:
            cols = select_cols(cols, bplan.first_keep)
        for st in stats:
            st.plan.append(f"match[batch={b}] {bplan.first_spec}")

        rel_cols, rel_valid = cols, valid
        n_dsj = 0
        comm: list = []  # per-stage (B,) device cell counts, fetched once
        for step, sp in enumerate(bplan.steps):
            qc = consts_t[:, 1 + step]
            if sp.kind == "local":
                rel_cols, rel_valid = self._batch_local_step(
                    sp, rel_cols, rel_valid, qc, bplan.capacity, stats)
            else:
                n_dsj += 1
                rel_cols, rel_valid = self._batch_dsj_step(
                    sp, rel_cols, rel_valid, qc, bplan.capacity, stats, comm)
        if comm:
            cells = host_fetch(self.sub.reduce_sum(torch.stack(comm).sum(
                dim=0)))
            for i in range(b):
                stats[i].comm_cells += int(cells[i])

        mode = "parallel" if n_dsj == 0 else "distributed"
        out_vars = bplan.steps[-1].out_vars if bplan.steps else \
            bplan.first_vars
        rels = []
        for i in range(b):
            stats[i].mode = mode
            rels.append(Relation(rel_cols[i], rel_valid[i], out_vars,
                                 mesh=self.sub.mesh))
        return rels, stats

    def _execute_batch_local_chain(self, bplan, consts_t, b, stats):
        """Batched speculative chain: the whole shape bucket in one pass,
        one host sync.  Same protocol as ``_execute_local_chain`` with
        per-stage maxima taken across the batch (and the shards) — capacity
        classes are shared across the bucket exactly like the staged batch
        retry loops."""
        steps = tuple(
            dsj.ChainStep(sp.spec, sp.c1, sp.c2, sp.checks, sp.append_cols)
            for sp in bplan.steps
        )
        n_stages = 1 + len(steps)
        caps = [bplan.capacity] * n_stages
        tries = [0] * n_stages
        rels: list = [None] * n_stages
        start = 0
        while True:
            if start == 0:
                out, totals = self.sub.local_chain_batch(
                    self.store, consts_t, bplan.first_spec, bplan.first_keep,
                    steps, tuple(caps))
                rels[:] = list(out)
            else:
                seed_cols, seed_valid = rels[start - 1]
                out, totals = self.sub.local_chain_from_batch(
                    self.store, seed_cols, seed_valid, consts_t[:, start:],
                    steps[start - 1:], tuple(caps[start:]))
                rels[start:] = list(out)
            tots = self.sub.host_chain_totals(totals)  # THE host sync
            bad = next(
                (j for j in range(start, n_stages)
                 if int(tots[j - start]) > caps[j]),
                None,
            )
            if bad is None:
                break
            for st in stats:
                st.n_retries += 1
            tries[bad] += 1
            if tries[bad] >= _MAX_RETRIES:
                raise ExecutorError("batched local chain exceeded retries")
            caps[bad] = quantize_capacity(
                max(caps[bad] * 2, int(tots[bad - start])))
            start = bad
        out_vars = bplan.steps[-1].out_vars if bplan.steps else \
            bplan.first_vars
        cols, valid = rels[-1]
        rels_out = []
        for i in range(b):
            st = stats[i]
            st.plan.append(f"match[batch={b}] {bplan.first_spec}")
            for sp in bplan.steps:
                st.plan.append(f"local-join on {sp.join_var}")
            st.n_local_joins += len(steps)
            st.mode = "parallel"
            st.route = f"{self.sub.name}-local-main"
            rels_out.append(Relation(cols[i], valid[i], out_vars,
                                     mesh=self.sub.mesh))
        return rels_out, stats

    def _batch_local_step(self, sp, rel_cols, rel_valid, qc, cap, stats):
        for st in stats:
            st.n_local_joins += 1
            st.plan.append(f"local-join on {sp.join_var}")
        for _ in range(_MAX_RETRIES):
            cols, valid, totals = self.sub.local_probe_join_batch(
                self.store, rel_cols, rel_valid, qc, sp.spec, sp.c1, sp.c2,
                sp.checks, sp.append_cols, cap)
            t = self.sub.host_total(totals)
            if t <= cap:
                return cols, valid
            cap = quantize_capacity(max(cap * 2, t))
            for st in stats:
                st.n_retries += 1
        raise ExecutorError("batched local join exceeded retry budget")

    def _batch_dsj_step(self, sp, rel_cols, rel_valid, qc, cap, stats, comm):
        hash_mode = sp.kind == "hash"
        for st in stats:
            st.n_dsj += 1
            st.plan.append(
                f"dsj[{'hash' if hash_mode else 'bcast'}] on {sp.join_var}")

        cap_proj = quantize_capacity(cap)
        for _ in range(_MAX_RETRIES):
            proj, pvalid, nuniq = self.sub.project_unique_batch(
                rel_cols, rel_valid, sp.c1, cap_proj)
            nu = self.sub.host_total(nuniq)
            if nu <= cap_proj:
                break
            cap_proj = quantize_capacity(max(cap_proj * 2, nu))
            for st in stats:
                st.n_retries += 1
        else:
            raise ExecutorError("batched projection exceeded retry budget")

        if hash_mode:
            cap_peer = cap_proj
            pspec = self.placement.stage_spec
            ptable = self.placement.device_table(self.store.device)
            for _ in range(_MAX_RETRIES):
                recv, rvalid, cells, maxb = self.sub.exchange_hash_batch(
                    proj, pvalid, cap_peer, spec=pspec, table=ptable)
                mb = self.sub.host_total(maxb)
                if mb <= cap_peer:
                    break
                cap_peer = quantize_capacity(max(cap_peer * 2, mb))
                for st in stats:
                    st.n_retries += 1
            else:
                raise ExecutorError("batched hash exchange exceeded retries")
        else:
            recv, rvalid, cells = self.sub.exchange_broadcast_batch(proj,
                                                                    pvalid)
        comm.append(cells)  # (B,) device tensor — fetched once per batch
        del proj, pvalid

        cap_flat = cap_cand = quantize_capacity(cap)
        for _ in range(_MAX_RETRIES):
            cand, cvalid, cells, maxf, maxc = self.sub.probe_and_reply_batch(
                self.store, recv, rvalid, qc, sp.spec, sp.c2, cap_flat,
                cap_cand)
            mf, mc = self.sub.host_total(maxf), self.sub.host_total(maxc)
            if mf <= cap_flat and mc <= cap_cand:
                break
            if mf > cap_flat:
                cap_flat = quantize_capacity(max(cap_flat * 2, mf))
            if mc > cap_cand:
                cap_cand = quantize_capacity(max(cap_cand * 2, mc))
            for st in stats:
                st.n_retries += 1
        else:
            raise ExecutorError("batched probe/reply exceeded retry budget")
        comm.append(cells)
        del recv, rvalid

        for _ in range(_MAX_RETRIES):
            cols, valid, totals = self.sub.finalize_join_batch(
                rel_cols, rel_valid, cand, cvalid, sp.c1, sp.c2, sp.checks,
                sp.append_cols, cap)
            t = self.sub.host_total(totals)
            if t <= cap:
                return cols, valid
            cap = quantize_capacity(max(cap * 2, t))
            for st in stats:
                st.n_retries += 1
        raise ExecutorError("batched finalize exceeded retry budget")
