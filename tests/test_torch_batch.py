"""The port's batched execution against B single-query calls, against its
own sequential loop and against the JAX package's ``query_batch``.

Stage by stage: each ``*_batch`` stage of ``repro_torch.core.dsj`` on B
queries equals B calls of its single-query stage, lane by lane (the plain
PyTorch versions take the folded shapes the kernels take on the card).
Engine by engine (``device="cpu"`` against ``probe_backend=
"searchsorted"``): ``query_batch`` gives the reference's answers, per-query
``comm_cells``, mode, route, ``n_retries``, report fields and pattern-index
fingerprint, with adaptivity off and on, under eviction, with adaptivity
kicking in mid-batch, and for empty and single-query workloads — mirroring
``tests/test_batch_parity.py``.  Integer outputs: no tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro.core.batcher import WorkloadBatcher as JBatcher
from repro.core.batcher import quantize_batch as j_quantize_batch
from repro.core.engine import AdHashEngine as JEngine
from repro.core.query import Const as JConst
from repro.core.query import Query as JQuery
from repro.core.query import TriplePattern as JTP
from repro.core.query import Var as JVar
from repro.data.synthetic_rdf import Workload, lubm_like
from repro_torch.core import dsj
from repro_torch.core.batcher import WorkloadBatcher, quantize_batch
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.query import O, S
from repro_torch.core.query import Query as TQuery

from reference import match_query

_DICT, _TRIPLES = lubm_like(2, 2, 2, 2)

_REPORT_FIELDS = (
    "n_queries", "n_parallel", "n_parallel_replica", "n_distributed",
    "comm_cells", "ird_comm_cells", "ird_triples", "n_redistributions",
    "n_evictions", "n_degraded", "n_batch_dispatches",
)


def _port(q: JQuery) -> TQuery:
    return TQuery.from_json(q.to_json())


def _stats_key(st) -> tuple:
    return (st.comm_cells, st.mode, st.route, st.n_retries, st.n_dsj,
            st.n_local_joins, st.plan)


# ------------------------------------------------------------ the batcher
def test_quantize_batch_matches_reference():
    sizes = list(range(1, 70)) + [127, 128, 129, 1000]
    assert [quantize_batch(b) for b in sizes] == \
        [j_quantize_batch(b) for b in sizes]
    assert [quantize_batch(b) for b in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]


@pytest.mark.parametrize("seed", [0, 5])
def test_workload_batcher_buckets_match_reference(seed):
    """Same queries, same plans: the same buckets in the same order, with
    the same members, capacity classes, step kinds and stacked constants;
    pop_bucket and pop take the same ones."""
    queries = Workload(_DICT, seed=seed).sample(24)
    j_eng = JEngine(_TRIPLES, 3, adaptive=False, capacity=256,
                    probe_backend="searchsorted")
    t_eng = AdHashEngine(_TRIPLES, 3, adaptive=False, capacity=256,
                         device="cpu")
    jb, tb = JBatcher(), WorkloadBatcher()
    for i, q in enumerate(queries):
        jp, tp = j_eng.planner.plan(q), t_eng.planner.plan(_port(q))
        cap = 256 if i % 5 else 4096  # two capacity classes
        jb.add(i, q, jp.ordering, jp.join_vars, cap)
        tb.add(i, _port(q), tp.ordering, tp.join_vars, cap)

    def shape(bucket):
        p = bucket.plan
        return (bucket.tags, p.capacity, p.first_keep, p.n_patterns, p.n_dsj,
                p.local_chain, [(s.kind, s.c1, s.c2, s.checks, s.append_cols)
                                for s in p.steps])

    assert [shape(b) for b in tb.buckets()] == [shape(b) for b in jb.buckets()]
    for j, t in zip(jb.buckets(), tb.buckets()):
        np.testing.assert_array_equal(t.stacked_consts(), j.stacked_consts())
    assert shape(tb.pop_bucket()) == shape(jb.pop_bucket())
    assert shape(tb.pop_bucket(force=True)) == shape(jb.pop_bucket(force=True))
    plan = tb.buckets()[-1].plan
    assert tb.pop(plan) is not None and tb.pop(plan) is None
    assert len(tb) == len(jb) - 1


# ------------------------------------------------- stages: batch == B x 1
_ENG = None


def _store():
    global _ENG
    if _ENG is None:
        _ENG = AdHashEngine(_TRIPLES, 4, adaptive=False, device="cpu")
    return _ENG.store


def _consts(pairs) -> torch.Tensor:
    """(B, 3) constants of (?x, p, o) / (s, p, ?y) patterns."""
    return torch.tensor(pairs, dtype=torch.int32)


def _bindings(store, b):
    """B first-match relations (B, W, cap, 2) of (?x, p_i, ?y), their
    constants, and the constants of B join patterns (?y, q_i, ?z): q_i is a
    predicate whose subjects meet p_i's objects, so every lane joins."""
    pairs = sorted({
        (int(p), int(q)) for p in np.unique(_TRIPLES[:, 1])
        for q in np.unique(_TRIPLES[:, 1])
        if np.intersect1d(_TRIPLES[_TRIPLES[:, 1] == p, 2],
                          _TRIPLES[_TRIPLES[:, 1] == q, 0]).size})[:b]
    assert len(pairs) == b
    consts = _consts([[-1, p, -1] for p, _ in pairs])
    spec = dsj.PatternSpec(False, True, False, False, (S, O))
    cols, valid, _ = dsj.match_first_batch(store, consts, spec, 256)
    return cols, valid, consts, _consts([[-1, q, -1] for _, q in pairs])


def _equal(batched, singles) -> None:
    """Lane i of every batched output equals the i-th single call's."""
    for i, single in enumerate(singles):
        for part, (a, b) in enumerate(zip(batched, single)):
            assert torch.equal(a[i], b), (i, part)


STAGES = ["match_first", "project_unique", "exchange_hash",
          "exchange_broadcast", "probe_and_reply", "finalize_join",
          "local_probe_join", "local_chain", "local_chain_from"]


@pytest.mark.parametrize("stage", STAGES)
def test_batch_stage_equals_single_calls(stage):
    store = _store()
    b = 5
    cols, valid, consts, jconsts = _bindings(store, b)
    # the join pattern of each lane, (?y, q_i, ?z), probed on its subject
    jspec = dsj.PatternSpec(False, True, False, False, (S, O))
    if stage == "match_first":
        spec = dsj.PatternSpec(False, True, True, False, (S,))
        objs = [int(o) for o in _TRIPLES[:b, 2]]
        cs = _consts([[-1, int(p), o] for p, o in
                      zip(_TRIPLES[:b, 1], objs)])
        _equal(dsj.match_first_batch(store, cs, spec, 64),
               [dsj.match_first(store, cs[i], spec, 64) for i in range(b)])
        assert int(dsj.match_first_batch(store, cs, spec, 64)[2].min()) > 0
    elif stage == "project_unique":
        got = dsj.project_unique_batch(cols, valid, 1, 128)
        _equal(got, [dsj.project_unique(cols[i], valid[i], 1, 128)
                     for i in range(b)])
    elif stage == "exchange_hash":
        proj, pv, _ = dsj.project_unique_batch(cols, valid, 1, 128)
        got = dsj.exchange_hash_batch(proj, pv, 64)
        _equal(got, [dsj.exchange_hash(proj[i], pv[i], 64)
                     for i in range(b)])
        assert int(got[2].sum()) > 0
    elif stage == "exchange_broadcast":
        proj, pv, _ = dsj.project_unique_batch(cols, valid, 1, 128)
        _equal(dsj.exchange_broadcast_batch(proj, pv),
               [dsj.exchange_broadcast(proj[i], pv[i]) for i in range(b)])
    elif stage in ("probe_and_reply", "finalize_join"):
        proj, pv, _ = dsj.project_unique_batch(cols, valid, 1, 128)
        recv, rv, _, _ = dsj.exchange_hash_batch(proj, pv, 128)
        got = dsj.probe_and_reply_batch(store, recv, rv, jconsts, jspec, S,
                                        256, 128)
        singles = [dsj.probe_and_reply(store, recv[i], rv[i], jconsts[i],
                                       jspec, S, 256, 128) for i in range(b)]
        if stage == "probe_and_reply":
            _equal(got, singles)
            assert int(got[1].sum()) > 0
        else:
            cand, cv = got[:2]
            out = dsj.finalize_join_batch(cols, valid, cand, cv, 1, S, (),
                                          (O,), 512)
            _equal(out, [dsj.finalize_join(cols[i], valid[i], cand[i], cv[i],
                                           1, S, (), (O,), 512)
                         for i in range(b)])
            assert int(out[1].sum()) > 0
    elif stage == "local_probe_join":
        # join on the pinned subject ?x (column 0), a residual check on ?y
        got = dsj.local_probe_join_batch(store, cols, valid, jconsts, jspec,
                                         0, S, ((1, O),), (), 256)
        _equal(got, [dsj.local_probe_join(store, cols[i], valid[i],
                                          jconsts[i], jspec, 0, S,
                                          ((1, O),), (), 256)
                     for i in range(b)])
        got = dsj.local_probe_join_batch(store, cols, valid, jconsts, jspec,
                                         0, S, (), (O,), 256)
        _equal(got, [dsj.local_probe_join(store, cols[i], valid[i],
                                          jconsts[i], jspec, 0, S, (), (O,),
                                          256) for i in range(b)])
        assert int(got[1].sum()) > 0
    else:
        steps = (dsj.ChainStep(jspec, 0, S, (), (O,)),
                 dsj.ChainStep(jspec, 0, S, (), (O,)))
        chain = torch.stack([consts, jconsts, consts], dim=1)  # (B, 3, 3)
        if stage == "local_chain":
            rels, tots = dsj.local_chain_batch(store, chain, jspec, (0, 1),
                                               steps, (256, 256, 512))
            singles = [dsj.local_chain(store, chain[i], jspec, (0, 1),
                                       steps, (256, 256, 512))
                       for i in range(b)]
        else:
            rels, tots = dsj.local_chain_from_batch(store, cols, valid,
                                                    chain[:, 1:], steps,
                                                    (256, 512))
            singles = [dsj.local_chain_from(store, cols[i], valid[i],
                                            chain[i, 1:], steps, (256, 512))
                       for i in range(b)]
        for i, (s_rels, s_tots) in enumerate(singles):
            assert torch.equal(tots[:, i], s_tots)
            for (bc, bv), (sc, sv) in zip(rels, s_rels):
                assert torch.equal(bc[i], sc) and torch.equal(bv[i], sv)


def test_match_ranges_batch_is_one_span_probe():
    """B pattern constants probe the store as the span form at M = B."""
    from repro_torch.core.triples import match_ranges, match_ranges_batch

    store = _store()
    p = torch.tensor([1, 3, -1, 7], dtype=torch.int32)
    k = torch.tensor([-1, 5, -1, 2], dtype=torch.int32)
    lo, hi = match_ranges_batch(store, p, k, False, store.n_ids)
    assert lo.shape == (4, store.n_workers)
    for i in range(4):
        slo, shi = match_ranges(store, p[i], k[i], False, store.n_ids)
        assert torch.equal(lo[i], slo) and torch.equal(hi[i], shi)


# ---------------------------------------------------------- engine level
def run_three(queries, *, adaptive, budget=None, threshold=2, w=3):
    """The reference's query_batch, the port's query_batch and the port's
    sequential loop over one workload."""
    kw = dict(adaptive=adaptive, frequency_threshold=threshold, capacity=256,
              replication_budget=budget)
    j_eng = JEngine(_TRIPLES, w, probe_backend="searchsorted", **kw)
    t_bat = AdHashEngine(_TRIPLES, w, device="cpu", **kw)
    t_seq = AdHashEngine(_TRIPLES, w, device="cpu", **kw)
    j_res = j_eng.query_batch(queries)
    t_res = t_bat.query_batch([_port(q) for q in queries])
    s_res = [t_seq.query(_port(q)) for q in queries]
    for i, ((jr, js), (tr, ts), (sr, ss)) in enumerate(
            zip(j_res, t_res, s_res)):
        assert tr.to_set() == jr.to_set() == sr.to_set(), i
        assert tr.vars == sr.vars and \
            [v.name for v in tr.vars] == [v.name for v in jr.vars], i
        assert _stats_key(ts) == _stats_key(js), (i, queries[i].name)
        assert (ts.comm_cells, ts.mode) == (ss.comm_cells, ss.mode), i
    for f in _REPORT_FIELDS:
        assert getattr(t_bat.report, f) == getattr(j_eng.report, f), f
    for f in ("n_queries", "n_parallel", "n_parallel_replica",
              "n_distributed", "comm_cells", "ird_comm_cells", "ird_triples",
              "n_redistributions", "n_evictions"):
        assert getattr(t_bat.report, f) == getattr(t_seq.report, f), f
    for eng in (j_eng, t_seq):
        assert [h[:2] for h in t_bat.report.history] == \
            [h[:2] for h in eng.report.history]
        assert t_bat.pattern_index.fingerprint() == \
            eng.pattern_index.fingerprint()
        assert t_bat.pattern_index.n_edges() == eng.pattern_index.n_edges()
        assert sorted(t_bat.replicas.modules) == sorted(eng.replicas.modules)
        np.testing.assert_array_equal(t_bat.replicas.per_worker_triples(),
                                      eng.replicas.per_worker_triples())
    assert t_bat.heatmap.to_state() == j_eng.heatmap.to_state()
    for sid, st in j_eng.replicas.modules.items():
        for a, b in zip(st.tree_flatten()[0],
                        t_bat.replicas.modules[sid].leaves()):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    return j_eng, t_bat, t_res


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("adaptive", [True, False])
def test_query_batch_matches_reference_and_sequential(seed, adaptive):
    queries = Workload(_DICT, seed=seed).sample(6) * 2
    _, t_bat, t_res = run_three(queries, adaptive=adaptive)
    assert t_bat.report.n_batch_dispatches > 0
    for q, (rel, _) in zip(queries, t_res):
        assert set(map(tuple, rel.project_to(_port(q).vars).tolist())) == \
            match_query(_TRIPLES, q), q.name


@pytest.mark.parametrize("seed", [11, 99])
def test_query_batch_parity_under_eviction(seed):
    queries = Workload(_DICT, seed=seed).sample(8) * 2
    _, t_bat, _ = run_three(queries, adaptive=True, budget=8)
    assert t_bat.report.n_evictions > 0


def test_query_batch_adaptivity_kicks_in_mid_batch():
    """IRD triggered by early members routes later members through the
    pattern index, as in the reference (the overlapped bucket included)."""
    adv = _DICT.lookup("ub:advisor")
    hot = JQuery([JTP(JVar("x"), JConst(adv), JVar("y"))], name="hot")
    others = Workload(_DICT, seed=2).sample(4)
    queries = [hot, others[0], others[1], hot, others[2], hot, others[3],
               hot]
    _, _, t_res = run_three(queries, adaptive=True, w=4)
    modes = [st.mode for q, (_, st) in zip(queries, t_res)
             if q.name == "hot"]
    assert modes[0] != "parallel-replica" and modes[-1] == "parallel-replica"


def test_query_batch_empty_and_single():
    eng = AdHashEngine(_TRIPLES, 2, adaptive=False, capacity=256,
                       device="cpu")
    assert eng.query_batch([]) == []
    (q,) = Workload(_DICT, seed=3).sample(1)
    (rel, st), = eng.query_batch([_port(q)])
    assert set(map(tuple, rel.project_to(_port(q).vars).tolist())) == \
        match_query(_TRIPLES, q)
    assert eng.report.n_queries == 1
    assert eng.report.n_batch_dispatches == 0  # a singleton runs alone
    run_three([q], adaptive=True)
    run_three([], adaptive=True)


def test_query_batch_degraded_demotes_like_the_reference():
    """With a dark shard, PI-hit members of a batch demote to the staged
    route (``single-degraded``), with the reference's answers and stats."""
    queries = Workload(_DICT, seed=7).sample(4) * 2
    j_eng = JEngine(_TRIPLES, 4, probe_backend="searchsorted",
                    frequency_threshold=2, capacity=256)
    t_eng = AdHashEngine(_TRIPLES, 4, frequency_threshold=2, capacity=256,
                         device="cpu")
    j_eng.query_batch(queries)
    t_eng.query_batch([_port(q) for q in queries])
    j_eng.health.mark_failed(3)
    t_eng.health.mark_failed(3)
    j_res = j_eng.query_batch(queries)
    t_res = t_eng.query_batch([_port(q) for q in queries])
    for (jr, js), (tr, ts) in zip(j_res, t_res):
        assert tr.to_set() == jr.to_set()
        assert _stats_key(ts) == _stats_key(js)
    assert any(st.route == "single-degraded" for _, st in t_res)
    assert t_eng.report.n_degraded == j_eng.report.n_degraded > 0
    assert t_eng.pattern_index.fingerprint() == \
        j_eng.pattern_index.fingerprint()


def test_execute_bucket_falls_back_only_on_executor_error(monkeypatch):
    """A bucket whose batched pipeline raises ExecutorError runs its members
    one by one; any other error propagates."""
    from repro_torch.core.executor import ExecutorError

    queries = [_port(q) for q in Workload(_DICT, seed=0).sample(6)] * 2
    eng = AdHashEngine(_TRIPLES, 3, adaptive=False, capacity=256,
                       device="cpu")
    want = [(r.to_set(), _stats_key(s)) for r, s in
            AdHashEngine(_TRIPLES, 3, adaptive=False, capacity=256,
                         device="cpu").query_batch(queries)]

    def fail(*a, **k):
        raise ExecutorError("forced")

    monkeypatch.setattr(eng.executor, "execute_batch", fail)
    got = eng.query_batch(queries)
    assert [r.to_set() for r, _ in got] == [w[0] for w in want]
    assert eng.report.n_batch_dispatches == 0

    def oom(*a, **k):
        raise MemoryError("not an executor error")

    monkeypatch.setattr(eng.executor, "execute_batch", oom)
    with pytest.raises(MemoryError):
        eng.query_batch(queries)
