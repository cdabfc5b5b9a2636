"""The port's adaptivity (transform, heat map, pattern and replica index,
IRD, eviction, health) against the JAX package's, bit for bit.

Same numpy triples and queries through ``repro`` (``probe_backend=
"searchsorted"``) and through the port on ``device="cpu"``: redistribution
trees, heat-map states, replica stores (all five tensors), and, engine by
engine with the default ``adaptive=True``, answers, ``comm_cells``, mode,
route, ``n_retries``, plan, every ``EngineReport`` field, the pattern
index's fingerprint and state, ``replication_ratio`` and ``load_balance``
must be equal query by query.  These are integer outputs: nothing here has
a tolerance.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro.core import stats as jstats
from repro.core import transform as jtransform
from repro.core.engine import AdHashEngine as JEngine
from repro.core.heatmap import HeatMap as JHeatMap
from repro.core.query import Const as JConst
from repro.core.query import Query as JQuery
from repro.core.query import TriplePattern as JTP
from repro.core.query import Var as JVar
from repro.core.triples import ShardedTripleStore as JStore
from repro.data.synthetic_rdf import Workload, lubm_like, lubm_queries
from repro_torch.core import stats as tstats
from repro_torch.core import transform as ttransform
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.health import HealthState
from repro_torch.core.heatmap import HeatMap
from repro_torch.core.query import Query as TQuery
from repro_torch.core.triples import ShardedTripleStore

_DICT, _TRIPLES = lubm_like(2, 2, 2, 2)

# every counter of EngineReport (wall_time_s is a host clock)
REPORT_FIELDS = (
    "n_queries", "n_parallel", "n_parallel_replica", "n_distributed",
    "comm_cells", "ird_comm_cells", "ird_triples", "n_redistributions",
    "n_evictions", "n_rebalances", "rebalance_comm_cells", "n_degraded",
    "n_batch_dispatches", "comm_bytes",
)


def _port(q: JQuery) -> TQuery:
    return TQuery.from_json(q.to_json())


def _workload(seed: int, n: int) -> list[JQuery]:
    """A sample over all six templates, repeated so patterns turn hot."""
    return Workload(_DICT, seed=seed).sample(n) * 2


def _engines(w: int, **kw):
    kw.setdefault("capacity", 256)
    return (JEngine(_TRIPLES, w, probe_backend="searchsorted", **kw),
            AdHashEngine(_TRIPLES, w, device="cpu", **kw))


def _term(t) -> tuple:
    return ("c", t.id) if hasattr(t, "id") else ("v", t.name)


def _tree(node) -> tuple:
    """A redistribution tree as nested tuples (terms by value)."""
    return (_term(node.term), node.uid, tuple(
        (_term(e.pred), e.parent_is_subject, e.pattern_idx, _tree(e.child))
        for e in node.children))


def _edge_keys(keys) -> set:
    """Heat-map path keys by value (each package has its own EdgeKey)."""
    return {tuple(tuple((k.pred, k.parent_is_subject) for k in path)
                  for path in key) for key in keys}


def _assert_stores_equal(j_store, t_store, what) -> None:
    for name, a, b in zip(("spo_ps", "keys_ps", "spo_po", "keys_po",
                           "counts"), j_store.tree_flatten()[0],
                          t_store.leaves()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what}: {name}")


def assert_adaptivity_equal(j_eng, t_eng) -> None:
    """Report, pattern index, heat map and every replica store."""
    for f in REPORT_FIELDS:
        assert getattr(t_eng.report, f) == getattr(j_eng.report, f), f
    assert [h[:2] for h in t_eng.report.history] == \
        [h[:2] for h in j_eng.report.history]
    assert t_eng.pattern_index.fingerprint() == \
        j_eng.pattern_index.fingerprint()
    assert t_eng.pattern_index.to_state() == j_eng.pattern_index.to_state()
    assert t_eng.heatmap.to_state() == j_eng.heatmap.to_state()
    assert _edge_keys(t_eng._no_redistribute) == \
        _edge_keys(j_eng._no_redistribute)
    assert sorted(t_eng.replicas.modules) == sorted(j_eng.replicas.modules)
    assert t_eng.replicas.next_id_n == j_eng.replicas.next_id_n
    for sid, st in j_eng.replicas.modules.items():
        _assert_stores_equal(st, t_eng.replicas.modules[sid], sid)
    np.testing.assert_array_equal(t_eng.replicas.per_worker_triples(),
                                  j_eng.replicas.per_worker_triples())
    assert t_eng.replication_ratio() == j_eng.replication_ratio()
    assert t_eng.load_balance() == j_eng.load_balance()


def run_lockstep(j_eng, t_eng, queries) -> list:
    """Both engines answer the same queries one by one; every answer and
    per-query stat must be equal."""
    stats = []
    for q in queries:
        jrel, jst = j_eng.query(q)
        trel, tst = t_eng.query(_port(q))
        assert trel.to_set() == jrel.to_set(), q.name
        assert (tst.comm_cells, tst.mode, tst.route, tst.n_retries,
                tst.n_dsj, tst.n_local_joins, tst.plan) == \
            (jst.comm_cells, jst.mode, jst.route, jst.n_retries,
             jst.n_dsj, jst.n_local_joins, jst.plan), q.name
        stats.append(tst)
    return stats


# ------------------------------------------------- transform and heat map
@pytest.mark.parametrize("heuristic", ["high_low", "low_high", "qdegree"])
def test_trees_and_heatmap_match_reference(heuristic):
    """Algorithm 2's tree of every query, the heat map's full state after
    the workload and the hot patterns it yields are the reference's."""
    j_gs = jstats.compute_stats(_TRIPLES)
    t_gs = tstats.compute_stats(_TRIPLES)
    queries = _workload(0, 30) + [
        t.make(c) for t in lubm_queries(_DICT).values()
        for c in t.constants[:2]]
    j_hm, t_hm = JHeatMap(), HeatMap()
    for q in queries:
        jt = jtransform.build_redistribution_tree(q, j_gs, heuristic)
        tt = ttransform.build_redistribution_tree(_port(q), t_gs, heuristic)
        assert _tree(tt.root) == _tree(jt.root), q.name
        assert [(p.uid, e.pattern_idx) for p, e, _ in tt.iter_edges()] == \
            [(p.uid, e.pattern_idx) for p, e, _ in jt.iter_edges()]
        assert j_hm.insert(jt) == t_hm.insert(tt)
    assert t_hm.to_state() == j_hm.to_state()
    assert dict(t_hm.vertex_frequencies()) == \
        dict(j_hm.vertex_frequencies())
    for threshold in (2, 3, 5):
        j_hot = j_hm.hot_patterns(threshold)
        t_hot = t_hm.hot_patterns(threshold)
        assert [h.query.to_json() for h in t_hot] == \
            [h.query.to_json() for h in j_hot]
        assert [_tree(h.rtree.root) for h in t_hot] == \
            [_tree(h.rtree.root) for h in j_hot]
        assert [[tuple((k.pred, k.parent_is_subject) for k in p)
                 for p in h.edge_paths] for h in t_hot] == \
            [[tuple((k.pred, k.parent_is_subject) for k in p)
              for p in h.edge_paths] for h in j_hot]
    restored = HeatMap.from_state(t_hm.to_state())
    assert restored.to_state() == t_hm.to_state()


def test_from_device_rows_matches_reference():
    """Replica indexing: duplicates masked, invalid rows last, every sort
    stable — the five tensors equal the reference's bit for bit, padding
    rows included."""
    rng = np.random.default_rng(5)
    w, cap, nid = 3, 257, 40
    rows = rng.integers(0, 6, (w, cap, 3)).astype(np.int32)
    rows[..., 1] += 30  # predicates
    rows[:, 100:110] = rows[:, 0:10]  # exact duplicates
    valid = rng.random((w, cap)) < 0.7
    rows = np.where(valid[..., None], rows, -1).astype(np.int32)
    rows[1, :7] = rows[1, 7:14]  # a valid copy next to an invalid one
    valid[2] = False  # a worker with no row at all
    j = JStore.from_device_rows(jnp.asarray(rows), jnp.asarray(valid), nid)
    t = ShardedTripleStore.from_device_rows(torch.from_numpy(rows),
                                            torch.from_numpy(valid), nid)
    _assert_stores_equal(j, t, "from_device_rows")
    assert int(t.counts[2]) == 0 and int(t.counts.min()) >= 0


# ----------------------------------------------------------- the engine
@pytest.mark.parametrize("w,threshold", [(3, 2), (3, 3), (4, 2), (4, 3)])
def test_adaptive_engine_matches_reference(w, threshold):
    """The default adaptive engine: every answer and stat, and after the
    workload the report, pattern index, heat map and replica stores."""
    queries = _workload(w + threshold, 14)
    j_eng, t_eng = _engines(w, frequency_threshold=threshold)
    stats = run_lockstep(j_eng, t_eng, queries)
    assert_adaptivity_equal(j_eng, t_eng)
    assert t_eng.report.n_redistributions > 0
    assert any(st.mode == "parallel-replica" and st.route == "single-local"
               for st in stats)


def test_cycle_closing_edge_probes_its_bound_subject():
    """The port's one departure from the reference (ROADMAP.md §3): on a
    pattern-index hit, a cycle-closing edge whose subject is bound already
    probes that subject, where the reference probes the parent object and
    checks the subject after expanding every triple of the object.  Same
    answers, same pattern-index state, and a smaller expansion: here the
    reference walks one more step of the capacity ladder (at LUBM-100 its
    expansion of the triangle q2 needs 2^31 rows)."""
    d, triples = lubm_like(2, 3, 3, 3, 2)
    q = lubm_queries(d)["q2"].make(0)
    j_eng = JEngine(triples, 4, probe_backend="searchsorted",
                    frequency_threshold=1, capacity=256)
    t_eng = AdHashEngine(triples, 4, frequency_threshold=1, capacity=256,
                         device="cpu")
    for _ in range(2):
        jrel, jst = j_eng.query(q)
        trel, tst = t_eng.query(_port(q))
    assert tst.mode == jst.mode == "parallel-replica"
    assert trel.to_set() == jrel.to_set()
    assert (tst.n_retries, jst.n_retries) == (0, 1)
    assert t_eng.pattern_index.fingerprint() == \
        j_eng.pattern_index.fingerprint()


def test_replica_stores_match_after_every_redistribution():
    """Each replica module, as each redistribution publishes it, equals the
    reference's module of the same id; the deferred barrier leaves the same
    accounting as the synchronous path."""
    j_eng, t_eng = _engines(4, frequency_threshold=2)
    seen = 0
    for q in _workload(11, 12):
        j_eng.query(q)
        t_eng.query(_port(q))
        if t_eng.report.n_redistributions != seen:
            seen = t_eng.report.n_redistributions
            assert t_eng.report.n_redistributions == \
                j_eng.report.n_redistributions
            assert (t_eng.report.ird_comm_cells, t_eng.report.ird_triples) \
                == (j_eng.report.ird_comm_cells, j_eng.report.ird_triples)
            for sid, st in j_eng.replicas.modules.items():
                _assert_stores_equal(st, t_eng.replicas.modules[sid], sid)
    assert seen >= 3
    # a hot pattern redistributed synchronously gives what the engine got
    hot = t_eng.heatmap.hot_patterns(2)[0]
    storage, st = t_eng.ird.redistribute(hot)
    assert st.n_edges == len(hot.query.patterns)
    assert set(storage) == set(range(len(hot.query.patterns)))


def test_budget_eviction_matches_reference():
    """A budget below one worker's replica load forces LRU evictions; the
    port evicts the same modules in the same order, and answers hold."""
    queries = _workload(99, 12)
    j_eng, t_eng = _engines(3, frequency_threshold=2, replication_budget=8)
    run_lockstep(j_eng, t_eng, queries)
    assert_adaptivity_equal(j_eng, t_eng)
    assert t_eng.report.n_evictions > 0
    assert int(t_eng.replicas.max_per_worker()) <= 8 or \
        t_eng._no_redistribute


def test_degraded_episode_matches_reference():
    """A dark shard: PI hits demote to the staged route with the same
    answers, IRD is suspended while the heat map keeps counting, and the
    first healthy query catches up — in lockstep with the reference."""
    adv = _DICT.lookup("ub:advisor")
    hot = JQuery([JTP(JVar("x"), JConst(adv), JVar("y"))], name="hot")
    j_eng, t_eng = _engines(4, frequency_threshold=2)
    assert isinstance(t_eng.health, HealthState)
    routes = [st.route for st in run_lockstep(j_eng, t_eng, [hot] * 3)]
    assert routes[-1] == "single-local"
    j_eng.health.mark_failed(2)
    t_eng.health.mark_failed(2)
    stats = run_lockstep(j_eng, t_eng, [hot] * 2)
    assert [st.route for st in stats] == ["single-degraded"] * 2
    assert t_eng.report.n_degraded == 2
    j_eng.health.mark_recovered(2)
    t_eng.health.mark_recovered(2)
    assert run_lockstep(j_eng, t_eng, [hot])[0].route == "single-local"

    # suspended IRD, then catch-up from the heat map on recovery
    j_eng, t_eng = _engines(4, frequency_threshold=2)
    j_eng.health.mark_failed(1)
    t_eng.health.mark_failed(1)
    run_lockstep(j_eng, t_eng, [hot] * 4)
    assert t_eng.report.n_redistributions == 0
    assert t_eng.report.n_degraded == 4
    j_eng.health.mark_recovered(1)
    t_eng.health.mark_recovered(1)
    run_lockstep(j_eng, t_eng, [hot] * 2)
    assert t_eng.report.n_redistributions == 1
    assert_adaptivity_equal(j_eng, t_eng)


def test_adaptivity_pause_defers_like_a_degraded_episode():
    """``adaptivity_paused`` suspends IRD without demoting any route; the
    first unpaused query catches up."""
    adv = _DICT.lookup("ub:advisor")
    hot = JQuery([JTP(JVar("x"), JConst(adv), JVar("y"))], name="hot")
    j_eng, t_eng = _engines(3, frequency_threshold=2)
    j_eng.adaptivity_paused = t_eng.adaptivity_paused = True
    run_lockstep(j_eng, t_eng, [hot] * 3)
    assert t_eng.report.n_redistributions == 0
    j_eng.adaptivity_paused = t_eng.adaptivity_paused = False
    run_lockstep(j_eng, t_eng, [hot] * 2)
    assert t_eng.report.n_redistributions == 1
    assert_adaptivity_equal(j_eng, t_eng)


def test_observe_replay_reproduces_fingerprint():
    """Feeding the workload through ``observe`` (no execution) leaves the
    heat map, pattern index and replica stores of a live run — and the
    reference's observe gives the same."""
    queries = _workload(3, 10)
    _, live = _engines(3, frequency_threshold=2)
    for q in queries:
        live.query(_port(q))
    j_rep, t_rep = _engines(3, frequency_threshold=2)
    for q in queries:
        j_rep.observe(q)
        t_rep.observe(_port(q))
    assert t_rep.pattern_index.fingerprint() == \
        live.pattern_index.fingerprint()
    assert t_rep.heatmap.to_state() == live.heatmap.to_state()
    assert t_rep.report.n_queries == 0
    for f in ("n_redistributions", "ird_comm_cells", "ird_triples"):
        assert getattr(t_rep.report, f) == getattr(live.report, f), f
    assert_adaptivity_equal(j_rep, t_rep)
    # a non-adaptive engine observes nothing
    na = AdHashEngine(_TRIPLES, 3, adaptive=False, device="cpu")
    na.observe(_port(queries[0]))
    assert na.heatmap.to_state() == HeatMap().to_state()


def test_health_state_transitions():
    hs = HealthState(4)
    assert not hs.degraded
    hs.mark_failed(3)
    assert hs.degraded and hs.failed == {3}
    with pytest.raises(ValueError):
        hs.mark_failed(4)

    class Monitor:
        def failed_workers(self, now=None):
            return [1, 9]

    assert hs.sync(Monitor()) is True
    assert hs.failed == {1}
    assert hs.sync(Monitor()) is False
    hs.mark_recovered(1)
    assert not hs.degraded
