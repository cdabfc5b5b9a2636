"""The port's mesh substrate across two processes, against the JAX package.

Two localhost processes join one gloo group through the port's launcher
(``repro_torch.launch.multihost.launch_localhost``, ``device="cpu"``); each
holds 4 of W = 8 workers (``DistributedSubstrate``), so every hash
exchange and reply route is a real ``all_to_all`` between the processes,
every broadcast an ``all_gather``.  One child run (torch only: it imports
neither jax nor ``repro``) drives the counterparts of the reference's
multi-device tests -- ``tests/test_multihost.py::
test_two_process_mesh_parity`` and ``tests/test_substrate_mesh.py``'s
``test_mesh8_directory_placement_parity``, ``test_mesh8_main_index_chain_
route``, ``test_mesh8_eviction_parity_and_buffer_release``, and
``tests/test_serving.py::test_mesh8_serving_acceptance`` -- and writes
what each leg observed to a pickle.  Each test below holds one leg,
bit for bit, to ``repro``'s single-device engine on the same seeds (same
data generator, the child's queries through ``Query.from_json``): stores,
answers, ``comm_cells``, ``ird_comm_cells``, modes, routes (the substrate
name aside), ``n_retries``, pattern-index fingerprints, replica stores,
placement snapshots and served ledgers.  For the reference's "zero
recompiles" the port reads "no new launch shape": the child records the
shape of every primitive call (the plain versions here) and a warm pass
must add none.

The launch and every process group have a timeout, so a rank that left
lockstep fails the test instead of hanging the suite.
"""
from __future__ import annotations

import dataclasses
import pickle
import textwrap

import numpy as np
import pytest

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro import serving as JS
from repro.core.engine import AdHashEngine as JEngine
from repro.core.placement import DirectoryPlacement as JDirectory
from repro.core.query import Query as JQuery
from repro.data.synthetic_rdf import Workload as JWorkload
from repro.data.synthetic_rdf import lubm_like as jlubm_like
from repro.runtime.fault_injection import VirtualClock as JClock
from repro_torch.launch.multihost import launch_localhost

from reference import match_query

_KW = dict(adaptive=True, frequency_threshold=2, capacity=256)
_REF = dict(probe_backend="searchsorted")

_CHILD = textwrap.dedent(
    r'''
    import dataclasses
    import gc
    import pickle
    import sys
    import tempfile
    import traceback
    import weakref
    from collections import Counter

    import numpy as np
    import torch

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core import backend as TB
    from repro_torch.core import relalg as TR
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.placement import DirectoryPlacement
    from repro_torch.core.query import Const, Query, TriplePattern, Var
    from repro_torch.core.substrate import (DistributedSubstrate,
                                            trace_collectives,
                                            trace_host_syncs)
    from repro_torch.data.synthetic_rdf import (Workload, lubm_like,
                                                lubm_queries)
    from repro_torch.runtime.fault_injection import VirtualClock
    from repro_torch.serving import (ServeConfig, ServedResult, ServeLoop,
                                     open_loop_arrivals, replay_open_loop)

    assert "jax" not in sys.modules and "repro" not in sys.modules
    sub = DistributedSubstrate(device="cpu")
    assert sub.name == "distributed" and sub.n_processes == 2
    assert sub.backend == "gloo"
    RANK = sub.process_id
    D, TRIPLES = lubm_like(2, 2, 2, 2)
    CHUNKS = [c for c in np.array_split(TRIPLES, 7) if len(c)]
    KW = dict(adaptive=True, frequency_threshold=2, capacity=256,
              device="cpu")

    # every primitive call's shape (on the CPU: the plain versions), the
    # counterpart of the reference's jit compile cache
    SHAPES = Counter()

    def _recording(mod, name):
        fn = getattr(mod, name)

        def rec(*args, **kw):
            SHAPES[(name,) + tuple(
                (tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a
                for a in args)] += 1
            return fn(*args, **kw)

        setattr(mod, name, rec)

    for mod, names in ((TB, ("range_search_plain", "span_search_plain")),
                       (TR, ("expand_plain", "unique_compact_plain",
                             "bucket_by_dest_plain"))):
        for name in names:
            _recording(mod, name)

    def rows(rel):
        return sorted(rel.to_set())

    def proj(rel, q):
        """The answer in the query's variable order (the oracle's)."""
        return sorted(set(map(tuple, rel.project_to(q.vars))))

    def stat(st):
        return (st.comm_cells, st.mode, st.route, st.n_retries)

    def answers(results):
        return [(rows(rel), stat(st)) for rel, st in results]

    def report(eng):
        r = eng.report
        return ({f.name: getattr(r, f.name) for f in dataclasses.fields(r)
                 if f.name not in ("wall_time_s", "history")},
                [h[:2] for h in r.history])

    def replicas(eng):
        return {sid: st.host_leaves()
                for sid, st in eng.replicas.modules.items()}

    def state(eng):
        return {"report": report(eng),
                "fingerprint": eng.pattern_index.fingerprint(),
                "per_worker": eng.replicas.per_worker_triples().tolist(),
                "replicas": replicas(eng),
                "load_balance": eng.load_balance()}

    def new_shapes(run):
        """Shapes ``run()`` adds to the census."""
        before = set(SHAPES)
        run()
        return sorted(map(str, set(SHAPES) - before))

    def leg_parity():
        blk = sub.local_worker_slice(8)
        assert (blk.start, blk.stop) == ((0, 4) if RANK == 0 else (4, 8))
        dist = AdHashEngine.ingest_stream(iter(CHUNKS), 8, substrate=sub,
                                          **KW)
        assert dist.store.spo_ps.shape[0] == 4  # a block, not all of W
        assert dist.store.n_workers == 8
        out = {"store": dist.store.host_leaves()}
        wl = Workload(D, seed=7)
        qs = wl.sample(4) * 2
        out["queries"] = [q.to_json() for q in qs]
        out["sequential"] = answers(dist.query(q) for q in qs)
        out["state"] = state(dist)
        dist2 = AdHashEngine.ingest_stream(
            iter(CHUNKS), 8, substrate=DistributedSubstrate(device="cpu"),
            **KW)
        out["batched"] = answers(dist2.query_batch(qs))
        out["batched_state"] = state(dist2)
        # no new launch shape on the warmed distributed engine
        warm = wl.sample(4)

        def work():
            for q in warm:
                dist.query(q)
            dist.query_batch(warm * 2)

        work()
        out["warm_new_shapes"] = new_shapes(work)
        # adaptivity checkpoint round trip, replicas over both ranks; each
        # process writes the whole snapshot into its own directory
        assert dist.replicas.modules, "IRD never populated the replicas"
        cm = CheckpointManager(tempfile.mkdtemp())
        cm.save_engine_state(dist, qs)
        cm.save_adaptivity(dist, step=1)
        fresh = AdHashEngine.ingest_stream(iter(CHUNKS), 8, substrate=sub,
                                           **KW)
        out["restore_offset"] = cm.restore_adaptivity(fresh)
        out["restored_fingerprint"] = fresh.pattern_index.fingerprint()
        out["fingerprint_after_warm"] = dist.pattern_index.fingerprint()
        out["restored_replicas"] = replicas(fresh)
        out["replicas_after_warm"] = replicas(dist)
        out["restored_blocks"] = [
            st.spo_ps.shape[0] for st in fresh.replicas.modules.values()]
        # the placement snapshot round-trips, and restores at W' = 16
        plc = DirectoryPlacement(8)
        hot = int(np.bincount(TRIPLES[:, 0]).argmax())
        assert plc.add_splits([hot])
        cm.save_placement(plc)
        out["placement"] = plc.fingerprint()
        out["placement_same"] = cm.load_placement(8).fingerprint()
        wider = cm.load_placement(16)
        out["placement_wider"] = (wider.w, sorted(wider.entries),
                                  wider.fingerprint())
        # a worker count the two ranks do not divide is rejected
        try:
            AdHashEngine(TRIPLES, 7, substrate=sub, **KW)
        except ValueError as e:
            out["rejected_7"] = str(e)
        return out

    def leg_directory():
        wl = Workload(D, seed=17)
        qs = wl.sample(5) * 2
        subjects = np.unique(TRIPLES[:, 0])
        plc = DirectoryPlacement(8)
        plc.add_splits(subjects[:5])
        mesh = AdHashEngine(TRIPLES, 8, placement=plc, substrate=sub, **KW)
        res = [mesh.query(q) for q in qs]
        out = {"queries": [q.to_json() for q in qs], "results": answers(res),
               "state": state(mesh),
               "projected": [proj(rel, q) for q, (rel, _) in zip(qs, res)]}
        # the table is an operand: same capacity class, new contents
        warm_qs = wl.sample(3)
        out["warm_queries"] = [q.to_json() for q in warm_qs]
        assert mesh.placement.add_splits(subjects[5:40])
        out["table_capacity"] = mesh.placement.table_capacity()
        out["settle"] = answers(mesh.query(q) for q in warm_qs)
        again = []
        out["warm_new_shapes"] = new_shapes(
            lambda: again.extend(mesh.query(q) for q in warm_qs))
        out["warm"] = answers(again)
        return out

    def leg_chain():
        qs = lubm_queries(D)
        star = qs["q1"].instantiate(np.random.default_rng(3))
        kw = dict(KW, frequency_threshold=100)
        eng = AdHashEngine(TRIPLES, 8, substrate=sub, **kw)
        dist = AdHashEngine(TRIPLES, 8, substrate=sub, local_chain=False,
                            **kw)
        out = {"star": star.to_json(), "chain": answers([eng.query(star)]),
               "staged": answers([dist.query(star)])}
        with trace_host_syncs() as tr, trace_collectives() as tc:
            warm = eng.query(star)
        out["warm"] = answers([warm])
        out["warm_host_syncs"] = tr.host_transfers
        out["warm_collectives"] = dict(tc.counts)
        # mixed workload: the chain route against its staged twin
        wl = Workload(D, seed=7)
        mixed = wl.sample(4) * 2
        a = AdHashEngine(TRIPLES, 8, substrate=sub, **KW)
        b = AdHashEngine(TRIPLES, 8, substrate=sub, local_chain=False, **KW)
        out["mixed_queries"] = [q.to_json() for q in mixed]
        out["mixed_a"] = answers(a.query(q) for q in mixed)
        out["mixed_b"] = answers(b.query(q) for q in mixed)
        out["mixed_fp"] = (a.pattern_index.fingerprint(),
                           b.pattern_index.fingerprint())
        a2 = AdHashEngine(TRIPLES, 8, substrate=sub, **KW)
        out["mixed_batch"] = answers(a2.query_batch(mixed))
        stars = [qs["q1"].instantiate(np.random.default_rng(i))
                 for i in range(6)]
        out["stars"] = [q.to_json() for q in stars]
        out["stars_batch"] = answers(a2.query_batch(stars))
        # a dark shard demotes the chain; recovery restores the route
        eng.health.mark_failed(2)
        out["degraded"] = answers([eng.query(star)])
        eng.health.mark_recovered(2)
        out["recovered"] = answers([eng.query(star)])
        # the retry ladder: a capacity class far below the star's size
        d3, t3 = lubm_like(6, 3, 4, 10)
        star3 = Query([
            TriplePattern(Var("x"), Const(d3.lookup("rdf:type")),
                          Const(d3.lookup("ub:Student"))),
            TriplePattern(Var("x"), Const(d3.lookup("ub:advisor")),
                          Var("y")),
        ])
        tiny = AdHashEngine(t3, 8, substrate=sub, adaptive=False,
                            capacity=64, device="cpu")
        plan3 = tiny.planner.plan(star3)
        run = lambda: tiny.executor.execute(star3, plan3.ordering,
                                            plan3.join_vars, capacity=64)
        out["ladder_query"] = star3.to_json()
        first = run()
        out["ladder"] = answers([first])
        out["ladder_projected"] = proj(first[0], star3)
        again = []
        out["ladder_new_shapes"] = new_shapes(lambda: again.append(run()))
        out["ladder_again"] = answers(again)
        return out

    def leg_eviction():
        qs = Workload(D, seed=11).sample(6) * 2
        out = {"queries": [q.to_json() for q in qs]}
        # the reference's budget, then one small enough to evict at W = 8
        for budget in (16, 64):
            mesh = AdHashEngine(TRIPLES, 8, substrate=sub,
                                **dict(KW, replication_budget=budget))
            out[budget] = {"results": answers(mesh.query_batch(qs)),
                           "state": state(mesh)}
        assert mesh.replicas.modules, "no live replica module"
        sid, st = next(iter(mesh.replicas.modules.items()))
        refs = [weakref.ref(x) for x in st.leaves()]
        while mesh.pattern_index.evict_lru_root() is not None:
            pass
        for s in list(mesh.replicas.modules):
            mesh.replicas.drop(s)
        del st
        gc.collect()
        out["released"] = all(r() is None for r in refs)
        return out

    NO_BROWNOUT = dict(brownout_enter=(9.0, 10.0), brownout_exit=(8.0, 9.0))

    def serve(eng, queries, rate, slo, svc=0.01, **cfg):
        loop = ServeLoop(eng, ServeConfig(slo_s=slo, batch_target=4,
                                          queue_bound=16, bucket_window=16,
                                          **cfg),
                         clock=VirtualClock(), service_model=lambda n: svc)
        arr = open_loop_arrivals(queries, rate_qps=rate, seed=21)
        done, rej = replay_open_loop(loop, arr)
        return loop, done, rej

    def ledger(loop, done, rej, queries):
        comp, projected = [], {}
        for c in done:
            if isinstance(c, ServedResult):
                comp.append(("served", c.rid, c.finished_s, c.latency_s,
                             c.late, rows(c.relation), stat(c.stats)))
                projected[c.rid] = proj(c.relation, queries[c.rid])
            else:
                comp.append((type(c).__name__, *dataclasses.astuple(c)))
        r = loop.report
        return {"completions": comp,
                "rejections": [dataclasses.astuple(v) for v in rej],
                "report": (dataclasses.asdict(r), r.p50_s, r.p99_s,
                           r.shed_rate),
                "log": [q.to_json() for q in loop.query_log],
                "projected": projected}

    def leg_serving():
        wl = Workload(D, seed=21)
        qs = wl.sample(6) * 4
        mesh = AdHashEngine(TRIPLES, 8, substrate=sub, **KW)
        loop1, done1, rej1 = serve(mesh, qs, 150.0, 2.0, **NO_BROWNOUT)
        out = {"queries": [q.to_json() for q in qs],
               "parity": ledger(loop1, done1, rej1, qs)}
        twin = AdHashEngine(TRIPLES, 8, substrate=sub, **KW)
        out["twin"] = answers(twin.query_batch(loop1.query_log))
        out["fp"] = (mesh.pattern_index.fingerprint(),
                     twin.pattern_index.fingerprint())
        serve(mesh, qs, 150.0, 2.0, **NO_BROWNOUT)
        third = []
        out["warm_new_shapes"] = new_shapes(lambda: third.append(
            serve(mesh, qs, 150.0, 2.0, **NO_BROWNOUT)))
        out["warm_answered"] = third[0][0].report.answered
        mesh2 = AdHashEngine(TRIPLES, 8, substrate=sub, **KW)
        qs2 = wl.sample(120)
        out["overload_queries"] = [q.to_json() for q in qs2]
        out["overload"] = ledger(*serve(mesh2, qs2, 400.0, 0.2, svc=0.02),
                                 qs2)
        return out

    legs = {}
    for name, fn in (("parity", leg_parity), ("directory", leg_directory),
                     ("chain", leg_chain), ("eviction", leg_eviction),
                     ("serving", leg_serving)):
        try:
            legs[name] = ("ok", fn())
        except Exception:
            legs[name] = ("error", traceback.format_exc())
        sub.barrier(name)
    if RANK == 0:
        with open(sys.argv[1], "wb") as f:
            pickle.dump(legs, f)
    print(f"MESH2-DONE rank {RANK}")
    '''
)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """One two-process run of every leg (torch only), its observations."""
    tmp = tmp_path_factory.mktemp("mesh2")
    script, out = tmp / "child.py", tmp / "legs.pkl"
    script.write_text(_CHILD)
    results = launch_localhost(
        2, [str(script), str(out)], device="cpu", timeout=300.0, retries=1,
        env={"OMP_NUM_THREADS": "2"})
    for r in results:
        assert r.ok, f"p{r.process_id} rc={r.returncode}\n{r.stderr[-4000:]}"
    with open(out, "rb") as f:
        return pickle.load(f)


def _leg(legs, name) -> dict:
    status, got = legs[name]
    assert status == "ok", got
    return got


def _jqueries(jsons) -> list:
    return [JQuery.from_json(s) for s in jsons]


def _suffix(route: str) -> str:
    """A route without its substrate name ("distributed-local" ->
    "local"): the two sides run different substrates."""
    return route.split("-", 1)[1] if route else route


def _answers(results) -> list:
    return [(sorted(rel.to_set()), (st.comm_cells, st.mode, st.route,
                                    st.n_retries)) for rel, st in results]


def _norm(answers) -> list:
    return [(rows, (c, m, _suffix(r), n)) for rows, (c, m, r, n) in answers]


def _assert_state(got: dict, j_eng) -> None:
    rep, hist = got["report"]
    for f, v in rep.items():
        assert v == getattr(j_eng.report, f), f
    assert hist == [h[:2] for h in j_eng.report.history]
    assert got["fingerprint"] == j_eng.pattern_index.fingerprint()
    assert got["per_worker"] == j_eng.replicas.per_worker_triples().tolist()
    assert got["load_balance"] == j_eng.load_balance()
    _assert_replicas(got["replicas"], j_eng)


def _assert_replicas(got: dict, j_eng) -> None:
    assert sorted(got) == sorted(j_eng.replicas.modules)
    for sid, st in j_eng.replicas.modules.items():
        for a, b in zip(got[sid], st.tree_flatten()[0]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=sid)


def test_two_process_mesh_parity(legs):
    """Host-sharded ingest, the adaptive lifecycle sequential and batched,
    no new launch shape once warm, an adaptivity checkpoint whose replicas
    span both ranks, a placement snapshot restored at W' = 16, and W = 7
    rejected -- all equal to the reference's single device."""
    got = _leg(legs, "parity")
    d, triples = jlubm_like(2, 2, 2, 2)
    ref = JEngine(triples, 8, **_KW, **_REF)
    for a, b in zip(got["store"], ref.store.tree_flatten()[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
    wl = JWorkload(d, seed=7)
    qs = wl.sample(4) * 2
    assert got["queries"] == [q.to_json() for q in qs]
    assert _norm(got["sequential"]) == _norm(_answers(
        ref.query(q) for q in qs))
    assert any(m == "parallel-replica" for _, (_, m, _, _) in
               got["sequential"])
    _assert_state(got["state"], ref)
    ref2 = JEngine(triples, 8, **_KW, **_REF)
    assert _norm(got["batched"]) == _norm(_answers(
        ref2.query(q) for q in qs))
    assert got["batched_state"]["fingerprint"] == \
        ref2.pattern_index.fingerprint()
    assert got["warm_new_shapes"] == []
    # the restored engine equals the saved one (warm queries included)
    assert got["restore_offset"] == len(qs)
    assert got["restored_fingerprint"] == got["fingerprint_after_warm"]
    assert got["restored_blocks"] and set(got["restored_blocks"]) == {4}
    for sid, leaves in got["replicas_after_warm"].items():
        for a, b in zip(got["restored_replicas"][sid], leaves):
            np.testing.assert_array_equal(a, b, err_msg=sid)
    warm = wl.sample(4)
    for _ in range(2):  # the child's warm-up and its census pass
        for q in warm:
            ref.query(q)
        ref.query_batch(warm * 2)
    assert got["fingerprint_after_warm"] == ref.pattern_index.fingerprint()
    _assert_replicas(got["replicas_after_warm"], ref)
    plc = JDirectory(8)
    assert plc.add_splits([int(np.bincount(triples[:, 0]).argmax())])
    assert got["placement"] == got["placement_same"] == plc.fingerprint()
    w, entries, _ = got["placement_wider"]
    assert w == 16 and entries == sorted(plc.entries)
    assert "divisible" in got["rejected_7"]


def test_mesh8_directory_placement_parity(legs):
    """A directory engine with seeded splits: answers, stats and state
    equal to the reference's single device and to the oracle; growing the
    table within its capacity class adds no launch shape once settled."""
    got = _leg(legs, "directory")
    d, triples = jlubm_like(2, 2, 2, 2)
    plc = JDirectory(8)
    plc.add_splits(np.unique(triples[:, 0])[:5])
    ref = JEngine(triples, 8, placement=plc, **_KW, **_REF)
    qs = _jqueries(got["queries"])
    assert _norm(got["results"]) == _norm(_answers(ref.query(q) for q in qs))
    _assert_state(got["state"], ref)
    for q, rows in zip(qs[:4], got["projected"]):
        assert set(rows) == match_query(triples, q), q.name
    assert got["table_capacity"] == 64
    warm = _jqueries(got["warm_queries"])
    assert ref.placement.add_splits(np.unique(triples[:, 0])[5:40])
    assert _norm(got["settle"]) == _norm(_answers(ref.query(q)
                                                  for q in warm))
    assert _norm(got["warm"]) == _norm(_answers(ref.query(q) for q in warm))
    assert got["warm_new_shapes"] == []


def test_mesh8_main_index_chain_route(legs):
    """Case-(i) chains over the main index: the fused route, one host sync
    and no stage collective per warm query, answers and stats equal to the
    staged twin and the reference; batched, degraded and the retry ladder
    too."""
    got = _leg(legs, "chain")
    d, triples = jlubm_like(2, 2, 2, 2)
    star = JQuery.from_json(got["star"])
    single = JEngine(triples, 8, **dict(_KW, frequency_threshold=100),
                     **_REF)
    ref = _answers([single.query(star)])
    [(rows, (cells, mode, route, _))] = got["chain"]
    assert route == "distributed-local-main" and mode == "parallel"
    assert cells == 0
    assert _norm(got["chain"]) == _norm(ref)
    assert got["staged"][0][0] == rows
    assert got["warm"][0][0] == rows
    assert got["warm_host_syncs"] == 1
    assert got["warm_collectives"] == {("all_reduce", "host"): 1}
    mixed = _jqueries(got["mixed_queries"])
    j = JEngine(triples, 8, **_KW, **_REF)
    want = _norm(_answers(j.query(q) for q in mixed))
    assert _norm(got["mixed_a"]) == want
    assert [(r, s[:2]) for r, s in got["mixed_b"]] == \
        [(r, s[:2]) for r, s in want]
    fa, fb = got["mixed_fp"]
    assert fa == fb == j.pattern_index.fingerprint()
    assert [(r, s[:2]) for r, s in got["mixed_batch"]] == \
        [(r, s[:2]) for r, s in want]
    assert any(s[2] == "distributed-local-main"
               for _, s in got["stars_batch"])
    stars = _jqueries(got["stars"])
    assert [r for r, _ in got["stars_batch"]] == \
        [sorted(j.query_batch(stars)[i][0].to_set())
         for i in range(len(stars))]
    assert got["degraded"][0][1][2] == "distributed-degraded"
    assert got["degraded"][0][0] == rows
    assert got["recovered"][0][1][2] == "distributed-local-main"
    assert got["recovered"][0][0] == rows
    d3, t3 = jlubm_like(6, 3, 4, 10)
    star3 = JQuery.from_json(got["ladder_query"])
    [(rows3, (_, _, route3, retries3))] = got["ladder"]
    assert route3 == "distributed-local-main" and retries3 > 0
    j3 = JEngine(t3, 8, adaptive=False, **_REF)
    rel3, _ = j3.query(star3)
    assert rows3 == sorted(rel3.to_set())
    assert set(got["ladder_projected"]) == set(
        map(tuple, rel3.project_to(star3.vars)))
    assert got["ladder_again"] == got["ladder"]
    assert got["ladder_new_shapes"] == []


def test_mesh8_eviction_parity_and_buffer_release(legs):
    """A budgeted workload through ``query_batch`` (the reference's budget
    of 64, and 16, which evicts at W = 8): evictions, the pattern index and
    every replica store equal to the reference's single device; dropping
    the modules frees their tensors."""
    got = _leg(legs, "eviction")
    d, triples = jlubm_like(2, 2, 2, 2)
    qs = _jqueries(got["queries"])
    for budget in (16, 64):
        ref = JEngine(triples, 8, **dict(_KW, replication_budget=budget),
                      **_REF)
        assert _norm(got[budget]["results"]) == _norm(_answers(
            ref.query_batch(qs)))
        _assert_state(got[budget]["state"], ref)
        if budget == 16:
            assert ref.report.n_evictions > 0
    assert got["released"]


def _ledger(loop, done, rej) -> dict:
    comp = []
    for c in done:
        if type(c).__name__ == "ServedResult":
            st = c.stats
            comp.append(("served", c.rid, c.finished_s, c.latency_s, c.late,
                         sorted(c.relation.to_set()),
                         (st.comm_cells, st.mode, st.route, st.n_retries)))
        else:
            comp.append((type(c).__name__, *dataclasses.astuple(c)))
    r = loop.report
    return {"completions": comp,
            "rejections": [dataclasses.astuple(v) for v in rej],
            "report": (dataclasses.asdict(r), r.p50_s, r.p99_s, r.shed_rate),
            "log": [q.to_json() for q in loop.query_log]}


def _norm_ledger(led: dict) -> dict:
    comp = [c[:6] + ((*c[6][:2], _suffix(c[6][2]), c[6][3]),)
            if c[0] == "served" else c for c in led["completions"]]
    return {k: v for k, v in led.items() if k != "projected"} | \
        {"completions": comp}


def _jserve(queries, rate, slo, svc=0.01, **cfg):
    d, triples = jlubm_like(2, 2, 2, 2)
    eng = JEngine(triples, 8, **_KW, **_REF)
    loop = JS.ServeLoop(eng, JS.ServeConfig(slo_s=slo, batch_target=4,
                                            queue_bound=16,
                                            bucket_window=16, **cfg),
                        clock=JClock(), service_model=lambda n: svc)
    arr = JS.open_loop_arrivals(queries, rate_qps=rate, seed=21)
    done, rej = JS.replay_open_loop(loop, arr)
    return _ledger(loop, done, rej)


def test_mesh8_serving_acceptance(legs):
    """The reference's mesh serving legs: a stream under saturation equals
    ``query_batch`` of its log on a twin; a warmed third stream adds no
    launch shape; at 2x overload the admitted p99 meets the SLO with some
    shed -- and each served ledger equals the reference's single device
    on the same schedule, field by field."""
    got = _leg(legs, "serving")
    d, triples = jlubm_like(2, 2, 2, 2)
    no_brownout = dict(brownout_enter=(9.0, 10.0), brownout_exit=(8.0, 9.0))
    qs = _jqueries(got["queries"])
    led = got["parity"]
    assert _norm_ledger(led) == _norm_ledger(
        _jserve(qs, 150.0, 2.0, **no_brownout))
    served = [c for c in led["completions"] if c[0] == "served"]
    assert len(served) == len(qs) and not led["rejections"]
    by_rid = {c[1]: c for c in served}
    order = [rid for rid, _ in sorted(
        ((i, t) for i, t in enumerate(
            JS.open_loop_arrivals(qs, rate_qps=150.0, seed=21))),
        key=lambda it: it[1].arrival_s)]
    for (rows, st), rid in zip(got["twin"], order):
        assert by_rid[rid][5] == rows and by_rid[rid][6][:2] == st[:2]
    assert got["fp"][0] == got["fp"][1]
    assert got["warm_new_shapes"] == [] and got["warm_answered"] == len(qs)
    over = got["overload"]
    qs2 = _jqueries(got["overload_queries"])
    assert _norm_ledger(over) == _norm_ledger(_jserve(qs2, 400.0, 0.2,
                                                      svc=0.02))
    rep, _, p99, shed_rate = over["report"]
    assert rep["shed"] > 0 and 0.0 < shed_rate < 1.0
    assert p99 <= 0.2 + 1e-9
    assert over["projected"]
    for rid, rows in over["projected"].items():
        assert set(rows) == match_query(triples, qs2[rid]), rid
