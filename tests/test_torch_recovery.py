"""The port's master recovery, checkpoints and fault handling against the
JAX package's.

Each case of the reference's recovery tests (``tests/test_recovery.py``:
replay drives rebalancing, the append-only query log, placement persist,
crash-mid-save of a training step and of an adaptivity snapshot,
``recover_master`` at the same W, elastic onto W' = 3, and pure replay) runs
the same calls on ``repro`` (``probe_backend="searchsorted"``) and on the
port (``device="cpu"``), and asserts that the two give the same result, not
only that each is consistent with itself.  Snapshots cross the packages in
both directions: written by one, restored by the other, the pattern index,
heat map and replica tensors are the writer's.  ``StragglerPolicy``,
``HeartbeatMonitor`` and ``run_with_failure`` give the reference's statuses,
weights, failure sets, routes and answers.  Integer outputs: nothing here
has a tolerance.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.core.engine import AdHashEngine as JEngine
from repro.core.query import Const as JConst
from repro.core.query import Query as JQuery
from repro.core.query import TriplePattern as JTP
from repro.core.query import Var as JVar
from repro.data.synthetic_rdf import Workload, lubm_like, zipf_skew, \
    zipf_workload
from repro.runtime import fault_injection as JFI
from repro.runtime import fault_tolerance as JFT
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.query import Query as TQuery
from repro_torch.kernels.tuning import tuned_table
from repro_torch.runtime import fault_injection as TFI
from repro_torch.runtime import fault_tolerance as TFT

_DICT, _TRIPLES = lubm_like(n_universities=2, depts_per_univ=2,
                            profs_per_dept=2, students_per_prof=2)
_KW = dict(adaptive=True, frequency_threshold=2, capacity=256)
_J = dict(probe_backend="searchsorted")
_T = dict(device="cpu")


def _port(q):
    return TQuery.from_json(q.to_json())


def _hot_query():
    adv = _DICT.lookup("ub:advisor")
    return JQuery([JTP(JVar("x"), JConst(adv), JVar("y"))], name="hot")


def _zipf_setup():
    triples = zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                        n_predicates=8, exponent=1.8, seed=0)
    qs = zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                       seed=1)
    kw = dict(frequency_threshold=3, capacity=256, skew_threshold=1.2)
    return triples, qs, kw


def _leaves(store):
    return (store.leaves() if hasattr(store, "leaves")
            else store.tree_flatten()[0])


def assert_same_master(a, b) -> None:
    """Two masters (either package) hold the same recoverable state:
    placement, pattern index, heat map, every replica module's five
    tensors and the next replica id."""
    assert a.placement.fingerprint() == b.placement.fingerprint()
    assert a.pattern_index.fingerprint() == b.pattern_index.fingerprint()
    assert a.pattern_index.to_state() == b.pattern_index.to_state()
    assert a.heatmap.to_state() == b.heatmap.to_state()
    assert a.replicas.next_id_n == b.replicas.next_id_n
    assert sorted(a.replicas.modules) == sorted(b.replicas.modules)
    for sid, st in a.replicas.modules.items():
        for x, y in zip(_leaves(st), _leaves(b.replicas.modules[sid])):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=sid)
    np.testing.assert_array_equal(a.replicas.per_worker_triples(),
                                  b.replicas.per_worker_triples())


def _next_query(a, b, q) -> None:
    """The same query on both masters: same route, mode and answer."""
    (r1, s1), (r2, s2) = a.query(q if isinstance(a, JEngine) else _port(q)), \
        b.query(q if isinstance(b, JEngine) else _port(q))
    assert (s1.route, s1.mode, s1.comm_cells) == \
        (s2.route, s2.mode, s2.comm_cells)
    assert r1.to_set() == r2.to_set()


@pytest.fixture(scope="module")
def zipf_masters():
    """The crashed master of the zipf cases, once in each package: 40
    queries under directory placement.  Tests recover from it and must not
    query it."""
    triples, qs, kw = _zipf_setup()
    j = JEngine(triples, 4, placement="directory", **_J, **kw)
    t = AdHashEngine(triples, 4, placement="directory", **_T, **kw)
    for q in qs:
        j.query(q)
        t.query(_port(q))
    assert t.report.n_rebalances == j.report.n_rebalances >= 1
    assert_same_master(j, t)
    return j, t


# ------------------------------------------- replay drives rebalancing
def test_replay_drives_rebalance_and_route_parity(zipf_masters):
    """Replaying the log through ``observe`` reproduces the splits, the
    rebalances and the pattern index, in the port as in the reference."""
    triples, qs, kw = _zipf_setup()
    j_live, t_live = zipf_masters
    j_rep = JEngine(triples, 4, placement="directory", **_J, **kw)
    t_rep = AdHashEngine(triples, 4, placement="directory", **_T, **kw)
    JFT.replay_query_log(j_rep, qs)
    TFT.replay_query_log(t_rep, [_port(q) for q in qs])
    assert t_rep.report.n_rebalances == j_rep.report.n_rebalances == \
        t_live.report.n_rebalances
    assert t_rep.report.rebalance_comm_cells == \
        j_rep.report.rebalance_comm_cells
    assert t_rep.placement.fingerprint() == t_live.placement.fingerprint()
    assert_same_master(j_rep, t_rep)
    for a, b in zip(_leaves(j_rep.store), _leaves(t_rep.store)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    _next_query(j_rep, t_rep, qs[0])


# ------------------------------------- append-only log and persistence
def test_query_log_append_only(tmp_path):
    """Saves append the new suffix; a shorter log raises "append-only";
    a restarted manager continues from the on-disk offset — and the port's
    log file is the reference's byte for byte."""
    qs = Workload(_DICT, seed=3).sample(6)
    j_eng = JEngine(_TRIPLES, 4, **_J, **_KW)
    t_eng = AdHashEngine(_TRIPLES, 4, **_T, **_KW)
    texts = {}
    for pkg, eng, Mgr, conv in (("j", j_eng, JManager, lambda q: q),
                                ("t", t_eng, CheckpointManager, _port)):
        d = tmp_path / pkg
        log = [conv(q) for q in qs]
        mgr = Mgr(d)
        mgr.save_engine_state(eng, log[:4])
        first = (d / "query_log.jsonl").read_text()
        assert len(first.splitlines()) == 4
        mgr.save_engine_state(eng, log)
        assert (d / "query_log.jsonl").read_text().startswith(first)
        mgr.save_engine_state(eng, log)  # a no-op, not a truncate
        assert len((d / "query_log.jsonl").read_text().splitlines()) == 6
        with pytest.raises(ValueError, match="append-only"):
            mgr.save_engine_state(eng, log[:2])
        mgr2 = Mgr(d)
        mgr2.save_engine_state(eng, log + log[:1])
        texts[pkg] = (d / "query_log.jsonl").read_text()
        assert [q.to_json() for q in mgr2.load_query_log()] == \
            [q.to_json() for q in qs + qs[:1]]
        assert (d / "placement.json").read_text() == \
            (tmp_path / "j" / "placement.json").read_text()
    assert texts["t"] == texts["j"]


def test_placement_persist_restore(tmp_path, zipf_masters):
    j_eng, t_eng = zipf_masters
    _, qs, _ = _zipf_setup()
    assert t_eng.placement.entries
    JManager(tmp_path / "j").save_engine_state(j_eng, qs)
    CheckpointManager(tmp_path / "t").save_engine_state(
        t_eng, [_port(q) for q in qs])
    for w in (4, 3):
        got = CheckpointManager(tmp_path / "t").load_placement(w)
        want = JManager(tmp_path / "j").load_placement(w)
        assert got.fingerprint() == want.fingerprint()
        assert got.w == w and set(got.entries) == set(t_eng.placement.entries)
    assert CheckpointManager(tmp_path / "t").load_placement(4).fingerprint() \
        == t_eng.placement.fingerprint()
    assert CheckpointManager(tmp_path / "none").load_placement(4) is None


# --------------------------------------------- crash-mid-save (atomicity)
def test_crash_mid_save_keeps_previous_training_step(tmp_path):
    """A save that dies between writing data and the atomic publish leaves
    ``restore_latest`` returning the previous intact step, for numpy and
    for tensor trees, in both packages; the port's files restore in the
    reference."""
    params = {"w": np.arange(4.0), "b": [np.ones(2), np.zeros(3)]}
    opt = {"m": np.zeros(4)}
    for pkg, Mgr, FI in (("j", JManager, JFI), ("t", CheckpointManager,
                                                  TFI)):
        mgr = Mgr(tmp_path / pkg)
        mgr.save(params, opt, step=1)
        with pytest.raises(FI.CheckpointCrash):
            with FI.crash_before_publish():
                mgr.save({"w": np.full(4, 9.0), "b": params["b"]}, opt,
                         step=2)
        p, _, step = mgr.restore_latest(params, opt)
        assert step == 1
        np.testing.assert_array_equal(p["w"], params["w"])
        np.testing.assert_array_equal(p["b"][1], params["b"][1])
    # the port's step restores in the reference and the other way round
    p, _, _ = JManager(tmp_path / "t").restore_latest(params, opt)
    np.testing.assert_array_equal(p["w"], params["w"])
    t_params = {"w": torch.arange(4.0, dtype=torch.bfloat16),
                "b": [torch.ones(2), torch.zeros(3, dtype=torch.int64)]}
    p, _, step = CheckpointManager(tmp_path / "j").restore_latest(
        t_params, {"m": torch.ones(4)}, device="cpu")
    assert step == 1 and p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], t_params["w"])
    mgr = CheckpointManager(tmp_path / "tt", async_save=True)
    mgr.save(t_params, {"m": torch.ones(4)}, step=5)
    mgr.wait()
    p, o, step = mgr.restore_latest(t_params, {"m": torch.zeros(4)})
    assert step == 5 and torch.equal(o["m"], torch.ones(4))
    assert p["b"][1].dtype == torch.int64


def test_crash_mid_save_keeps_previous_adaptivity_snapshot(tmp_path):
    hot = _hot_query()
    offsets = {}
    for pkg, Eng, kw, Mgr, FI, conv in (
            ("j", JEngine, _J, JManager, JFI, lambda q: q),
            ("t", AdHashEngine, _T, CheckpointManager, TFI, _port)):
        eng = Eng(_TRIPLES, 4, **kw, **_KW)
        for _ in range(3):
            eng.query(conv(hot))
        mgr = Mgr(tmp_path / pkg)
        mgr.save_engine_state(eng, [conv(hot)] * 3)
        mgr.save_adaptivity(eng, step=1)
        eng.query(conv(hot))
        with pytest.raises(FI.CheckpointCrash):
            with FI.crash_before_publish():
                mgr.save_adaptivity(eng, step=2)
        m = mgr.load_adaptivity()
        assert m is not None and m["step"] == 1
        fresh = Eng(_TRIPLES, 4, **kw, **_KW)
        offsets[pkg] = mgr.restore_adaptivity(fresh)
        m.pop("_dir"), m.pop("time")
        offsets[pkg + "_manifest"] = m
    assert offsets["t"] == offsets["j"] == 3
    jm, tm = offsets["j_manifest"], offsets["t_manifest"]
    # each package writes its own platform's table: the port's is keyed by
    # the CUDA kernels' tiles, the reference's by the Pallas block sizes
    assert tm.pop("tuned") == {"cpu": tuned_table("cpu")}
    assert set(jm.pop("tuned")) == {"cpu"}
    assert tm == jm  # the same manifest, key for key, but ``tuned``


# ------------------------------------ full adaptivity checkpoint + recovery
def test_recover_master_same_w_bit_identical(tmp_path, zipf_masters):
    """Snapshot + zero-suffix replay: the port's recovered master equals
    the crashed one and the reference's recovered master, and the next
    query takes the same route with the same answer."""
    triples, qs, kw = _zipf_setup()
    j_eng, t_eng = zipf_masters
    JManager(tmp_path / "j").save_engine_state(j_eng, qs)
    JManager(tmp_path / "j").save_adaptivity(j_eng, step=1)
    mgr = CheckpointManager(tmp_path / "t")
    mgr.save_engine_state(t_eng, [_port(q) for q in qs])
    mgr.save_adaptivity(t_eng, step=1)
    j_rec = JFT.recover_master(JManager(tmp_path / "j"), triples, 4, **_J,
                               **kw)
    t_rec = TFT.recover_master(CheckpointManager(tmp_path / "t"), triples, 4,
                               **_T, **kw)
    assert_same_master(t_rec, t_eng)
    assert_same_master(j_rec, t_rec)
    assert t_rec.report.n_redistributions == 0  # nothing replayed
    _next_query(j_rec, t_rec, qs[0])


def test_recover_master_elastic_replays_to_parity(tmp_path, zipf_masters):
    """Restore onto W' = 3: worker-indexed state is dropped, the whole log
    replays, and the recovered pattern index is the crashed master's —
    in the port as in the reference."""
    triples, qs, kw = _zipf_setup()
    j_eng, t_eng = zipf_masters
    fp = t_eng.pattern_index.fingerprint()
    JManager(tmp_path / "j").save_engine_state(j_eng, qs)
    JManager(tmp_path / "j").save_adaptivity(j_eng, step=1)
    mgr = CheckpointManager(tmp_path / "t")
    mgr.save_engine_state(t_eng, [_port(q) for q in qs])
    mgr.save_adaptivity(t_eng, step=1)
    j_rec = JFT.recover_master(JManager(tmp_path / "j"), triples, 3, **_J,
                               **kw)
    t_rec = TFT.recover_master(CheckpointManager(tmp_path / "t"), triples, 3,
                               **_T, **kw)
    assert t_rec.w == 3 and t_rec.placement.w == 3
    assert t_rec.pattern_index.fingerprint() == fp
    assert t_rec.report.n_redistributions == t_eng.report.n_redistributions
    assert t_rec.report.n_rebalances == j_rec.report.n_rebalances
    assert_same_master(j_rec, t_rec)
    for a, b in zip(_leaves(j_rec.store), _leaves(t_rec.store)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    _next_query(j_rec, t_rec, qs[0])
    assert t_rec.query(_port(qs[0]))[1].route == "single-local"


def test_recover_master_no_snapshot_pure_replay(tmp_path, zipf_masters):
    """With only the query log on disk, recovery replays everything."""
    triples, qs, kw = _zipf_setup()
    j_eng, t_eng = zipf_masters
    JManager(tmp_path / "j").save_engine_state(j_eng, qs)
    CheckpointManager(tmp_path / "t").save_engine_state(
        t_eng, [_port(q) for q in qs])
    j_rec = JFT.recover_master(JManager(tmp_path / "j"), triples, 4, **_J,
                               **kw)
    t_rec = TFT.recover_master(CheckpointManager(tmp_path / "t"), triples, 4,
                               **_T, **kw)
    assert t_rec.pattern_index.fingerprint() == \
        t_eng.pattern_index.fingerprint()
    assert t_rec.placement.fingerprint() == t_eng.placement.fingerprint()
    assert_same_master(j_rec, t_rec)
    assert t_rec.report.n_redistributions == j_rec.report.n_redistributions


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_snapshot_crosses_packages(tmp_path, zipf_masters, writer):
    """A snapshot written by one package restores in the other: the
    recovered master's pattern index, heat map, placement and replica
    tensors are the writer's, and its next query is the writer's."""
    triples, qs, kw = _zipf_setup()
    j_eng, t_eng = zipf_masters
    if writer == "repro":
        mgr = JManager(tmp_path)
        mgr.save_engine_state(j_eng, qs)
        mgr.save_adaptivity(j_eng, step=7)
        rec = TFT.recover_master(CheckpointManager(tmp_path), triples, 4,
                                 **_T, **kw)
        src = j_eng
    else:
        mgr = CheckpointManager(tmp_path)
        mgr.save_engine_state(t_eng, [_port(q) for q in qs])
        mgr.save_adaptivity(t_eng, step=7)
        # the tuned table in the loader's format, which the reference's
        # restore leaves unread as its own does
        table = tmp_path / "adaptivity0000000007" / "tuned" / "cpu.json"
        assert json.loads(table.read_text()) == {
            "platform": "cpu", "kernels": tuned_table("cpu")}
        rec = JFT.recover_master(JManager(tmp_path), triples, 4, **_J, **kw)
        src = t_eng
    assert_same_master(rec, src)
    assert rec.report.n_redistributions == 0
    twin = (JEngine(triples, 4, placement="directory", **_J, **kw)
            if writer == "repro" else
            AdHashEngine(triples, 4, placement="directory", **_T, **kw))
    TFT.replay_query_log(twin, [_port(q) for q in qs]) \
        if writer == "repro_torch" else JFT.replay_query_log(twin, qs)
    _next_query(rec, twin, qs[0])


# ---------------------------------------- stragglers, heartbeats, failures
def test_straggler_policy_matches_reference():
    """The same report sequence through both policies: statuses (silent
    pods past deadline, sticky eviction), weights and classify_at."""
    rng = np.random.default_rng(0)
    pols = [M.StragglerPolicy(deadline_s=1.0, max_consecutive_skips=2)
            for M in (JFT, TFT)]
    for p in pols:
        p.register(range(5))
    for step in range(12):
        times = {pod: float(t) for pod, t in enumerate(rng.random(5) * 1.6)
                 if rng.random() < 0.8}
        got, want = (p.classify(dict(times)) for p in pols[::-1])
        assert got == want
        assert pols[1].reweight(got) == pols[0].reweight(want)
        at = {pod: 10.0 * step + t for pod, t in times.items()}
        assert pols[1].classify_at(at, 10.0 * step, 10.0 * step + 1.2) == \
            pols[0].classify_at(at, 10.0 * step, 10.0 * step + 1.2)
    assert pols[1].evicted == pols[0].evicted and pols[1].evicted
    with pytest.raises(ValueError):
        pols[1].classify_at({}, 5.0, 4.0)


def test_heartbeat_monitor_matches_reference():
    mons = [M.HeartbeatMonitor(4, timeout_s=10.0, now=0.0)
            for M in (JFT, TFT)]
    for m in mons:
        m.beat(0, now=5.0)
        m.beat(1, now=5.0)
    for now in (5.0, 12.0, 20.0):
        assert mons[1].failed_workers(now=now) == \
            mons[0].failed_workers(now=now)
    for m in mons:
        m.register(2, now=20.0)
    assert mons[1].failed_workers(now=25.0) == \
        mons[0].failed_workers(now=25.0) == [0, 1, 3]
    assert mons[1].recovery_plan([3], 4) == mons[0].recovery_plan([3], 4)
    subs = np.arange(1000)
    np.testing.assert_array_equal(TFT.rehash_assignments(subs, 4, 6),
                                  JFT.rehash_assignments(subs, 4, 6))


def test_run_with_failure_matches_reference():
    """Kill worker 2 before query 3 and restart it before query 6, through
    the fault injector's virtual clock: the routes (healthy, degraded,
    recovered) and the answers are the reference's."""
    hot = _hot_query()
    j_eng = JEngine(_TRIPLES, 4, **_J, **_KW)
    t_eng = AdHashEngine(_TRIPLES, 4, **_T, **_KW)
    for _ in range(3):
        _next_query(j_eng, t_eng, hot)
    qs = [hot] * 8
    j_res, j_routes = JFI.run_with_failure(j_eng, qs, kill_at=3, worker=2,
                                           recover_at=6)
    t_res, t_routes = TFI.run_with_failure(t_eng, [_port(q) for q in qs],
                                           kill_at=3, worker=2, recover_at=6)
    assert t_routes == j_routes
    assert t_routes[3:6] == ["single-degraded"] * 3
    assert [r.to_set() for r in t_res] == [r.to_set() for r in j_res]
    assert t_eng.report.n_degraded == j_eng.report.n_degraded == 3


def test_fault_injector_and_clocks():
    eng = AdHashEngine(_TRIPLES, 4, **_T, **_KW)
    mon = TFT.HeartbeatMonitor(4, timeout_s=5.0, now=0.0)
    inj = TFI.FaultInjector(eng, mon)
    assert not inj.tick(1.0)  # all beating, no change
    inj.kill(2)
    assert inj.tick(11.0)  # silence crossed the deadline
    assert eng.health.failed == {2} and inj.now == 12.0
    inj.restart(2)
    assert not eng.health.degraded and not inj.sync()
    clock = TFI.VirtualClock()
    assert (clock.advance(2.5), clock.advance_to(1.0),
            clock.advance_to(4.0)) == (2.5, 2.5, 4.0)
    with pytest.raises(ValueError):
        clock.advance(-1.0)
    wall = TFI.WallClock()
    assert wall.advance(5.0) <= wall.now()
