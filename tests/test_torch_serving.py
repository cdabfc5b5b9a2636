"""The port's online serving front-end against the JAX package's.

Two halves.  First, each single-device case of the reference's serving
tests (``tests/test_serving.py``: token buckets, admission, brownout
hysteresis, the batcher's forced pops, backpressure, per-client rate
limits, shedding, the deadline and age flushes, stream parity, brownout
deferral, 2x overload, the degraded one-timeline script, checkpoint
cadence, a crash mid-save and an unexecutable member) runs on the port
(``device="cpu"``) with the same seeds, rates and configs, answers held to
the brute-force oracle ``tests/reference.py``.

Second, cross-package parity: the reference's ``ServeLoop`` and the port's
serve the same stream (``Query.from_json`` of the reference's queries) on
the same ``open_loop_arrivals`` with a modelled service time, and every
observable must be equal, not only consistent: arrival times bit for bit,
every ``ServeReport`` field (latencies and brownout events included),
completions in order with their types and timestamps, rejections,
answers, modes, routes, ``comm_cells``, the query log as JSON, the
engine's report counters and the pattern-index fingerprint.  A snapshot
written by either package's loop restores under the other's
``recover_master``.  Times here are virtual, so nothing has a tolerance.
"""
from __future__ import annotations

import dataclasses

import pytest

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro import serving as JS
from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.core.engine import AdHashEngine as JEngine
from repro.core.query import Query as JQuery
from repro.data.synthetic_rdf import Workload as JWorkload
from repro.runtime import fault_injection as JFI
from repro.runtime import fault_tolerance as JFT
from repro_torch import serving as TS
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.query import Query as TQuery
from repro_torch.data.synthetic_rdf import Workload, lubm_like
from repro_torch.runtime.fault_injection import (FaultInjector, VirtualClock,
                                                 crash_before_publish)
from repro_torch.runtime import fault_injection as TFI
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                 StragglerPolicy,
                                                 recover_master,
                                                 replay_query_log)
from repro_torch.serving import (AdmissionController, BrownoutController,
                                 Request, RetryAfter, ServeConfig,
                                 ServedResult, ServeLoop, SheddedResult,
                                 TokenBucket, open_loop_arrivals,
                                 replay_open_loop)

from reference import match_query

_DICT, _TRIPLES = lubm_like(n_universities=2, depts_per_univ=2,
                            profs_per_dept=2, students_per_prof=2)
_KW = dict(adaptive=True, frequency_threshold=2, capacity=256)
_T = dict(device="cpu")

# occupancy can never reach these: disables the brownout ladder so parity
# tests exercise the undeferred adaptivity path
_NO_BROWNOUT = dict(brownout_enter=(9.0, 10.0), brownout_exit=(8.0, 9.0))


def _engine(**over):
    return AdHashEngine(_TRIPLES, 3, **{**_KW, **_T, **over})


def _loop(eng, service_s=0.02, **cfg_over):
    return ServeLoop(eng, ServeConfig(**cfg_over), clock=VirtualClock(),
                     service_model=lambda n: service_s)


def _oracle(q) -> set:
    return match_query(_TRIPLES, JQuery.from_json(q.to_json()))


def _exact(c, q) -> bool:
    return set(map(tuple, c.relation.project_to(q.vars))) == _oracle(q)


def _served(done):
    return {c.rid: c for c in done if isinstance(c, (ServedResult,
                                                     JS.ServedResult))}


def _shed(done):
    return [c for c in done if isinstance(c, (SheddedResult,
                                              JS.SheddedResult))]


def _assert_ledger(loop, done, rejections, offered):
    r = loop.report
    assert r.offered == offered
    assert r.answered + r.shed + r.rejected + r.unexecutable == offered
    assert len(_served(done)) == r.answered
    assert len(_shed(done)) == r.shed + r.unexecutable
    assert len(rejections) == r.rejected
    # only answered requests entered the control pass / query log
    assert len(loop.query_log) == r.answered + r.unexecutable
    assert loop.in_flight() == 0


_COUNTERS = ("n_queries", "n_parallel", "n_parallel_replica",
             "n_distributed", "comm_cells", "n_redistributions",
             "ird_comm_cells", "ird_triples", "n_evictions")


def _assert_stream_parity(loop, arrivals, done, twin):
    """Served stream == offline query_batch of the admitted-and-answered
    subsequence, bit-identically."""
    offline = twin.query_batch(loop.query_log)
    served = _served(done)
    i = 0
    for req in sorted(arrivals, key=lambda r: r.arrival_s):
        if req.rid not in served:
            continue
        rel_off, st_off = offline[i]
        i += 1
        c = served[req.rid]
        assert c.relation.to_set() == rel_off.to_set(), req.rid
        assert c.relation.vars == rel_off.vars, req.rid
        assert c.stats.mode == st_off.mode, req.rid
        assert c.stats.comm_cells == st_off.comm_cells, req.rid
    assert i == len(offline)
    # adaptivity state, including LRU clocks (fingerprint covers last_ts)
    assert loop.engine.pattern_index.fingerprint() == \
        twin.pattern_index.fingerprint()
    for f in _COUNTERS:
        assert getattr(loop.engine.report, f) == getattr(twin.report, f), f


# ===================================================================== units
def test_token_bucket_refill_and_burst():
    tb = TokenBucket(rate_per_s=2.0, burst=4.0)
    for _ in range(4):
        assert tb.try_take(0.0) == 0.0
    # empty: one token refills in 0.5s, and a failed take costs nothing
    assert tb.try_take(0.0) == pytest.approx(0.5)
    assert tb.try_take(0.25) == pytest.approx(0.25)
    assert tb.try_take(0.5) == 0.0
    # long idle refills to burst, not beyond
    tb2 = TokenBucket(rate_per_s=2.0, burst=4.0)
    tb2.try_take(0.0)
    for _ in range(3):
        assert tb2.try_take(100.0) == 0.0
    assert tb2.try_take(100.0) == 0.0  # 4th of the restored burst
    assert tb2.try_take(100.0) > 0.0


def test_admission_bounds_and_tightening():
    ac = AdmissionController(queue_bound=8)
    req = Request(0, None)
    assert ac.admit(req, 0.0, 7, 0, False, 100.0) is None
    v = ac.admit(req, 0.0, 8, 0, False, 100.0)
    assert v is not None and v.reason == "queue_full"
    assert v.retry_after_s > 0.0
    # deeper backlog -> longer retry hint
    v2 = ac.admit(req, 0.0, 20, 0, False, 100.0)
    assert v2.retry_after_s > v.retry_after_s
    # degraded tightening halves the bound and names the cause
    assert ac.admit(req, 0.0, 3, 0, True, 100.0) is None
    v = ac.admit(req, 0.0, 4, 0, True, 100.0)
    assert v is not None and v.reason == "degraded"
    # brownout rung 2 tightens too
    v = ac.admit(req, 0.0, 4, 2, False, 100.0)
    assert v is not None and v.reason == "brownout"
    # both: bound 8 * 0.5 * 0.5 = 2
    assert ac.admit(req, 0.0, 1, 2, True, 100.0) is None
    assert ac.admit(req, 0.0, 2, 2, True, 100.0) is not None
    # a fully-loaded queue is queue_full regardless of tightening
    v = ac.admit(req, 0.0, 9, 2, True, 100.0)
    assert v.reason == "queue_full"


def test_admission_rate_limit_per_client():
    ac = AdmissionController(queue_bound=100, client_rate_per_s=1.0,
                             client_burst=2.0)
    hot = [ac.admit(Request(i, None, client="hot"), 0.0, 0, 0, False, 10.0)
           for i in range(5)]
    assert [v is None for v in hot] == [True, True, False, False, False]
    assert all(v.reason == "rate_limited" and v.retry_after_s > 0
               for v in hot if v is not None)
    # an independent client is unaffected by the hot one's empty bucket
    assert ac.admit(Request(9, None, client="cold"), 0.0, 0, 0, False,
                    10.0) is None
    # the hot client recovers after its refill time
    assert ac.admit(Request(10, None, client="hot"), 2.0, 0, 0, False,
                    10.0) is None


def test_brownout_hysteresis():
    bc = BrownoutController(enter=(0.5, 0.85), exit=(0.25, 0.6))
    assert not bc.update(0.4) and bc.level == 0
    assert bc.update(0.5) and bc.level == 1
    assert not bc.update(0.55)
    assert bc.update(0.9) and bc.level == 2
    assert not bc.update(0.7)          # above exit[1]: stays browned out
    assert bc.update(0.5) and bc.level == 1
    assert not bc.update(0.3)          # above exit[0]: stays at 1
    assert bc.update(0.2) and bc.level == 0
    assert BrownoutController().update(0.95)  # straight 0 -> 2
    with pytest.raises(ValueError, match="exit < enter"):
        BrownoutController(enter=(0.5, 0.8), exit=(0.5, 0.6))


def test_pop_bucket_force_and_pop_by_plan():
    from repro_torch.core.batcher import WorkloadBatcher

    eng = _engine(adaptive=False)
    b = WorkloadBatcher()
    q = Workload(_DICT, mix={"q1": 1.0}, seed=0).sample(1)[0]
    plan_obj = eng.planner.plan(q)
    plan = b.add(0, q, plan_obj.ordering, plan_obj.join_vars)
    assert b.pop_bucket() is None            # singleton: min_size=2 skips it
    forced = b.pop_bucket(force=True)        # the serving starvation fix
    assert forced is not None and len(forced) == 1
    assert len(b) == 0
    plan2 = b.add(1, q, plan_obj.ordering, plan_obj.join_vars)
    assert b.pop(plan2) is not None          # pop exactly this shape
    assert b.pop(plan) is None               # already gone


# ============================================================ serving basics
def test_backpressure_bounded_queue():
    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=1.0, queue_bound=8, slo_s=100.0,
                 **_NO_BROWNOUT)
    qs = Workload(_DICT, seed=1).sample(30)
    verdicts = [loop.offer(Request(i, q)) for i, q in enumerate(qs)]
    admitted = [v for v in verdicts if v is None]
    rejected = [v for v in verdicts if v is not None]
    assert len(admitted) == 8 and len(rejected) == 22
    assert all(isinstance(v, RetryAfter) and v.reason == "queue_full"
               and v.retry_after_s > 0 for v in rejected)
    assert loop.in_flight() == 8
    assert loop.report.rejected_queue_full == 22
    done = loop.drain()
    assert len(_served(done)) == 8   # generous SLO: all admitted answered


def test_rate_limited_client_cannot_starve_others():
    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=0.01, queue_bound=64, slo_s=10.0,
                 client_rate_per_s=2.0, client_burst=2.0, **_NO_BROWNOUT)
    qs = Workload(_DICT, seed=2).sample(12)
    # 10 hot offers and 2 cold offers, all at t=0
    verdicts = [loop.offer(Request(i, q, client="hot" if i < 10 else "cold"))
                for i, q in enumerate(qs)]
    assert sum(v is None for v in verdicts[:10]) == 2   # burst only
    assert all(v.reason == "rate_limited" for v in verdicts[:10]
               if v is not None)
    assert all(v is None for v in verdicts[10:])        # cold unaffected
    assert loop.report.rejected_rate_limited == 8
    loop.drain()


def test_shed_requests_are_never_answered():
    eng = _engine()
    loop = _loop(eng, service_s=0.05, slo_s=0.08, batch_target=1,
                 queue_bound=64, **_NO_BROWNOUT)
    qs = Workload(_DICT, seed=3).sample(40)
    arr = open_loop_arrivals(qs, rate_qps=100.0, seed=3)
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 40)
    r = loop.report
    assert r.shed > 0, "overloaded stream shed nothing"
    assert r.answered > 0
    served_rids = set(_served(done))
    shed_rids = {c.rid for c in _shed(done)}
    assert served_rids.isdisjoint(shed_rids)
    assert all(c.reason == "deadline" for c in _shed(done))
    # shed requests never touched adaptivity: the engine's state equals an
    # offline replay of only the answered subsequence
    _assert_stream_parity(loop, arr, done, _engine())


def test_unique_shape_request_does_not_starve():
    """A singleton bucket under live traffic is flushed by the deadline
    forcing path and completes within its SLO."""
    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=0.01, slo_s=0.3, batch_target=8,
                 queue_bound=64, **_NO_BROWNOUT)
    common = Workload(_DICT, mix={"q1": 1.0}, seed=4).sample(30)
    unique = Workload(_DICT, mix={"q2": 1.0}, seed=4).sample(1)[0]
    # the unique shape arrives early; common traffic keeps flowing long past
    # its deadline, so only the deadline flush can save it
    arr = open_loop_arrivals(common, rate_qps=30.0, start_s=0.05, seed=4)
    arr.append(Request(rid=999, query=unique, arrival_s=0.0))
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 31)
    c = _served(done).get(999)
    assert c is not None, "unique-shape request starved"
    assert not c.late
    assert c.latency_s <= 0.3 + 1e-9
    assert loop.report.flush_deadline >= 1
    assert _exact(c, unique)


def test_age_flush_max_wait():
    """max_wait_s flushes a lonely bucket long before its deadline."""
    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=0.01, slo_s=10.0, batch_target=8,
                 max_wait_s=0.05, queue_bound=64, **_NO_BROWNOUT)
    q = Workload(_DICT, mix={"q1": 1.0}, seed=5).sample(1)[0]
    assert loop.offer(Request(0, q, arrival_s=0.0)) is None
    loop.pump()                      # bucketed, not yet due
    assert loop.report.answered == 0
    nxt = loop.next_due()
    assert nxt == pytest.approx(0.05)   # the age flush, not the deadline
    loop.clock.advance_to(nxt)
    done = loop.pump()
    assert len(_served(done)) == 1
    assert _served(done)[0].latency_s < 1.0


# ======================================================== parity + brownout
def test_stream_parity_bit_identical():
    """In the undeferred regime answers, stats and adaptivity state (PI
    fingerprint incl. LRU clocks) equal the offline query_batch of the
    admitted subsequence."""
    eng = _engine()
    loop = _loop(eng, service_s=0.005, slo_s=1.0, batch_target=4,
                 queue_bound=64, **_NO_BROWNOUT)
    qs = Workload(_DICT, seed=6).sample(80)
    arr = open_loop_arrivals(qs, rate_qps=150.0, seed=6)
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 80)
    assert loop.report.answered == 80   # below saturation: nothing lost
    _assert_stream_parity(loop, arr, done, _engine())


def test_brownout_defers_adaptivity_then_recovers():
    eng = _engine()
    loop = _loop(eng, service_s=0.02, slo_s=0.5, batch_target=4,
                 queue_bound=10, bucket_window=10)
    qs = Workload(_DICT, seed=7).sample(120)
    arr = open_loop_arrivals(qs, rate_qps=400.0, seed=7)
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 120)
    r = loop.report
    assert r.brownout_events, "overload never tripped the brownout ladder"
    assert r.adaptivity_deferrals > 0, "rung 1 never deferred adaptivity"
    assert r.rejected_brownout + r.rejected_queue_full > 0
    # the ladder unwinds once the stream drains
    assert loop.brownout.level == 0
    assert eng.adaptivity_paused is False
    # answers stay exact even when routing diverged from the offline twin
    for rid, c in _served(done).items():
        assert _exact(c, qs[rid]), rid
    # deferred IRD catches up on the next healthy query
    before = eng.report.n_redistributions
    replay_query_log(eng, loop.query_log[-10:])
    assert eng.report.n_redistributions >= before


def test_overload_2x_saturation_meets_slo():
    """Offered load at ~2x saturation: admitted p99 under the SLO, shed
    rate reported, answers exact."""
    eng = _engine()
    slo = 0.2
    loop = _loop(eng, service_s=0.02, slo_s=slo, batch_target=4,
                 queue_bound=16, bucket_window=16)
    qs = Workload(_DICT, seed=8).sample(300)
    # modeled saturation ~ batch_target / service = 200 qps; offer 2x
    arr = open_loop_arrivals(qs, rate_qps=400.0, seed=8)
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 300)
    r = loop.report
    assert r.answered > 0 and r.shed > 0 and r.rejected > 0
    assert 0.0 < r.shed_rate < 1.0
    assert r.p99_s <= slo + 1e-9, f"admitted p99 {r.p99_s:.3f} > SLO {slo}"
    assert r.late <= max(2, r.answered // 50), "too many late answers"
    for rid, c in _served(done).items():
        assert _exact(c, qs[rid]), rid
    # a rejected request never entered the control pass
    rejected_rids = {v.rid for v in rejections}
    assert rejected_rids.isdisjoint(set(_served(done)))
    assert len(loop.query_log) == r.answered


# ================================================== shared-timeline failures
def _degraded_script(eng, inj, mon, S, hot, oracle) -> list:
    """Arrivals, heartbeats, straggler reports and a worker kill scripted
    on ONE virtual clock shared by the fault injector and the serve loop,
    with either package's modules (``S`` its serving package); asserts the
    reference test's expectations and returns every event, in order."""
    loop = S.ServeLoop(
        eng,
        S.ServeConfig(slo_s=50.0, batch_target=2, queue_bound=4,
                      degraded_admit_factor=0.5, **_NO_BROWNOUT),
        clock=inj.clock, service_model=lambda n: 0.05, monitor=mon,
    )
    events = []

    def keep(done):
        events.extend(_key(c) for c in done)
        return _served(done)

    # -- healthy phase: index the hot query (threshold 2), then hit the PI
    done = []
    for i in range(4):
        inj.tick(0.5)
        assert loop.offer(S.Request(i, hot)) is None
        done += loop.pump()
    done += loop.drain()
    assert keep(done)[3].stats.route.endswith("-local")

    # -- kill worker 1; the loop's own health poll sees it via the monitor
    inj.kill(1)
    inj.tick(6.0)   # silence crosses the detector deadline
    assert eng.health.degraded

    # degraded admission: bound 4 -> 2, the third concurrent offer bounces
    verdicts = [loop.offer(S.Request(10 + i, hot)) for i in range(3)]
    events.extend(None if v is None else _key(v) for v in verdicts)
    assert verdicts[0] is None and verdicts[1] is None
    assert verdicts[2] is not None and verdicts[2].reason == "degraded"
    assert loop.report.rejected_degraded == 1
    served = keep(loop.drain())
    # PI hits demote to the distributed route while degraded, answers exact
    for rid in (10, 11):
        c = served[rid]
        assert c.stats.route.endswith("-degraded")
        assert set(map(tuple, c.relation.project_to(hot.vars))) == oracle

    # -- restart: the very next hit is shard-local again, full bound back
    inj.restart(1)
    assert not eng.health.degraded
    assert loop.offer(S.Request(20, hot)) is None
    served = keep(loop.drain())
    assert served[20].stats.route.endswith("-local")
    events.append(_report(loop.report))
    return events


def test_degraded_mesh_tightens_admission_one_timeline():
    eng = _engine()
    mon = HeartbeatMonitor(eng.w, timeout_s=5.0, now=0.0)
    inj = FaultInjector(eng, mon)
    hot = Workload(_DICT, mix={"q1": 1.0}, seed=9).sample(1)[0]
    _degraded_script(eng, inj, mon, TS, hot, _oracle(hot))

    # straggler classification on the same timeline: worker 1 is silent,
    # worker 2 reported before the deadline, worker 0 after it
    pol = StragglerPolicy(deadline_s=2.0)
    pol.register([0, 1, 2])
    step_start = inj.now
    reports = {0: step_start + 2.5, 2: step_start + 1.0}
    inj.tick(3.0)   # move past the step deadline
    st = pol.classify_at(reports, step_start, inj.now)
    assert st == {0: "straggler", 1: "straggler", 2: "ok"}


def test_classify_at_rejects_time_travel():
    pol = StragglerPolicy(deadline_s=2.0)
    with pytest.raises(ValueError, match="precedes"):
        pol.classify_at({}, step_start=5.0, now=4.0)


# ============================================================= checkpointing
def test_periodic_checkpoint_loses_at_most_one_interval(tmp_path):
    eng = _engine()
    mgr = CheckpointManager(tmp_path)
    loop = ServeLoop(
        eng, ServeConfig(slo_s=5.0, batch_target=4, queue_bound=64,
                         checkpoint_interval_s=0.5, **_NO_BROWNOUT),
        clock=VirtualClock(), service_model=lambda n: 0.05, checkpoint=mgr,
    )
    qs = Workload(_DICT, seed=10).sample(60)
    arr = open_loop_arrivals(qs, rate_qps=30.0, seed=10)
    done, rejections = replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rejections, 60)
    assert loop.report.checkpoint_saves >= 2
    assert loop.report.checkpoint_failures == 0

    persisted = mgr.load_query_log()
    assert 0 < len(persisted) <= len(loop.query_log)

    # recovery from the newest snapshot + persisted log ...
    rec = recover_master(mgr, _TRIPLES, eng.w, **_KW, **_T)
    twin = _engine()
    twin.query_batch(loop.query_log[:len(persisted)])
    assert rec.pattern_index.fingerprint() == \
        twin.pattern_index.fingerprint()
    # ... is at most the unpersisted suffix behind the live engine: replay
    # it and the states coincide exactly
    replay_query_log(rec, loop.query_log[len(persisted):])
    assert rec.pattern_index.fingerprint() == \
        eng.pattern_index.fingerprint()


def test_checkpoint_crash_mid_save_is_survived(tmp_path):
    eng = _engine()
    mgr = CheckpointManager(tmp_path)
    loop = ServeLoop(
        eng, ServeConfig(slo_s=5.0, checkpoint_interval_s=0.2,
                         **_NO_BROWNOUT),
        clock=VirtualClock(), service_model=lambda n: 0.01, checkpoint=mgr,
    )
    qs = Workload(_DICT, seed=11).sample(12)
    for i, q in enumerate(qs[:6]):
        loop.offer(Request(i, q))
    loop.pump()
    loop.clock.advance(0.3)
    loop.pump()   # first interval boundary: a good save
    assert loop.report.checkpoint_saves == 1
    recover_master(mgr, _TRIPLES, eng.w, **_KW, **_T)

    # crash the next save between temp-write and atomic publish
    for i, q in enumerate(qs[6:]):
        loop.offer(Request(6 + i, q))
    loop.pump()
    loop.clock.advance(0.3)
    with crash_before_publish():
        loop.pump()
    assert loop.report.checkpoint_failures == 1
    # the previous snapshot is intact: recovery still works
    rec2 = recover_master(mgr, _TRIPLES, eng.w, **_KW, **_T)
    assert rec2.pattern_index.fingerprint() is not None

    # the next interval retries and succeeds (no crash armed now)
    loop.clock.advance(0.3)
    loop.pump()
    assert loop.report.checkpoint_saves == 2
    loop.drain()


def test_unexecutable_member_is_reported_not_fatal():
    """An ExecutorError that survives the per-member sequential fallback
    resolves the bucket to SheddedResult(reason='unexecutable') instead of
    killing the loop."""
    from repro_torch.core.executor import ExecutorError

    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=0.01, slo_s=5.0, batch_target=8,
                 max_wait_s=0.0, **_NO_BROWNOUT)
    q = Workload(_DICT, seed=12).sample(1)[0]

    def boom(bucket, results):
        raise ExecutorError("injected")

    eng.execute_bucket = boom
    loop.offer(Request(0, q, arrival_s=0.0))
    done = loop.pump()
    assert [type(c) for c in done] == [SheddedResult]
    assert done[0].reason == "unexecutable"
    assert loop.report.unexecutable == 1
    assert loop.in_flight() == 0


@pytest.mark.parametrize("error", [RuntimeError, MemoryError])
def test_only_executor_errors_become_unexecutable(error):
    """Any other failure of a bucket (a failed kernel raises RuntimeError,
    the allocator an out-of-memory error) propagates out of the loop: it
    is never reported as shed traffic."""
    eng = _engine(adaptive=False)
    loop = _loop(eng, service_s=0.01, slo_s=5.0, batch_target=8,
                 max_wait_s=0.0, **_NO_BROWNOUT)
    q = Workload(_DICT, seed=12).sample(1)[0]

    def boom(bucket, results):
        raise error("injected")

    eng.execute_bucket = boom
    loop.offer(Request(0, q, arrival_s=0.0))
    with pytest.raises(error, match="injected"):
        loop.pump()
    assert loop.report.unexecutable == 0


def test_measured_mode_syncs_only_a_card_engine(monkeypatch):
    """Measured mode (no service model) charges the engine's wall seconds
    to the virtual clock and synchronizes the engine's device before each
    stop time only when that device is a card; in modelled mode, and on a
    CPU engine, the loop never synchronizes."""
    import types

    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append(a))
    eng = _engine()
    loop = ServeLoop(eng, ServeConfig(slo_s=1e6, batch_target=4,
                                      queue_bound=64, **_NO_BROWNOUT),
                     clock=VirtualClock())
    qs = Workload(_DICT, seed=6).sample(20)
    done, _ = replay_open_loop(loop, open_loop_arrivals(qs, 1e9, seed=6))
    assert loop.report.answered == 20 and loop.clock.now() > 0
    assert all(_exact(c, qs[rid]) for rid, c in _served(done).items())
    modelled = _loop(_engine(), service_s=0.01, slo_s=1.0, **_NO_BROWNOUT)
    replay_open_loop(modelled, open_loop_arrivals(qs, 150.0, seed=6))
    assert calls == []
    # the helper itself, on an engine whose device is a card
    card = types.SimpleNamespace(device=torch.device("cuda", 0))
    loop.engine = modelled.engine = card
    modelled._sync_measured()
    assert calls == []
    loop._sync_measured()
    assert calls == [(card.device,)]


# ================================================ parity against repro
_PKG = {
    "repro": dict(Engine=JEngine, S=JS, FI=JFI, FT=JFT, Manager=JManager,
                  kw=dict(probe_backend="searchsorted"), q=lambda q: q),
    "repro_torch": dict(Engine=AdHashEngine, S=TS, FI=TFI, FT=TFT,
                        Manager=CheckpointManager, kw=_T,
                        q=lambda q: TQuery.from_json(q.to_json())),
}

# the reference tests' stream configurations: (queries, seed, rate, modelled
# service seconds, ServeConfig)
_STREAMS = {
    "parity-150qps": (80, 6, 150.0, 0.005,
                      dict(slo_s=1.0, batch_target=4, queue_bound=64,
                           **_NO_BROWNOUT)),
    "brownout-400qps": (120, 7, 400.0, 0.02,
                        dict(slo_s=0.5, batch_target=4, queue_bound=10,
                             bucket_window=10)),
    "overload-2x": (300, 8, 400.0, 0.02,
                    dict(slo_s=0.2, batch_target=4, queue_bound=16,
                         bucket_window=16)),
    "checkpoint-cadence": (60, 10, 30.0, 0.05,
                           dict(slo_s=5.0, batch_target=4, queue_bound=64,
                                checkpoint_interval_s=0.5, **_NO_BROWNOUT)),
}


def _key(c) -> tuple:
    """Everything a completion or rejection says, as plain values."""
    name = type(c).__name__
    if name == "ServedResult":
        st = c.stats
        return (name, c.rid, c.finished_s, c.latency_s, c.late,
                c.relation.to_set(), tuple(v.name for v in c.relation.vars),
                st.mode, st.route, st.comm_cells, st.n_retries)
    return (name, *dataclasses.astuple(c))


def _report(r) -> tuple:
    return (dataclasses.asdict(r), r.rejected, r.admitted, r.shed_rate,
            r.p50_s, r.p99_s)


def _engine_state(eng) -> tuple:
    r = eng.report
    return (tuple(getattr(r, f) for f in _COUNTERS + (
        "n_degraded", "n_batch_dispatches", "n_rebalances")),
        [h[:2] for h in r.history], eng.pattern_index.fingerprint(),
        eng.heatmap.to_state(), eng.adaptivity_paused)


def _serve(pkg: str, stream: str, ckpt_dir=None):
    """One package's loop over one reference stream configuration."""
    P = _PKG[pkg]
    n, seed, rate, svc, cfg = _STREAMS[stream]
    eng = P["Engine"](_TRIPLES, 3, **_KW, **P["kw"])
    qs = [P["q"](q) for q in JWorkload(_DICT, seed=seed).sample(n)]
    S = P["S"]
    loop = S.ServeLoop(eng, S.ServeConfig(**cfg),
                       clock=P["FI"].VirtualClock(),
                       service_model=lambda _n: svc,
                       checkpoint=(None if ckpt_dir is None
                                   else P["Manager"](ckpt_dir)))
    arr = S.open_loop_arrivals(qs, rate_qps=rate, seed=seed)
    done, rej = S.replay_open_loop(loop, arr)
    _assert_ledger(loop, done, rej, n)
    return loop, arr, done, rej


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """The checkpoint-cadence stream served once by each package, each
    loop writing snapshots into a directory of its own."""
    out = {}
    for pkg in _PKG:
        d = tmp_path_factory.mktemp(f"serve-{pkg}")
        out[pkg] = (d, _serve(pkg, "checkpoint-cadence", d))
    return out


@pytest.mark.parametrize("stream", [*_STREAMS, "degraded-one-timeline"])
def test_served_stream_matches_reference(stream, checkpointed):
    """The two packages' loops give the same ledger, latencies, brownout
    events, completions (order, types, timestamps, answers, modes, routes,
    comm_cells), rejections, query log, engine counters and PI
    fingerprint on the same stream."""
    if stream == "degraded-one-timeline":
        sides = []
        for pkg, P in _PKG.items():
            eng = P["Engine"](_TRIPLES, 3, **_KW, **P["kw"])
            mon = P["FT"].HeartbeatMonitor(eng.w, timeout_s=5.0, now=0.0)
            inj = P["FI"].FaultInjector(eng, mon)
            hot = P["q"](JWorkload(_DICT, mix={"q1": 1.0},
                                   seed=9).sample(1)[0])
            sides.append((_degraded_script(eng, inj, mon, P["S"], hot,
                                           _oracle(hot)),
                          _engine_state(eng), inj.now))
        assert sides[0] == sides[1]
        return
    if stream == "checkpoint-cadence":
        (_, (jl, ja, jd, jr)), (_, (tl, ta, td, tr)) = \
            checkpointed["repro"], checkpointed["repro_torch"]
        assert tl.report.checkpoint_saves >= 2
    else:
        jl, ja, jd, jr = _serve("repro", stream)
        tl, ta, td, tr = _serve("repro_torch", stream)
    assert [(r.rid, r.arrival_s, r.deadline_s, r.client) for r in ta] == \
        [(r.rid, r.arrival_s, r.deadline_s, r.client) for r in ja]
    assert _report(tl.report) == _report(jl.report)
    assert [_key(c) for c in td] == [_key(c) for c in jd]
    assert [_key(v) for v in tr] == [_key(v) for v in jr]
    assert [q.to_json() for q in tl.query_log] == \
        [q.to_json() for q in jl.query_log]
    assert _engine_state(tl.engine) == _engine_state(jl.engine)
    assert tl.brownout.level == jl.brownout.level
    if stream == "brownout-400qps":
        assert tl.report.adaptivity_deferrals > 0
    if stream == "overload-2x":
        assert tl.report.shed > 0 and tl.report.rejected > 0


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_loop_snapshot_restores_in_other_package(writer, checkpointed):
    """A snapshot written by one package's serve loop restores under the
    other package's ``recover_master``: the recovered master equals a twin
    of the reader's package that ran the persisted log, and, after the
    unpersisted suffix, the live engine that wrote it."""
    ckpt_dir, (loop, _, _, _) = checkpointed[writer]
    reader = "repro_torch" if writer == "repro" else "repro"
    R = _PKG[reader]
    mgr = R["Manager"](ckpt_dir)
    persisted = mgr.load_query_log()
    assert 0 < len(persisted) <= len(loop.query_log)
    rec = R["FT"].recover_master(mgr, _TRIPLES, 3, **_KW, **R["kw"])
    twin = R["Engine"](_TRIPLES, 3, **_KW, **R["kw"])
    log = [R["q"](JQuery.from_json(q.to_json())) for q in loop.query_log]
    twin.query_batch(log[:len(persisted)])
    assert rec.pattern_index.fingerprint() == twin.pattern_index.fingerprint()
    assert rec.heatmap.to_state() == twin.heatmap.to_state()
    R["FT"].replay_query_log(rec, log[len(persisted):])
    assert rec.pattern_index.fingerprint() == \
        loop.engine.pattern_index.fingerprint()
    assert rec.heatmap.to_state() == loop.engine.heatmap.to_state()
