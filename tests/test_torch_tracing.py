"""The engine's tracer (``repro_torch.core.tracing``) on the CPU.

With no ranged trace the query path enters no profiler range and runs the
same tensor operations as under a plain ``trace_host_syncs``; with
``ranges=True`` the spans nest as documented (stages inside a bucket, syncs
inside stages, the control pass's parts inside ``adhash.control``, IRD and
eviction inside ``adhash.adapt``), the host-sync count is unchanged, and
the stage row sums stay within their buffers.  The report's lane, padding
and retry counters equal the formulas a client computes from outside: the
padded class of each dispatched bucket, and the sum of the answered
queries' ``QueryStats.n_retries``.  The serving loop's stamps split each
answered request's latency into ingress wait, bucket wait and service.
"""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import tracing
from repro_torch.core.batcher import quantize_batch
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.planner import Plan
from repro_torch.core.substrate import trace_host_syncs
from repro_torch.data.synthetic_rdf import Workload, lubm_like
from repro_torch.runtime.fault_injection import VirtualClock
from repro_torch.serving import (ServeConfig, ServedResult, ServeLoop,
                                 open_loop_arrivals, replay_open_loop)

_DICT, _TRIPLES = lubm_like(2, 2, 2, 2)
_QUERIES = Workload(_DICT, seed=3).sample(24)
STAGES = ("match_first", "project", "exchange", "probe_reply", "finalize",
          "local_join", "local_chain")


def _engine(**kw):
    kw = {"adaptive": False, "capacity": 128, **kw}
    return AdHashEngine(_TRIPLES, 4, device="cpu", **kw)


class _Recorder:
    """Stands in for ``torch.profiler.record_function``: records each
    range's name with the names of the ranges open around it."""

    def __init__(self):
        self.stack: list[str] = []
        self.seen: list[tuple[str, tuple[str, ...]]] = []

    def __call__(self, name):
        rec = self

        class _Range:
            def __enter__(self):
                rec.seen.append((name, tuple(rec.stack)))
                rec.stack.append(name)

            def __exit__(self, *exc):
                rec.stack.pop()
        return _Range()

    def names(self) -> set[str]:
        return {n for n, _ in self.seen}


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_no_ranged_trace_enters_no_range_and_adds_no_operation(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    runs = []
    for ctx in (None, trace_host_syncs):
        eng = _engine()
        with _CountOps() as ops:
            if ctx is None:
                eng.query_batch(_QUERIES)
            else:
                with ctx() as tr:
                    eng.query_batch(_QUERIES)
                assert tr.row_fill() == {}
        runs.append(ops.ops)
    assert rec.seen == []
    assert runs[0] == runs[1]
    # the shared no-op context, not a new object a call
    assert tracing.span("bucket") is tracing.span("stage.finalize")


def test_ranged_spans_nest_as_documented(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    eng = _engine()
    with trace_host_syncs(ranges=True) as tr:
        eng.query_batch(_QUERIES)
    names = rec.names()
    stages = {f"adhash.stage.{s}" for s in STAGES}
    assert {"adhash.control", "adhash.transform", "adhash.pi_match",
            "adhash.plan", "adhash.file", "adhash.bucket",
            "adhash.stage.consts", "adhash.sync"} <= names
    assert names & stages >= {"adhash.stage.match_first",
                              "adhash.stage.exchange",
                              "adhash.stage.probe_reply",
                              "adhash.stage.finalize"}
    for name, around in rec.seen:
        if name.startswith("adhash.stage."):
            assert "adhash.bucket" in around, name
            assert not set(around) & stages, (name, around)
        if name == "adhash.sync":
            # every sync inside a bucket, all but the cell fetch in a stage
            assert "adhash.bucket" in around
        if name in ("adhash.transform", "adhash.pi_match", "adhash.plan",
                    "adhash.file"):
            assert around[-1] == "adhash.control", (name, around)
        if name in ("adhash.control", "adhash.bucket"):
            assert around == (), (name, around)
    # every stage attempt with an overflow check syncs inside its span
    inner = [around[-1] for name, around in rec.seen if name == "adhash.sync"
             and around[-1] != "adhash.bucket"]
    assert set(inner) <= stages
    checked = [n for n, _ in rec.seen if n in stages
               and n != "adhash.stage.exchange"]
    assert len(inner) >= len(checked)
    fill = tr.row_fill()
    assert set(fill) <= set(STAGES) and fill
    assert all(0 < live <= cap for live, cap in fill.values())


@pytest.mark.parametrize("shape", [(4, 8, 512), (2, 1 << 16), (3, 5, 7)])
@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_live_rows_equal_the_sum_of_the_flags(shape, share):
    g = torch.Generator().manual_seed(sum(shape))
    valid = torch.rand(shape, generator=g) < share
    # whole, transposed, and a view whose storage starts off a word
    for v in (valid, valid.transpose(0, -1), valid.reshape(-1)[1:513]):
        live = tracing._live_rows(v)
        assert live.dtype == torch.int64 and live.item() == v.sum().item()


def test_host_sync_count_is_the_same_with_ranges_on():
    counts = []
    for ranges in (False, True):
        with trace_host_syncs(ranges=ranges) as tr:
            _engine().query_batch(_QUERIES)
        counts.append(tr.host_transfers)
    assert counts[0] == counts[1] > 0
    # an inner plain trace counts its own block and keeps the ranges on
    with trace_host_syncs(ranges=True) as outer:
        with trace_host_syncs() as inner:
            assert tracing.span("x") is not tracing.span("x")
            _engine().query_batch(_QUERIES)
        assert inner.host_transfers == counts[0]
    assert outer.host_transfers == 0
    assert tracing.span("x") is tracing.span("y")


def test_lane_and_retry_counters_equal_the_outside_formulas(monkeypatch):
    # a larger graph on two workers outgrows the first class, 64; the
    # planner's hint would lift the capacity over every result
    monkeypatch.setattr(Plan, "capacity_hint", lambda self: 64)
    d, triples = lubm_like(3, 2, 3, 4, 2)
    queries = Workload(d, seed=4).sample(24)
    eng = AdHashEngine(triples, 2, adaptive=False, capacity=64,
                       device="cpu")
    buckets = []
    inner = eng.execute_bucket

    def counting(bucket, results):
        b = len(bucket)
        buckets.append((b, quantize_batch(b) if b > 1 else 1))
        return inner(bucket, results)

    eng.execute_bucket = counting
    results = eng.query_batch(queries) + eng.query_batch(queries[:7])
    r = eng.report
    assert r.batch_lanes == sum(p for _, p in buckets)
    assert r.batch_pad_lanes == sum(p - b for b, p in buckets) > 0
    batched = r.n_retries
    assert batched == sum(st.n_retries for _, st in results) > 0
    # the sequential path sums them too
    single = [eng.query(q) for q in queries[:6]]
    assert r.n_retries == sum(st.n_retries for _, st in results + single)
    assert r.n_retries > batched


def test_adaptive_run_opens_the_ird_and_eviction_spans(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    eng = _engine(adaptive=True, frequency_threshold=2,
                  replication_budget=16)
    with trace_host_syncs(ranges=True):
        eng.query_batch(Workload(_DICT, seed=5).sample(12) * 2)
    assert eng.report.n_redistributions > 0
    seen = dict(rec.seen)
    for name in ("adhash.ird.enqueue", "adhash.ird.barrier", "adhash.evict"):
        assert seen[name][-2:] == ("adhash.control", "adhash.adapt"), name
    assert seen["adhash.rebalance"][-1] == "adhash.adapt"
    # a bucket evaluated while a redistribution runs nests in the control
    # pass that enqueued it; the others are top-level
    assert all(around in ((), ("adhash.control", "adhash.adapt"))
               for n, around in rec.seen if n == "adhash.bucket")


def test_served_latency_is_ingress_plus_bucket_wait_plus_service(
        monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(torch.profiler, "record_function", rec)
    loop = ServeLoop(_engine(adaptive=True, frequency_threshold=2),
                     ServeConfig(slo_s=5.0, batch_target=4, max_wait_s=0.05),
                     clock=VirtualClock(), service_model=lambda n: 0.01)
    qs = Workload(_DICT, seed=9).sample(40)
    with trace_host_syncs(ranges=True):
        done, _ = replay_open_loop(loop, open_loop_arrivals(qs, 200.0,
                                                            seed=9))
    served = [c for c in done if isinstance(c, ServedResult)]
    assert len(served) == loop.report.answered > 0
    arrival = {r.rid: r.arrival_s for r in open_loop_arrivals(qs, 200.0,
                                                              seed=9)}
    waited = 0.0
    for c in served:
        ingress = c.bucketed_s - arrival[c.rid]
        bucket = c.dispatched_s - c.bucketed_s
        service = c.finished_s - c.dispatched_s
        assert min(ingress, bucket, service) >= 0.0, c.rid
        assert ingress + bucket + service == pytest.approx(c.latency_s,
                                                           abs=1e-12)
        waited += bucket
    assert waited > 0.0
    names = rec.names()
    assert {"adhash.serve.control", "adhash.serve.dispatch"} <= names
    assert all(around[-1] == "adhash.serve.control" for n, around in rec.seen
               if n == "adhash.control")


def test_bootstrap_phases_add_up_to_the_startup_time():
    eng = _engine()
    phases = eng.startup_phases_s
    assert list(phases) == ["place", "chunk_stats", "sort", "copy", "stats",
                            "rest"]
    assert all(v >= 0.0 for v in phases.values())
    assert sum(phases.values()) == pytest.approx(eng.startup_time_s,
                                                 rel=1e-9)
