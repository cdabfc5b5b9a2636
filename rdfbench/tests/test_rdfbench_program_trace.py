"""The reduction of a trace by the program's ``adhash.*`` spans, on a
kineto-like event list built here, and a traced CPU run of the closed
cell with the program's tracer open."""
import io
import json
import time
from types import SimpleNamespace

import pytest
import torch

from rdfbench import harness, program_trace
from rdfbench.program_trace import _outermost, reduce
from rdfbench.tests.tiny import tiny_cell
from rdfbench.trace import reduce_trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class _E:
    def __init__(self, name, start, end, device=CPU, corr=0):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._c = device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _kernel(name, launch, start, end, corr):
    return [_E("cudaLaunchKernel", launch, launch + 2, CPU, corr),
            _E(name, start, end, CUDA, corr)]


# the benchmark's window and spans, four kernels, one launched in
# rdfbench.kernel.expand's range
BASE = ([_E("rdfbench.window", 0, 1000),
         _E("rdfbench.query_batch", 50, 950),
         _E("rdfbench.kernel.expand", 505, 515)]
        + _kernel("k_control", 110, 120, 140, 1)
        + _kernel("k_bucket", 420, 450, 550, 2)
        + _kernel("expand_kernel", 510, 560, 600, 3)
        + _kernel("k_sync", 605, 640, 660, 4))
# the program's ranges on the host, and their copies on the device
# timeline, which cover their kernels and the gaps between them
PROGRAM = [_E("adhash.control", 100, 300), _E("adhash.plan", 150, 250),
           _E("adhash.bucket", 400, 900),
           _E("adhash.stage.finalize", 500, 700),
           _E("adhash.sync", 600, 700)]
COPIES = [_E("adhash.control", 120, 140, CUDA),
          _E("adhash.bucket", 450, 900, CUDA),
          _E("adhash.stage.finalize", 560, 700, CUDA)]


def test_program_ranges_leave_every_existing_key_as_it_was():
    want = reduce_trace(torch, _prof(BASE))
    got = reduce(torch, _prof(BASE + PROGRAM + COPIES))
    for key, value in want.items():
        assert got[key] == value, key
    # the reason for the filter: the copies would count as busy time
    assert reduce_trace(torch, _prof(BASE + PROGRAM + COPIES))["busy_s"] \
        > want["busy_s"]
    assert want["busy_s"] == pytest.approx((20 + 100 + 40 + 20) / 1e9)
    assert want["kernel_s"] == {"expand": pytest.approx(40 / 1e9)}


def test_gaps_and_device_time_go_to_the_right_program_span():
    got = reduce(torch, _prof(BASE + PROGRAM + COPIES))
    ns = 1e-9
    # gaps: [0,120) mid 60 outside; [140,450) mid 295 in control (plan
    # ended at 250); [550,560) mid 555 in finalize; [600,640) mid 620 in
    # sync inside finalize inside bucket; [660,1000) mid 830 in bucket
    assert got["idle_by_program_span"] == pytest.approx(
        {"outside any span": 120 * ns, "control": 310 * ns,
         "stage.finalize": 10 * ns, "sync": 40 * ns, "bucket": 340 * ns})
    assert got["idle_by_outer_program_span"] == pytest.approx(
        {"outside any span": 120 * ns, "control": 310 * ns,
         "bucket": 390 * ns})
    # device time by the innermost span at each launch
    assert got["device_by_program_span"] == pytest.approx(
        {"control": 20 * ns, "bucket": 100 * ns, "stage.finalize": 40 * ns,
         "sync": 20 * ns})
    assert got["program_spans"] == len(PROGRAM)


def test_outermost_span():
    spans = [(0, 100, "a"), (10, 20, "b"), (30, 60, "c"), (200, 300, "d"),
             (210, 220, "e")]
    assert _outermost(spans, [5, 15, 45, 100, 150, 215, 301]) == [
        "a", "a", "a", "a", None, "d", None]


@pytest.mark.parametrize("ranges", [False, True])
def test_a_traced_cpu_run_reads_the_program_numbers(ranges):
    log = io.StringIO()
    with program_trace.installed(ranges, log=log):
        out = harness.execute(tiny_cell("lubm100-w8-na.mix6-closed"),
                              2**31 + 5, 0.6, True, time.perf_counter(),
                              device="cpu", log=log)
    assert harness.result is not None and \
        harness.reduce_trace is reduce_trace
    assert out["correct"], out["checks"]
    notes = [json.loads(line) for line in log.getvalue().splitlines()]
    phases = {n["phase"]: n for n in notes}
    boot = phases["bootstrap"]["seconds"]
    assert sum(v for k, v in boot.items() if k != "total") == \
        pytest.approx(boot["total"], rel=1e-9)
    prog = out["program"]
    assert prog["lane_pad_share"] == pytest.approx(
        out["metrics"]["pad_share"]["value"], abs=1e-9)
    assert prog["retries_per_query"] is not None
    assert phases["program_trace"]["host_syncs_per_query"] == \
        out["metrics"]["host_syncs_per_query"]["value"]
    if ranges:
        # no device here: the whole window is one gap, named by the span
        # at its midpoint
        outer = phases["program_trace"]["idle_by_outer_span"]
        assert len(outer) == 1
        assert sum(outer.values()) == pytest.approx(
            out["device"]["window_s"])
        assert prog["executor_idle_share"] + prog["control_idle_share"] \
            in (0.0, pytest.approx(100.0))
        assert 0 < prog["row_fill_share"] <= 100
        assert set(phases["program_trace"]["row_fill"]) <= {
            "match_first", "project", "exchange", "probe_reply", "finalize",
            "local_join", "local_chain"}
    else:
        assert prog["executor_idle_share"] is None
        assert prog["row_fill_share"] is None
