"""The program's own spans and counters in a traced run of a cell.

The port marks where it is with profiler ranges named ``adhash.<what>``
(``repro_torch.core.tracing``: the control pass and its parts, a bucket,
each stage attempt, each host sync) when its tracer is opened with
``ranges=True``, and counts lanes, padding and retries on its
``EngineReport``.  This module reads them:

``reduce(torch, prof)``
    ``trace.reduce_trace``'s keys, computed with the device-timeline copies
    of the ``adhash.*`` ranges left out (a range's copy covers its kernels
    and the gaps between them: not busy time), and three more: the idle
    seconds by the innermost and by the outermost ``adhash.*`` span the
    host was in at each gap's midpoint, and the device seconds by the
    innermost ``adhash.*`` span around each device event's launch (tied by
    correlation id, as ``kernel_s`` is).
``program_metrics(run, row_fill)``
    The per-layer numbers these give: idle shares under the outermost
    ``bucket`` and ``control`` spans, the finalize stage's device time a
    query, the stages' row fill, the share of padded lanes, retries a query.

Run as a script, it runs one cell once as ``run.py --trace 1`` does, with
the program's tracer open around the window (``--ranges 1``: its spans as
profiler ranges; ``--ranges 0``: the plain counter, as ``run.py``), its
counters read before and after, and two more notes on standard error:
``phase="bootstrap"`` (``AdHashEngine.startup_phases_s``) and
``phase="program_trace"`` (the span and stage tables and the numbers
above); the result line gains ``"program"`` with those numbers::

    python3 rdfbench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --ranges <0|1>

The harness itself opens no program range yet, so a run of ``run.py``
reads none of this.
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

__all__ = ["PREFIX", "REPORT_FIELDS", "reduce", "program_metrics",
           "installed", "main"]

PREFIX = "adhash."
#: the EngineReport counters the program's numbers read beside the harness's
REPORT_FIELDS = ("batch_lanes", "batch_pad_lanes", "n_retries")
OUTSIDE = "outside any span"


def _outermost(spans: list[tuple[int, int, str]], points: list[int]
               ) -> list[str | None]:
    """For each point, the name of the outermost span holding it (spans of
    one thread nest: the outermost are those no earlier span holds)."""
    top: list[tuple[int, int, str]] = []
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not top or s >= top[-1][1]:
            top.append((s, e, n))
    starts = [s for s, _, _ in top]
    out: list[str | None] = []
    for p in points:
        i = bisect.bisect_right(starts, p) - 1
        out.append(top[i][2] if i >= 0 and top[i][1] >= p else None)
    return out


def _events(events) -> SimpleNamespace:
    """A stand-in for a profiler session whose trace holds ``events``."""
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _seconds(ns_by_name: dict) -> dict[str, float]:
    return {(n[len(PREFIX):] if n else OUTSIDE): ns / 1e9
            for n, ns in sorted(ns_by_name.items(), key=lambda kv: -kv[1])}


def reduce(torch, prof, top: int = 10) -> dict:
    """``reduce_trace`` without the ``adhash.*`` ranges' device copies, and
    the idle and device seconds by program span (see the module's
    docstring)."""
    from rdfbench.trace import WINDOW, _innermost, _merge, reduce_trace

    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == cpu or not e.name().startswith(PREFIX)]
    out = reduce_trace(torch, _events(events), top)

    window = None
    spans: list[tuple[int, int, str]] = []
    launches: dict[int, int] = {}
    device = []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cpu:
            if name == WINDOW:
                window = (start, end)
            elif name.startswith(PREFIX):
                spans.append((start, end, name))
            elif e.correlation_id() > 0 and name.startswith("cu"):
                launches[e.correlation_id()] = start
        elif not name.startswith("rdfbench."):
            device.append((start, end, e.correlation_id(),
                           e.linked_correlation_id()))
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), c, lc) for s, e, c, lc in device
              if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, *_ in inside])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i] + edges[i + 1]) // 2, edges[i + 1] - edges[i])
                  for i in range(0, len(edges), 2)
                  if edges[i + 1] > edges[i])
    mids = [m for m, _ in gaps]
    for key, names in (("idle_by_program_span", _innermost(spans, mids)),
                       ("idle_by_outer_program_span",
                        _outermost(spans, mids))):
        idle: dict = defaultdict(int)
        for (_, length), n in zip(gaps, names):
            idle[n] += length
        out[key] = _seconds(idle)

    tied = sorted((t, e - s) for s, e, c, lc in inside
                  if (t := launches.get(c) or launches.get(lc)) is not None)
    by_span: dict = defaultdict(int)
    for (_, ns), n in zip(tied, _innermost(spans, [t for t, _ in tied])):
        by_span[n] += ns
    out["device_by_program_span"] = _seconds(by_span)
    out["program_spans"] = len(spans)
    return out


def program_metrics(run, row_fill: dict | None) -> dict:
    """The numbers the program's spans and counters give for one traced
    run (``harness.Run``), each None where the run has nothing to read;
    ``row_fill`` is ``HostSyncTrace.row_fill()`` of the window's tracer."""
    t, r = run.trace or {}, run.report
    spanned = t.get("program_spans", 0) > 0
    outer = t.get("idle_by_outer_program_span", {})
    device = t.get("device_by_program_span", {})
    window = t.get("window_s", 0.0)

    def share(num, den):
        return 100.0 * num / den if den else None

    live = sum(v[0] for v in (row_fill or {}).values())
    cap = sum(v[1] for v in (row_fill or {}).values())
    return {
        "executor_idle_share": share(outer.get("bucket", 0.0), window)
        if spanned else None,
        "control_idle_share": share(outer.get("control", 0.0), window)
        if spanned else None,
        "finalize_ms_per_query": (1e3 * device["stage.finalize"]
                                  / run.answered)
        if run.answered and "stage.finalize" in device else None,
        "row_fill_share": share(live, cap),
        "lane_pad_share": share(r.get("batch_pad_lanes", 0),
                                r.get("batch_lanes", 0)),
        "retries_per_query": r["n_retries"] / r["n_queries"]
        if r.get("n_queries") and "n_retries" in r else None,
    }


@contextmanager
def installed(ranges: bool, log=None):
    """While open, ``harness.execute`` runs a traced window with the
    program's tracer (``ranges`` as given), reduces the trace with
    ``reduce``, reads the program's counters, prints the ``bootstrap`` and
    ``program_trace`` notes to ``log`` and adds ``"program"`` to the result
    line.  Restores the harness on exit."""
    import json

    from rdfbench import harness
    from repro_torch.core import substrate, tracing

    log = log or sys.stderr
    opened: list = []  # the window's tracer
    startup: dict = {}

    class _Opened:
        """``trace_host_syncs()`` as the harness calls it, opened with
        ``ranges`` and kept for reading after the window."""

        def __init__(self):
            self._cm = tracing.trace_host_syncs(ranges=ranges)

        def __enter__(self):
            opened.append(self._cm.__enter__())
            return opened[-1]

        def __exit__(self, *exc):
            return self._cm.__exit__(*exc)

    clients_init = harness._Clients.__init__
    result = harness.result

    def clients(self, torch, cell, engine, *a, **k):
        startup.update(engine.startup_phases_s, total=engine.startup_time_s)
        clients_init(self, torch, cell, engine, *a, **k)

    def result_with_program(r, checks, dev, peak):
        out = result(r, checks, dev, peak)
        fill = opened[-1].row_fill() if opened else {}
        numbers = program_metrics(r, fill)
        t = r.trace or {}
        print(json.dumps({"phase": "bootstrap", "seconds": startup}),
              file=log)
        print(json.dumps({
            "phase": "program_trace", "ranges": int(ranges),
            "traced_queries_per_s": r.queries_per_s if r.answered else None,
            "host_syncs_per_query": (r.host_syncs / r.answered
                                     if r.answered else None),
            "report": r.report,
            "idle_by_span": t.get("idle_by_program_span"),
            "idle_by_outer_span": t.get("idle_by_outer_program_span"),
            "device_by_span": t.get("device_by_program_span"),
            "row_fill": {s: [live, cap, 100.0 * live / cap if cap else None]
                         for s, (live, cap) in fill.items()},
            "metrics": numbers}), file=log, flush=True)
        out["program"] = numbers
        return out

    saved = (substrate.trace_host_syncs, harness.reduce_trace,
             harness.REPORT_FIELDS, clients_init, result)
    substrate.trace_host_syncs = _Opened
    harness.reduce_trace = reduce
    harness.REPORT_FIELDS = harness.REPORT_FIELDS + REPORT_FIELDS
    harness._Clients.__init__ = clients
    harness.result = result_with_program
    try:
        yield
    finally:
        (substrate.trace_host_syncs, harness.reduce_trace,
         harness.REPORT_FIELDS, harness._Clients.__init__,
         harness.result) = saved


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--ranges", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    from rdfbench import run

    with installed(bool(args.ranges)):
        return run.main(["--workload", args.workload,
                         "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
