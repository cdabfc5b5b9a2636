"""Spans around the calls into each layer, and the reduction of a
``torch.profiler`` trace to the device's busy time, its idle gaps and the
device time of the port's kernels.

Spans are profiler ranges named ``rdfbench.<what>``, opened by the
benchmark's own wrappers around the program's entry points, only in a
traced run.  The reduction reads the profiler's raw events: device events
(kernels, copies, fills) give the busy intervals; each device event is
tied to the host call that launched it by the CUDA correlation id, and the
innermost ``rdfbench.kernel.*`` range around that call names the kernel it
counts for.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from contextlib import contextmanager, nullcontext

__all__ = ["Spans", "reduce_trace"]

WINDOW = "rdfbench.window"
KERNEL_PREFIX = "rdfbench.kernel."
#: a device operation's name is cut to this many characters in a breakdown
NAME_CHARS = 120


class Spans:
    """Opens profiler ranges when tracing, nothing otherwise."""

    def __init__(self, torch, on: bool):
        self.torch = torch
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return nullcontext()
        return self.torch.profiler.record_function(f"rdfbench.{name}")

    def wrap(self, obj, attr: str, name: str, before=None) -> None:
        """Replace ``obj.attr`` (a bound method) by one that runs inside
        the span ``name`` and first calls ``before(*args)`` if given."""
        fn = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            with self(name):
                return fn(*args, **kwargs)

        setattr(obj, attr, wrapped)


@contextmanager
def profiled(torch):
    """A CPU and CUDA profiler session."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans: list[tuple[int, int, str]], points: list[int]
               ) -> list[str | None]:
    """For each point (sorted), the name of the innermost span holding it;
    spans of one thread nest, so a stack sweep finds it."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out: list[str | None] = []
    stack: list[tuple[int, int, str]] = []
    i = 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce_trace(torch, prof, top: int = 10) -> dict:
    """Busy and window seconds, the device operations that took most time,
    the longest idle gaps by the span the host was in, and the device
    seconds of each port kernel, all inside the ``rdfbench.window`` range.
    """
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    window = None
    spans: list[tuple[int, int, str]] = []
    launches: dict[int, int] = {}  # correlation id -> host time of launch
    device = []
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == cpu:
            if name == WINDOW:
                window = (start, end)
            elif name.startswith("rdfbench."):
                spans.append((start, end, name))
            elif e.correlation_id() > 0 and name.startswith("cu"):
                launches[e.correlation_id()] = start
        elif not name.startswith("rdfbench."):
            # (a range's copy on the device timeline covers its kernels
            # and the gaps between them: not busy time)
            device.append((start, end, name, e.correlation_id(),
                           e.linked_correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no rdfbench.window range")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n, c, lc) for s, e, n, c, lc in device
              if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, *_ in inside])
    busy_ns = sum(e - s for s, e in busy)

    by_name: dict[str, int] = defaultdict(int)
    for s, e, n, *_ in inside:
        by_name[n] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    # idle gaps, named by the innermost span the host was in (the harness
    # calls the program from one thread, so its spans nest)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host_spans = [s for s in spans if not s[2].startswith(KERNEL_PREFIX)]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    names = _innermost(host_spans, [m for m, _ in mids])
    idle: dict[str, int] = defaultdict(int)
    for (_, length), n in zip(mids, names):
        idle[n[len("rdfbench."):] if n else "outside any span"] += length

    # device time of the port's kernels: each device event's launch, by
    # correlation id, inside a rdfbench.kernel.<k> range (they never nest)
    kernel_spans = sorted((s, e, n[len(KERNEL_PREFIX):])
                          for s, e, n in spans if n.startswith(KERNEL_PREFIX))
    starts = [s for s, _, _ in kernel_spans]
    kernel_ns: dict[str, int] = defaultdict(int)
    tied = 0
    for s, e, _n, c, lc in inside:
        t_launch = launches.get(c) or launches.get(lc)
        if t_launch is None:
            continue
        tied += 1
        i = bisect.bisect_right(starts, t_launch) - 1
        if i >= 0 and kernel_spans[i][1] >= t_launch:
            kernel_ns[kernel_spans[i][2]] += e - s
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n[:NAME_CHARS], ns / 1e9] for n, ns in device_ops],
        "idle_gaps": [[n, ns / 1e9] for n, ns in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        "kernel_s": {k: ns / 1e9 for k, ns in kernel_ns.items()},
        "device_events": len(inside),
        "device_events_tied_to_a_launch": tied,
    }
