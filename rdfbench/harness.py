"""One run of one cell: data from the seed, the engine's bootstrap, the
warm-up, the measured window, then the comparison with the reference.

The window drives the program's own entry points: ``AdHashEngine.
query_batch`` once a round in a closed loop, or ``ServeLoop.offer`` /
``pump`` / ``drain`` on the wall clock in an open loop.  Everything the
metrics read is gathered into a ``Run``; the per-layer readers in
``metrics/`` take their numbers from it.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import numpy as np

from rdfbench import check, gen
from rdfbench.bench import Cell, load_metric
from rdfbench.roofline import Census, bound_s
from rdfbench.trace import WINDOW, Spans, profiled, reduce_trace
from rdfbench.traffic import Stream

__all__ = ["Run", "execute", "compare", "holds", "result", "REPORT_FIELDS",
           "SERVE_FLUSHES"]

#: the EngineReport counters a run reads, before and after the window
REPORT_FIELDS = ("n_queries", "n_parallel", "n_parallel_replica",
                 "n_distributed", "comm_cells", "ird_comm_cells",
                 "ird_triples", "n_redistributions", "n_evictions",
                 "n_batch_dispatches")
SERVE_FLUSHES = ("full", "deadline", "pressure", "drain", "overlap")
#: rng streams of one seed (the generator's data takes stream 0)
TRAFFIC, WARM, SAMPLE = 1, 2, 3


@dataclass
class Run:
    """What one run measured; the per-layer readers' input."""

    cell: Cell
    traced: bool
    startup_time_s: float = 0.0
    setup_s: float = 0.0
    elapsed_s: float = 0.0  # the window, start to its last answer
    attempted: int = 0
    answered: int = 0
    failed: int = 0  # attempted and not answered
    errors: int = 0  # failed by the program: no answer and no shedding
    host_syncs: int = 0
    buckets: list = field(default_factory=list)  # (B, B_pad) a dispatch
    report: dict = field(default_factory=dict)   # EngineReport deltas
    serve: dict = field(default_factory=dict)    # ServeReport deltas
    latencies_s: list = field(default_factory=list)
    lags_s: list = field(default_factory=list)
    trace: dict | None = None
    launch_bytes_bound_s: float = 0.0  # the window's launches at the peak
    lost: int = 0  # requests due in the window that got no fate at all

    @property
    def queries_per_s(self) -> float:
        return self.answered / self.elapsed_s


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in 0..100) of every value."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def _report(engine) -> dict:
    return {f: getattr(engine.report, f) for f in REPORT_FIELDS}


def _serve(loop) -> dict:
    r = loop.report
    out = {f"flush_{f}": getattr(r, f"flush_{f}") for f in SERVE_FLUSHES}
    out.update(offered=r.offered, rejected=r.rejected, shed=r.shed,
               answered=r.answered, late=r.late,
               unexecutable=r.unexecutable)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _pad(b: int) -> int:
    from repro_torch.core.batcher import quantize_batch

    return quantize_batch(b) if b > 1 else 1


class _Clients:
    """The clients of the program under test: they send the traffic
    through its entry points, with the benchmark's counters and spans
    around them."""

    def __init__(self, torch, cell: Cell, engine, device, spans: Spans,
                 sampler: check.Sampler):
        self.torch = torch
        self.cell = cell
        self.engine = engine
        self.device = device
        self.spans = spans
        self.sampler = sampler
        self.buckets: list[tuple[int, int]] = []
        spans.wrap(engine, "execute_bucket", "execute_bucket",
                   before=lambda bucket, _results: self.buckets.append(
                       (len(bucket), _pad(len(bucket)))))
        spans.wrap(engine, "stream_control_step", "control")
        spans.wrap(engine.parallel_exec, "execute", "pattern_index_hit")
        spans.wrap(engine.ird, "redistribute_deferred", "ird")

    def sync(self) -> None:
        if self.device.type == "cuda":
            with self.spans("sync"):
                self.torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------- closed
    def closed_round(self, batch: list[dict], sample: bool) -> int:
        """One round: every client's query through one ``query_batch``;
        returns the number that failed."""
        from repro_torch.core.executor import ExecutorError
        from repro_torch.core.query import Query

        queries = [Query.from_json(d) for d in batch]
        try:
            with self.spans("query_batch"):
                results = self.engine.query_batch(queries)
        except ExecutorError:
            self.sync()
            return len(batch)
        if sample:
            # a query's lane: its place among the round's queries of its
            # template, as the batcher files them into a bucket
            evicted = self.engine.report.n_evictions > 0
            lanes: dict[str, int] = {}
            for d, (rel, st) in zip(batch, results):
                lane = lanes[d["name"]] = lanes.get(d["name"], -1) + 1
                self.sampler.offer((d["name"], st.mode, evicted, lane), d,
                                   lambda rel=rel: check.answer_of(rel))
        self.sync()
        return 0

    def closed(self, stream: Stream, seconds: float, run: Run) -> None:
        """Whole rounds until ``seconds`` have passed; the window ends at
        the last round's answer."""
        clients = int(self.cell.traffic["clients"])
        t0 = time.perf_counter()
        done = failed = 0
        while True:
            failed += self.closed_round(stream.take(clients), sample=True)
            done += clients
            if time.perf_counter() - t0 >= seconds:
                break
        run.elapsed_s = time.perf_counter() - t0
        run.attempted, run.failed = done, failed
        run.answered = done - failed
        run.errors = failed

    # --------------------------------------------------------------- open
    def open(self, loop, arrivals: list[tuple[float, dict, object]],
             run: Run | None) -> None:
        """Offer each arrival (due offset, query JSON, the program's query)
        when it is due on the wall clock, pump the loop between arrivals,
        drain it after the last."""
        from repro_torch.serving import Request, ServedResult

        n = len(arrivals)
        done_at = [None] * n
        answered = [False] * n
        lags = [0.0] * n

        def collect(results, t):
            # a request's lane: its place among the template's requests
            # that one pump or drain delivered
            lanes: dict[str, int] = {}
            for c in results:
                done_at[c.rid] = t
                if isinstance(c, ServedResult):
                    answered[c.rid] = True
                    if run is not None:
                        d = arrivals[c.rid][1]
                        lane = lanes[d["name"]] = lanes.get(d["name"], -1) + 1
                        self.sampler.offer(
                            (d["name"], c.stats.mode, "served", lane), d,
                            lambda rel=c.relation: check.answer_of(rel))

        t0 = time.monotonic()
        i = 0
        while i < n:
            now = time.monotonic()
            while i < n and t0 + arrivals[i][0] <= now:
                due = t0 + arrivals[i][0]
                lags[i] = time.monotonic() - due
                with self.spans("offer"):
                    verdict = loop.offer(Request(rid=i, query=arrivals[i][2],
                                                 arrival_s=due))
                if verdict is not None:
                    done_at[i] = time.monotonic()
                i += 1
            with self.spans("pump"):
                results = loop.pump()
            collect(results, time.monotonic())
            if i >= n:
                break
            target = t0 + arrivals[i][0]
            nxt = loop.next_due()
            if nxt is not None:
                target = min(target, nxt)
            wait = target - time.monotonic()
            if wait > 0:
                with self.spans("wait_for_arrival"):
                    time.sleep(wait)
        with self.spans("drain"):
            results = loop.drain()
        collect(results, time.monotonic())
        if run is None:
            return
        run.elapsed_s = time.monotonic() - t0
        run.attempted = n
        run.answered = sum(answered)
        run.failed = n - run.answered
        lat = [done_at[j] - (t0 + arrivals[j][0]) for j in range(n)
               if answered[j]]
        # a request never answered misses the SLO and sits above every
        # answered one: its latency is the slowest answer or the SLO, the
        # larger, plus its own time to its fate
        floor = max(lat + [float(self.cell.traffic["slo_s"])])
        run.latencies_s = [
            done_at[j] - (t0 + arrivals[j][0]) if answered[j]
            else floor + (done_at[j] - (t0 + arrivals[j][0])
                          if done_at[j] is not None else 0.0)
            for j in range(n)]
        run.lost = sum(1 for t in done_at if t is None)
        run.lags_s = lags


def _warm_shapes(clients: _Clients, stream: Stream, mix: dict,
                 largest: int) -> None:
    """Each template of the mix at each batch-size class up to
    ``largest``, so the window launches no shape set-up did not."""
    for name in mix["templates"]:
        tpl = stream.templates[name]
        for size in (1 << k for k in range(largest.bit_length())):
            batch = []
            for _ in range(size):
                const = (None if tpl.constants is None else
                         int(stream.rng.integers(*tpl.constants)))
                batch.append(tpl.instantiate(const))
            clients.closed_round(batch, sample=False)


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device: str = "cuda", log=sys.stderr) -> dict:
    """Run one cell once; returns the result line as a dict."""
    import torch

    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.substrate import trace_host_syncs

    def note(**kv):
        print(json.dumps(kv), file=log, flush=True)

    dev = torch.device(device)
    mix, cfg = cell.traffic, cell.config
    run = Run(cell, trace)
    generator = gen.load(cfg["generator"])
    t = time.perf_counter()
    triples, layout = generator.generate(cfg["params"], seed)
    templates = generator.templates(layout)
    note(phase="data", triples=len(triples), n_ids=layout.n_ids,
         generate_s=time.perf_counter() - t)

    census = Census()
    spans = Spans(torch, trace)
    sampler = check.Sampler(gen.rng(seed, SAMPLE))
    with census.installed(), _counting_builds() as builds:
        engine = AdHashEngine(triples, int(cfg["workers"]), device=dev,
                              **cfg["engine"])
        run.startup_time_s = engine.startup_time_s
        clients = _Clients(torch, cell, engine, dev, spans, sampler)
        main = Stream(mix, templates, gen.rng(seed, TRAFFIC))
        t = time.perf_counter()
        loop = _warm_up(clients, Stream(mix, templates, gen.rng(seed, WARM)))
        if loop is not None:
            arrivals = _with_queries(main.arrivals(seconds))
        clients.sync()
        note(phase="warmup", seconds=time.perf_counter() - t,
             buckets=len(clients.buckets), report=_report(engine))
        clients.buckets.clear()
        census.mark()
        builds_before = builds[0]
        report0 = _report(engine)
        serve0 = _serve(loop) if loop is not None else None
        gc.collect()
        gc.freeze()
        run.setup_s = time.perf_counter() - t_start
        census.annotate = trace
        with (profiled(torch) if trace else nullcontext()) as prof:
            with spans(WINDOW[len("rdfbench."):]), \
                    trace_host_syncs() as syncs:
                if loop is None:
                    clients.closed(main, seconds, run)
                else:
                    clients.open(loop, arrivals, run)
        gc.unfreeze()
        census.annotate = False
        run.host_syncs = syncs.host_transfers
        run.buckets = list(clients.buckets)
        run.report = _delta(_report(engine), report0)
        if loop is not None:
            run.serve = _delta(_serve(loop), serve0)
            run.errors = run.serve["unexecutable"]
        run.launch_bytes_bound_s = sum(
            bound_s(k) * c for k, c in census.counts.items())
        note(phase="window", elapsed_s=run.elapsed_s,
             attempted=run.attempted, answered=run.answered,
             failed=run.failed, launches=sum(census.counts.values()),
             report=run.report, serve=run.serve)
        note(phase="post_warmup", builds=builds[0] - builds_before,
             new_launch_keys=[list(map(str, k)) for k in census.new_keys()])
        if trace:
            t = time.perf_counter()
            run.trace = reduce_trace(torch, prof)
            del prof
            note(phase="trace", reduce_s=time.perf_counter() - t,
                 device_events=run.trace["device_events"],
                 tied_to_a_launch=run.trace["device_events_tied_to_a_launch"],
                 kernel_s=run.trace["kernel_s"])
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        # the program's state is freed before the reference runs; the
        # kept answers are copies
        kept = list(sampler.items())
        del clients, loop, engine, sampler
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    note(phase="card", name=(torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
         power_limit=_power_limit() if dev.type == "cuda" else None,
         memory_peak_bytes=peak)

    t = time.perf_counter()
    checks = compare(triples, layout, kept, run.lost, run.errors)
    note(phase="reference", seconds=time.perf_counter() - t,
         compared=checks["compared"]["value"])
    return result(run, checks, dev, peak)


def _warm_up(clients: _Clients, warm: Stream):
    """Set-up's share of the traffic, from its own stream: a non-adaptive
    engine runs each template at each batch-size class the window can
    reach; an adaptive one a prefix of its own traffic; an open loop also
    ``warmup_s`` of arrivals through the serving loop it returns."""
    from repro_torch.runtime.fault_injection import WallClock
    from repro_torch.serving import ServeConfig, ServeLoop

    mix = clients.cell.traffic
    adaptive = clients.cell.config["engine"].get("adaptive", True)
    if mix["loop"] == "closed":
        if not adaptive:
            _warm_shapes(clients, warm, mix, int(mix["max_per_round"]))
        n = int(mix["clients"])
        for _ in range(-(-int(mix.get("warmup_queries", 0)) // n)):
            clients.closed_round(warm.take(n), sample=False)
        return None
    _warm_shapes(clients, warm, mix, int(mix["batch_target"]))
    loop = ServeLoop(clients.engine, ServeConfig(
        slo_s=float(mix["slo_s"]), queue_bound=int(mix["queue_bound"]),
        batch_target=int(mix["batch_target"]),
        max_wait_s=mix.get("max_wait_s")), clock=WallClock())
    clients.open(loop, _with_queries(warm.arrivals(float(mix["warmup_s"]))),
                None)
    return loop


@contextmanager
def _counting_builds():
    """Counts the kernel library's builds while open."""
    from repro_torch.kernels import build

    calls = [0]
    original = build.build

    def counting(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    build.build = counting
    try:
        yield calls
    finally:
        build.build = original


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({type(e).__name__})"
    return out.stdout.strip()


def _with_queries(arrivals: list[tuple[float, dict]]) -> list[tuple]:
    from repro_torch.core.query import Query

    return [(due, d, Query.from_json(d)) for due, d in arrivals]


def compare(triples: np.ndarray, layout, kept: list, lost: int,
            failed: int) -> dict:
    """The reference's answer for each kept query (``(stratum, query JSON,
    check.answer_of(...))``) against the program's; each number compared
    with its limit."""
    from rdfbench.reference import TripleIndex, evaluate

    index = TripleIndex(triples)
    bits = max(int(layout.n_ids).bit_length(), 1)
    want: dict[str, tuple] = {}
    wrong = missing = extra = 0
    strata = set()
    for stratum, query, answer in kept:
        key = repr(query["patterns"])
        if key not in want:
            vars_, ref_rows = evaluate(index, query)
            want[key] = (vars_, check.canon(ref_rows, bits))
        vars_, ref = want[key]
        strata.add(stratum)
        if sorted(answer[0]) != vars_:  # an answer binding other variables
            wrong += 1
            continue
        got = check.canon_answer(answer, vars_, bits)
        m, e = check.diff_canon(got, ref, bits, packed=True)
        missing += m
        extra += e
        wrong += bool(m or e)
    return {"compared": {"value": len(kept)},
            "strata": {"value": len(strata)},
            "missing_rows": {"value": missing},
            "extra_rows": {"value": extra},
            "wrong_answers": {"value": wrong, "limit": 0},
            "failed_queries": {"value": failed, "limit": 0},
            "lost_requests": {"value": lost, "limit": 0}}


def holds(checks: dict) -> bool:
    """Every number within its limit, and something compared."""
    return checks["compared"]["value"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values() if "limit" in c)


def result(run: Run, checks: dict, dev, peak: int) -> dict:
    import torch

    cell = run.cell
    metrics: dict[str, dict] = {}
    if run.traced:
        for m in cell.per_layer:
            value = load_metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        values = {"setup_s": run.setup_s}
        if run.answered:
            values["queries_per_s"] = run.queries_per_s
        if run.latencies_s:
            values["latency_p95_ms"] = percentile(run.latencies_s, 95) * 1e3
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    correct = holds(checks)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out
