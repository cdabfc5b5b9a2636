"""How late the benchmark's load generator offered a request: the 95th
percentile over the window's requests of the time it was offered minus
the time it was due, on the host clock."""

from rdfbench.harness import percentile

LAYER = "load generator"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "latency_p95_ms"


def read(run):
    if not run.lags_s:
        return None
    return 1e3 * percentile(run.lags_s, 95)
