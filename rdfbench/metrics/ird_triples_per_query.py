"""Triples incremental redistribution indexed into replicas a query: the
window's delta of ``EngineReport.ird_triples`` over its queries (the
evictions of the window go to standard error beside it)."""

LAYER = "adaptivity"
UNIT = "triples/query"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(run):
    n = run.report.get("n_queries", 0)
    if not n:
        return None
    return run.report["ird_triples"] / n
