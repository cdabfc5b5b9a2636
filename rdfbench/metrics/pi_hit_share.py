"""Share of the window's queries answered from the replicas
(``parallel-replica``: the pattern index held their redistribution tree):
the delta of ``EngineReport.n_parallel_replica`` over ``n_queries``."""

LAYER = "adaptivity"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(run):
    n = run.report.get("n_queries", 0)
    if not n:
        return None
    return 100.0 * run.report["n_parallel_replica"] / n
