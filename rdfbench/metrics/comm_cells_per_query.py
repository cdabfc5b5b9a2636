"""int32 cells the DSJ stages exchanged between workers a query: the
window's delta of ``EngineReport.comm_cells`` (the sum of each answer's
``QueryStats.comm_cells``) over its queries."""

LAYER = "DSJ stages"
UNIT = "cells/query"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(run):
    n = run.report.get("n_queries", 0)
    if not n:
        return None
    return run.report["comm_cells"] / n
