"""Device-to-host transfers a query in the window: the program's
``trace_host_syncs`` counter (overflow totals, result and accounting
fetches) over the queries answered."""

LAYER = "planner and executor"
UNIT = "syncs/query"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(run):
    if not run.answered:
        return None
    return run.host_syncs / run.answered
