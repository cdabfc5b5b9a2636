"""Share of the serving loop's bucket dispatches made because the oldest
member's deadline came near, not because the bucket filled: the window's
``ServeReport.flush_deadline`` over all its flushes."""

LAYER = "serving front end"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "latency_p95_ms"


def read(run):
    flushes = sum(v for k, v in run.serve.items() if k.startswith("flush_"))
    if not flushes:
        return None
    return 100.0 * run.serve["flush_deadline"] / flushes
