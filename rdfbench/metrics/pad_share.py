"""Share of the batched lanes that were padding: the sum over the
window's dispatched buckets of (B_pad - B) over the sum of B_pad, B_pad
being the power-of-two class ``query_batch`` pads a bucket of B to (a
singleton runs alone: B_pad 1)."""

LAYER = "batcher"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "queries_per_s"


def read(run):
    lanes = sum(p for _, p in run.buckets)
    if not lanes:
        return None
    return 100.0 * sum(p - b for b, p in run.buckets) / lanes
