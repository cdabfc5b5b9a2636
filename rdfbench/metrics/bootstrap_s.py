"""Seconds the engine took from the triples to a store on the card:
``AdHashEngine.startup_time_s``, the program's own host clock, ended by a
sync (partition, load, statistics)."""

LAYER = "bootstrap"
UNIT = "s"
SOURCE = "program_span"
MOVES = "setup_s"


def read(run):
    return run.startup_time_s or None
