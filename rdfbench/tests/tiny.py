"""The cells of ``BENCHMARK.json`` cut to a size the CPU tests hold."""
from __future__ import annotations

import dataclasses

from rdfbench.bench import HERE, load_bench, make_cell

#: LUBM at two universities of a few people each: UBA's profile with its
#: ranges cut, so that the CPU engine answers in milliseconds
TINY = {"universities": 2, "profile": {
    "departments": (2, 2),
    "faculty": ((1, 2), (1, 2), (1, 1), (1, 1)),
    "research_groups": (1, 2),
    "undergraduates_a_faculty": (3, 4),
    "graduates_a_faculty": (1, 2),
    "publications": ((1, 2), (1, 2), (0, 1), (0, 1)),
    "graduate_coauthored": (0, 2),
    "degree_universities": 3,
    "research_interests": 3}}


#: every pair of configuration and mix under ``configs/`` and ``traffic/``
#: that a cell runs or ran: the benchmark's cell and the open one that
#: waits under PERF.md's open questions
CELLS = ("lubm100-w8-na.mix6-closed", "lubm100-w8-na.mix6-open")


def full_cell(name: str):
    """The cell ``<config>.<mix>`` from the files, whether or not
    BENCHMARK.json lists it."""
    config, traffic = name.split(".", 1)
    return make_cell(load_bench(), name, HERE / "configs" / f"{config}.json",
                     traffic)


def tiny_cell(name: str, clients: int = 16):
    """A cell at TINY scale: its mix's loop and templates, fewer clients,
    smaller blocks."""
    cell = full_cell(name)
    # a small starting capacity: the CPU's time goes by the padded rows,
    # and overflow retry grows a relation that needs more
    config = dict(cell.config, params=TINY,
                  engine=dict(cell.config["engine"], capacity=128))
    mix = dict(cell.traffic)
    if mix["loop"] == "closed":
        mix.update(clients=clients, max_per_round=clients // 2,
                   block=4 * clients)
    else:
        # an SLO no loaded CPU misses: these runs judge answers, not speed
        mix.update(rate_per_s=40.0, warmup_s=0.5, batch_target=4,
                   slo_s=60.0)
    return dataclasses.replace(cell, config=config, traffic=mix)
