"""The control of ``correct``: the reference put in the program's place,
with the guarantee that answers are complete broken as an engine that
skipped its overflow retry would break it (``check.control_rows``).

    python3 rdfbench/control.py --workload <cell> --seed <n> [--rounds r]

Draws the first ``r`` rounds of the cell's traffic for the seed (an open
mix: ``r`` times ``batch_target`` arrivals), keeps answers with the run's
own ``Sampler`` and strata, answers each kept query with the control, and
judges them with the run's own ``harness.compare`` and ``harness.result``.
Prints one JSON line with ``correct`` and the numbers compared.  Needs no
card; the benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_reading(cell, seed: int, rounds: int = 64,
                    capacity: int | None = None) -> dict:
    import torch

    from rdfbench import check, gen
    from rdfbench.harness import SAMPLE, TRAFFIC, Run, compare, result
    from rdfbench.reference import TripleIndex, evaluate
    from rdfbench.traffic import Stream

    cfg, mix = cell.config, cell.traffic
    generator = gen.load(cfg["generator"])
    triples, layout = generator.generate(cfg["params"], seed)
    index = TripleIndex(triples)
    cap = check.CONTROL_CAPACITY if capacity is None else capacity
    workers = int(cfg["workers"])

    answers: dict[str, tuple] = {}

    def control(query):
        key = repr(query["patterns"])
        if key not in answers:
            names, rows = evaluate(index, query)
            answers[key] = check.answer_from_rows(
                names, check.control_rows(rows, workers, cap))
        return answers[key]

    stream = Stream(mix, generator.templates(layout), gen.rng(seed, TRAFFIC))
    closed = mix["loop"] == "closed"
    sampler = check.Sampler(gen.rng(seed, SAMPLE))
    n = 0
    for _ in range(rounds):
        batch = stream.take(int(mix["clients"] if closed
                                else mix["batch_target"]))
        lanes: dict[str, int] = {}
        for q in batch:
            lane = lanes[q["name"]] = lanes.get(q["name"], -1) + 1
            stratum = ((q["name"], "control", False, lane) if closed
                       else (q["name"], "control", "served", lane))
            sampler.offer(stratum, q, lambda q=q: control(q))
        n += len(batch)
    checks = compare(triples, layout, list(sampler.items()), 0, 0)
    run = Run(cell, traced=False, attempted=n, answered=n, elapsed_s=1.0)
    out = result(run, checks, torch.device("cpu"), 0)
    return {"workload": cell.name, "seed": seed, "correct": out["correct"],
            "capacity_a_worker": cap, "checks": out["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=64)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from rdfbench.bench import load_cell

    t = time.perf_counter()
    out = control_reading(load_cell(args.workload), args.seed, args.rounds)
    out["seconds"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
