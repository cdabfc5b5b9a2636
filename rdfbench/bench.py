"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); a per-layer metric is read by
``metrics/<name>.py``.  Nothing here imports the program.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "Cell", "load_bench", "make_cell", "load_cell",
           "load_metric", "end_to_end_of", "per_layer_of"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set[str] | None = None
             ) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def end_to_end_of(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer_of(bench: dict, cell: str) -> list[dict]:
    reported = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"] if _applies(m, cell, reported)]


def load_bench() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def make_cell(bench: dict, name: str, config_file: Path, traffic: str,
              chips: int = 1) -> Cell:
    """A cell of a configuration file and a traffic mix's name, reporting
    what ``bench`` asks of a cell of this name."""
    return Cell(name, chips, _json(config_file),
                _json(HERE / "traffic" / f"{traffic}.json"),
                end_to_end_of(bench, name), per_layer_of(bench, name))


def load_cell(name: str) -> Cell:
    """The cell ``BENCHMARK.json`` names ``name``."""
    bench = load_bench()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return make_cell(bench, name, ROOT / configs[w["config"]]["file"],
                     w["traffic"], int(w["chips"]))


def load_metric(name: str):
    """The reader module ``metrics/<name>.py`` (the name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"rdfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
