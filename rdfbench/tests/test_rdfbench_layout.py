"""BENCHMARK.json, the files it names and the readers agree; the byte
counts reproduce the kernels' bounds; the trace reduction's pieces."""
import json
import re

import pytest

from rdfbench import roofline
from rdfbench.bench import HERE, ROOT, load_cell, load_metric, per_layer_of
from rdfbench.trace import _innermost, _merge

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_the_benchmark_gives_has_its_file():
    assert BENCH["command"] == ["python3", "rdfbench/run.py"]
    assert BENCH["paths"] == ["rdfbench"]
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["file"].startswith("rdfbench/")
        assert set(c["reduced"]) <= set(cfg["reduced"])
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert cell.chips == 1 and len(w["why"]) <= 200
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_reader_declares_what_benchmark_json_says(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    reader = load_metric(metric)
    assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    reported = {w: {m["name"] for m in load_cell(w).end_to_end}
                for w in entry.get("workloads",
                                   [w["name"] for w in BENCH["workloads"]])}
    assert all(entry["moves"] in r for r in reported.values())


def test_every_cell_reports_a_per_layer_metric():
    for w in BENCH["workloads"]:
        assert per_layer_of(BENCH, w["name"])
    files = {p.stem for p in (HERE / "metrics").glob("*.py")}
    assert files >= {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("metric", sorted(
    {p.stem for p in (HERE / "metrics").glob("*.py")}))
def test_every_reader_declares_its_layer_unit_source_and_moves(metric):
    """Also the readers of the cells that wait under PERF.md's open
    questions, which a later change adds by BENCHMARK.json entries alone."""
    reader = load_metric(metric)
    assert reader.SOURCE in ("device_trace", "program_span",
                             "program_counter", "host_clock")
    assert reader.MOVES in ("queries_per_s", "latency_p95_ms", "setup_s")
    assert NAME.match(metric) and reader.LAYER and reader.UNIT
    assert callable(reader.read)


def test_byte_counts_give_the_bounds_of_the_main_rows():
    """The main rows of the port's kernel table (PERF.md): the reply probe
    and expand reproduce its bound_ms; bucket_by_dest counts only the
    flags of a row, not a valid row's value and destination."""
    probe = ("range_search", ("rows", 8), ("N", 594_575), ("M", 1 << 23),
             ("itemsize", 8))
    assert roofline.bound_s(probe) * 1e3 == pytest.approx(0.3319, abs=1e-4)
    expand = ("expand", ("rows", 8), ("n", 1 << 23), ("out_cap", 1 << 20))
    assert roofline.bound_s(expand) * 1e3 == pytest.approx(0.1828, abs=1e-4)
    bucket = ("bucket_by_dest", ("rows", 8), ("n", 1 << 20), ("k", 3),
              ("n_dest", 8), ("cap_peer", 1 << 20))
    assert roofline.bound_s(bucket) * 1e3 < 0.2648
    # a span search of 16 probes reads a search path, not all 594,575 keys
    span = ("span_search", ("rows", 8), ("N", 594_575), ("M", 16),
            ("itemsize", 8))
    assert roofline.launch_bytes(span) == 8 * 16 * 20 * 8 + 2 * 8 * 16 * 8 \
        + 2 * 8 * 16 * 4


def test_merge_and_innermost_span():
    assert _merge([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    spans = [(0, 100, "outer"), (10, 20, "a"), (30, 60, "b"), (40, 50, "c")]
    assert _innermost(spans, [5, 15, 25, 35, 45, 55, 99, 150]) == [
        "outer", "a", "outer", "b", "c", "b", "outer", None]
