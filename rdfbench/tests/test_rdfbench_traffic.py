"""The traffic generator: the same seed sends the same queries; every seed
sends the same set of templates and gaps, in another order."""
from collections import Counter

import numpy as np
import pytest

from rdfbench import gen
from rdfbench.gen import lubm
from rdfbench.tests.tiny import CELLS, TINY, full_cell
from rdfbench.traffic import Stream, _cap_rounds


def _stream(cell, seed):
    _, lay = lubm.generate(TINY, 0)
    return Stream(full_cell(cell).traffic, lubm.templates(lay),
                  gen.rng(seed, 1))


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_stream_and_large_seeds(cell):
    for seed in (0, 2**31 + 3, -7, 2**70):
        a, b = _stream(cell, seed).take(600), _stream(cell, seed).take(600)
        assert a == b


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_sends_the_same_work(cell):
    mix = full_cell(cell).traffic
    n = mix["block"] * 3
    count = [Counter(q["name"] for q in _stream(cell, s).take(n))
             for s in (1, 2)]
    assert count[0] == count[1]
    orders = [[q["name"] for q in _stream(cell, s).take(n)] for s in (1, 2)]
    assert orders[0] != orders[1]
    if mix["loop"] == "closed":
        c = mix["clients"]
        rounds = [sorted(tuple(sorted(Counter(o[i:i + c]).items()))
                         for i in range(0, n, c)) for o in orders]
        assert rounds[0] == rounds[1]  # the same batch sizes, reordered
        for i in range(0, n, c):
            assert max(Counter(orders[0][i:i + c]).values()) <= \
                mix["max_per_round"]


def test_rotation_moves_the_hot_template():
    """A rotating mix (adaptivity's traffic, whose cell waits under
    PERF.md's open questions) moves its hot template one place a period."""
    mix = {"loop": "closed", "clients": 32, "zipf": 1.0,
           "templates": dict.fromkeys(["q4chain", "q1", "q9", "q7", "q2",
                                       "q12"], 1),
           "rotate_every": 256, "block": 256, "max_per_round": 16}
    _, lay = lubm.generate(TINY, 0)
    s = Stream(mix, lubm.templates(lay), gen.rng(4, 1))
    hot = [Counter(q["name"] for q in s.take(256)).most_common(1)[0][0]
           for _ in range(len(mix["templates"]))]
    assert hot == list(mix["templates"])


def test_open_arrivals_same_gaps_every_seed():
    mix = full_cell("lubm100-w8-na.mix6-open").traffic
    n, rate = mix["block"], mix["rate_per_s"]
    q = (np.arange(n) + 0.5) / n
    block_s = float(np.sum(-np.log1p(-q) / rate))
    assert abs(block_s - n / rate) < 0.01 * n / rate  # the rate holds
    runs = [_stream("lubm100-w8-na.mix6-open", s).arrivals(3 * block_s + 1e-6)
            for s in (1, 2)]
    assert len(runs[0]) == len(runs[1]) == 3 * n
    assert [t for t, _ in runs[0]] != [t for t, _ in runs[1]]
    assert abs(runs[0][-1][0] - runs[1][-1][0]) < 1e-9


def test_cap_rounds_keeps_the_multiset():
    names = np.array([0] * 10 + [1] * 6)
    capped = _cap_rounds(names, 8, 5)
    assert sorted(capped) == sorted(names)
    assert max(Counter(capped[:8]).values()) <= 5
