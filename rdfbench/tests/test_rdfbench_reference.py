"""The plain reference against the port's engine on the CPU, and against
a brute-force scan, for each template."""
import itertools

import numpy as np
import pytest

from rdfbench import check, gen
from rdfbench.gen import lubm
from rdfbench.reference import TripleIndex, evaluate
from rdfbench.tests.tiny import TINY

TEMPLATES = ("q1", "q2", "q7", "q9", "q12", "q4chain")


def _queries(lay, n=4, seed=0):
    r = gen.rng(seed, 9)
    out = []
    for name, tpl in lubm.templates(lay).items():
        for _ in range(n if tpl.constants else 1):
            c = None if tpl.constants is None else int(r.integers(
                *tpl.constants))
            out.append(tpl.instantiate(c))
    return out


def _brute(triples, query):
    """Every assignment of the query's variables to triples, pattern by
    pattern, kept where all terms agree."""
    pats = query["patterns"]
    rows = []
    for combo in itertools.product(range(len(triples)), repeat=len(pats)):
        b = {}
        ok = True
        for pat, i in zip(pats, combo):
            for term, x in zip(pat, triples[i]):
                if "c" in term:
                    ok &= term["c"] == x
                elif b.setdefault(term["v"], x) != x:
                    ok = False
            if not ok:
                break
        if ok:
            rows.append([b[v] for v in sorted(b)])
    return rows


@pytest.fixture(scope="module")
def tiny():
    triples, lay = lubm.generate(TINY, 5)
    return triples, lay, TripleIndex(triples)


@pytest.mark.parametrize("name", TEMPLATES)
def test_reference_equals_the_cpu_engine(tiny, name):
    from repro_torch.core.engine import AdHashEngine
    from repro_torch.core.query import Query

    triples, lay, index = tiny
    eng = AdHashEngine(triples, 4, device="cpu", adaptive=False)
    bits = lay.n_ids.bit_length()
    for q in (q for q in _queries(lay) if q["name"] == name):
        rel, _ = eng.query(Query.from_json(q))
        names = [v.name for v in rel.vars]
        vars_, ref = evaluate(index, q)
        assert len(ref) > 0
        got = rel.to_numpy().astype(np.int64)[:, [names.index(v)
                                                  for v in vars_]]
        assert check.diff_canon(got, check.canon(ref, bits), bits) == (0, 0)
        assert {tuple(r) for r in got.tolist()} == \
            {tuple(r) for r in ref.tolist()}


def test_reference_equals_a_brute_force_scan():
    triples = np.array([[1, 0, 2], [2, 0, 3], [3, 0, 1], [1, 1, 3],
                        [2, 1, 1], [3, 0, 3]], dtype=np.int64)
    index = TripleIndex(triples)
    queries = [
        {"patterns": [[{"v": "a"}, {"c": 0}, {"v": "b"}],
                      [{"v": "b"}, {"c": 0}, {"v": "c"}]]},
        {"patterns": [[{"v": "a"}, {"c": 0}, {"v": "b"}],
                      [{"v": "b"}, {"c": 0}, {"v": "c"}],
                      [{"v": "c"}, {"c": 0}, {"v": "a"}]]},
        {"patterns": [[{"v": "a"}, {"v": "p"}, {"v": "a"}]]},
        {"patterns": [[{"v": "a"}, {"c": 1}, {"v": "b"}],
                      [{"v": "a"}, {"c": 0}, {"v": "b"}]]},
        {"patterns": [[{"c": 1}, {"v": "p"}, {"v": "b"}],
                      [{"v": "b"}, {"v": "q"}, {"c": 3}]]},
    ]
    for q in queries:
        vars_, rows = evaluate(index, q)
        want = sorted(map(tuple, _brute(triples.tolist(), q)))
        assert sorted(map(tuple, rows.tolist())) == want, q


def test_diff_counts_missing_and_extra_rows():
    want = check.canon(np.array([[1, 2], [3, 4], [5, 6]]), 4)
    got = np.array([[1, 2], [1, 2], [5, 6], [7, 7]])
    assert check.diff_canon(got, want, 4) == (1, 1)
    # more ids than one word holds: rows span several words
    wide = np.array([[1 << 40, 2, 3, 1 << 40], [5, 6, 7, 8]])
    assert check.diff_canon(wide[::-1], check.canon(wide, 41), 41) == (0, 0)
