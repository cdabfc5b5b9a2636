"""Synthetic RDF data + workload generators (LUBM-style).

``lubm_like`` emits an academic-network graph with the LUBM entity classes
(universities, departments, professors, students, courses) and predicates,
at a configurable scale — the same skew characteristics the paper's
experiments rely on (few high-degree objects such as universities/types,
many low-degree subjects).

``Workload`` mirrors Appendix B: query templates instantiated with varying
constants (Table 16 — constants changed per instance, structure shared), so
the heat map sees hot *templates* rather than hot literal queries.

Out-of-core generation (DESIGN §12): ``generate`` / ``generate_stream`` are
*counter-based* — triple i is a pure hash of (seed, i), never of any
accumulated RNG state — so ``generate(n, seed=s)`` equals the concatenation
of ``generate_stream(n, chunk, seed=s)`` for **every** chunk size, and a
billion-triple stream needs host memory proportional to one chunk.

This is the PyTorch port's own copy of ``repro.data.synthetic_rdf`` (the
port imports nothing of the JAX package); outputs are identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.dictionary import Dictionary
from repro_torch.core.placement import splitmix64_np
from repro_torch.core.query import Const, Query, TriplePattern, Var

__all__ = ["lubm_like", "Workload", "lubm_queries", "zipf_skew",
           "zipf_workload", "generate", "generate_stream"]

PREDICATES = (
    "rdf:type",
    "ub:advisor",
    "ub:takesCourse",
    "ub:teacherOf",
    "ub:worksFor",
    "ub:memberOf",
    "ub:subOrganizationOf",
    "ub:undergraduateDegreeFrom",
)


def lubm_like(
    n_universities: int = 4,
    depts_per_univ: int = 3,
    profs_per_dept: int = 4,
    students_per_prof: int = 6,
    courses_per_prof: int = 2,
    seed: int = 0,
) -> tuple[Dictionary, np.ndarray]:
    rng = np.random.default_rng(seed)
    d = Dictionary()
    t: list[tuple[str, str, str]] = []

    for u in range(n_universities):
        univ = f"Univ{u}"
        for dp in range(depts_per_univ):
            dept = f"Dept{u}.{dp}"
            t.append((dept, "ub:subOrganizationOf", univ))
            t.append((dept, "rdf:type", "ub:Department"))
            for pf in range(profs_per_dept):
                prof = f"Prof{u}.{dp}.{pf}"
                t.append((prof, "rdf:type", "ub:Professor"))
                t.append((prof, "ub:worksFor", dept))
                t.append(
                    (prof, "ub:undergraduateDegreeFrom",
                     f"Univ{rng.integers(n_universities)}")
                )
                courses = []
                for c in range(courses_per_prof):
                    course = f"Course{u}.{dp}.{pf}.{c}"
                    courses.append(course)
                    t.append((course, "rdf:type", "ub:Course"))
                    t.append((prof, "ub:teacherOf", course))
                for s in range(students_per_prof):
                    stud = f"Stud{u}.{dp}.{pf}.{s}"
                    t.append((stud, "rdf:type", "ub:Student"))
                    t.append((stud, "ub:advisor", prof))
                    t.append((stud, "ub:memberOf", dept))
                    t.append(
                        (stud, "ub:undergraduateDegreeFrom",
                         f"Univ{rng.integers(n_universities)}")
                    )
                    for c in rng.choice(
                        len(courses), size=min(2, len(courses)), replace=False
                    ):
                        t.append((stud, "ub:takesCourse", courses[c]))
    return d, d.encode_triples(t)


def zipf_skew(
    n_subjects: int = 512,
    n_triples: int = 60_000,
    n_objects: int = 8192,
    n_predicates: int = 8,
    exponent: float = 1.4,
    seed: int = 0,
) -> np.ndarray:
    """Deliberately hot-key-skewed triples: subject popularity ~ Zipf.

    Subject of each triple is drawn with probability proportional to
    ``rank^-exponent`` — at exponent 1.4 the top subject owns roughly a
    third of all triples, the classic hub star that defeats subject-hash
    partitioning (every one of its triples lands on one shard).  Ids are
    laid out [predicates | subjects | objects] so the three ranges never
    collide; exact duplicate triples are dropped (RDF set semantics).

    Returns (N, 3) int64 triples (subject hotness decreasing with id), the
    same for the same seed as the JAX package's.  The draws are the
    reference's; the set dedupe packs each row into one int64 key whose
    order is the rows' lexicographic order, so a 1-D ``np.unique`` returns
    what ``np.unique(axis=0)`` does, many times faster."""
    rng = np.random.default_rng(seed)
    s_base = n_predicates
    o_base = s_base + n_subjects
    ranks = np.arange(1, n_subjects + 1, dtype=np.float64)
    probs = ranks ** -float(exponent)
    probs /= probs.sum()
    s = rng.choice(n_subjects, size=n_triples, p=probs)
    p = rng.integers(0, n_predicates, size=n_triples)
    o = rng.integers(0, n_objects, size=n_triples)
    if n_subjects * n_predicates * n_objects >= 1 << 63:
        triples = np.stack([s + s_base, p, o + o_base], axis=1)
        return np.unique(triples.astype(np.int64), axis=0)
    key = np.unique((s.astype(np.int64) * n_predicates + p) * n_objects + o)
    sp, o = np.divmod(key, n_objects)
    s, p = np.divmod(sp, n_predicates)
    return np.stack([s + s_base, p, o + o_base], axis=1).astype(np.int64)


def _counter_hash(seed: int, stream: int, idx: np.ndarray) -> np.ndarray:
    """Deterministic 63-bit hash of (seed, stream, index) — the per-triple
    randomness source of the counter-based generators.  Two splitmix64
    rounds with seed/stream folded in between decorrelate the three streams
    (subject / predicate / object) of one index."""
    # fold seed and stream into one 64-bit key in Python ints (numpy scalar
    # arithmetic warns on the intended wraparound)
    k = np.uint64(
        ((seed & 0xFFFFFFFFFFFFFFFF) * 0xD1342543DE82EF95
         + stream * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    )
    h = splitmix64_np(idx.astype(np.uint64))
    return splitmix64_np(h.astype(np.uint64) + k)


def _counter_uniform(seed: int, stream: int, idx: np.ndarray) -> np.ndarray:
    """[0, 1) float64 per index, chunking-invariant."""
    return _counter_hash(seed, stream, idx).astype(np.float64) / float(1 << 63)


def generate_stream(
    n_triples: int,
    chunk_size: int,
    *,
    n_subjects: int = 512,
    n_objects: int = 8192,
    n_predicates: int = 8,
    exponent: float = 1.4,
    seed: int = 0,
) -> Iterator[np.ndarray]:
    """Yield ``(<=chunk_size, 3)`` int64 triple chunks, seed-stable.

    Triple i is a pure function of (seed, i): subject drawn from the Zipf
    law by inverse-CDF over a precomputed cumsum (the only O(n_subjects)
    state), predicate and object uniform.  Id layout:
    [predicates | subjects | objects].  Because nothing depends on chunk
    boundaries, ``concat(generate_stream(n, c))`` is identical for every c
    — the streaming-ingest regression in tests/test_ingest_stream.py.

    Duplicates are *not* dropped (no global np.unique — that would need the
    full array); the store build keeps multiset semantics either way."""
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    s_base = n_predicates
    o_base = s_base + n_subjects
    ranks = np.arange(1, n_subjects + 1, dtype=np.float64)
    probs = ranks ** -float(exponent)
    cdf = np.cumsum(probs / probs.sum())
    cdf[-1] = 1.0  # guard the tail against rounding
    for lo in range(0, n_triples, chunk_size):
        idx = np.arange(lo, min(lo + chunk_size, n_triples), dtype=np.uint64)
        u = _counter_uniform(seed, 0, idx)
        s = np.searchsorted(cdf, u, side="right") + s_base
        p = _counter_hash(seed, 1, idx) % n_predicates
        o = _counter_hash(seed, 2, idx) % n_objects + o_base
        yield np.stack([s, p, o], axis=1).astype(np.int64)


def generate(
    n_triples: int,
    *,
    n_subjects: int = 512,
    n_objects: int = 8192,
    n_predicates: int = 8,
    exponent: float = 1.4,
    seed: int = 0,
) -> np.ndarray:
    """One-shot twin of :func:`generate_stream` (same triples, one array)."""
    chunks = list(
        generate_stream(
            n_triples, max(n_triples, 1), n_subjects=n_subjects,
            n_objects=n_objects, n_predicates=n_predicates,
            exponent=exponent, seed=seed,
        )
    )
    if not chunks:
        return np.zeros((0, 3), dtype=np.int64)
    return np.concatenate(chunks, axis=0)


def zipf_workload(
    n_queries: int,
    n_subjects: int = 512,
    n_predicates: int = 8,
    exponent: float = 1.4,
    seed: int = 0,
) -> list[Query]:
    """Single-pattern star probes matching :func:`generate_stream`'s layout:
    (Const(s), Const(p), Var(o)) with s drawn from the *same* Zipf law as
    the data — the hot hub is also the workload's hot subject, so its full
    star capacity dominates query cost under hash placement."""
    rng = np.random.default_rng(seed)
    s_base = n_predicates
    ranks = np.arange(1, n_subjects + 1, dtype=np.float64)
    probs = ranks ** -float(exponent)
    probs /= probs.sum()
    subjects = rng.choice(n_subjects, size=n_queries, p=probs) + s_base
    preds = rng.integers(0, n_predicates, size=n_queries)
    return [
        Query(
            [TriplePattern(Const(int(s)), Const(int(p)), Var("o"))],
            name="zipf_star",
        )
        for s, p in zip(subjects, preds)
    ]


def lubm_queries(d: Dictionary) -> dict[str, "QueryTemplate"]:
    """Templates in the spirit of LUBM Q1-Q14 / Appendix A (no inferencing)."""

    def C(term: str) -> Const:
        tid = d.lookup(term)
        assert tid is not None, term
        return Const(tid)

    V = Var
    univs = [t for t in _terms(d) if t.startswith("Univ")]
    depts = [t for t in _terms(d) if t.startswith("Dept")]
    profs = [t for t in _terms(d) if t.startswith("Prof")]
    courses = [t for t in _terms(d) if t.startswith("Course")]

    return {
        # Q1-like: students taking a given course (selective star)
        "q1": QueryTemplate(
            lambda c0: Query(
                [
                    TriplePattern(V("x"), C("rdf:type"), C("ub:Student")),
                    TriplePattern(V("x"), C("ub:takesCourse"), Const(c0)),
                ],
                name="q1",
            ),
            [d.lookup(c) for c in courses],
        ),
        # Q2-like: triangle (student, univ, dept) — complex/cyclic
        "q2": QueryTemplate(
            lambda _: Query(
                [
                    TriplePattern(V("x"), C("ub:memberOf"), V("z")),
                    TriplePattern(V("z"), C("ub:subOrganizationOf"), V("y")),
                    TriplePattern(
                        V("x"), C("ub:undergraduateDegreeFrom"), V("y")
                    ),
                ],
                name="q2",
            ),
            [0],
        ),
        # Q7-like: students of a professor's courses (object-object join)
        "q7": QueryTemplate(
            lambda p0: Query(
                [
                    TriplePattern(V("x"), C("ub:takesCourse"), V("y")),
                    TriplePattern(Const(p0), C("ub:teacherOf"), V("y")),
                ],
                name="q7",
            ),
            [d.lookup(p) for p in profs],
        ),
        # Q9-like: advisor/course triangle — large intermediate results
        "q9": QueryTemplate(
            lambda _: Query(
                [
                    TriplePattern(V("x"), C("ub:advisor"), V("y")),
                    TriplePattern(V("y"), C("ub:teacherOf"), V("z")),
                    TriplePattern(V("x"), C("ub:takesCourse"), V("z")),
                ],
                name="q9",
            ),
            [0],
        ),
        # deep chain through hub vertices (students -> course -> prof ->
        # dept -> univ): the regime where High-Low core selection wins
        # (paper Fig 16, LUBM-10240)
        "q4chain": QueryTemplate(
            lambda _: Query(
                [
                    TriplePattern(V("s"), C("ub:takesCourse"), V("c")),
                    TriplePattern(V("p"), C("ub:teacherOf"), V("c")),
                    TriplePattern(V("p"), C("ub:worksFor"), V("dpt")),
                    TriplePattern(
                        V("dpt"), C("ub:subOrganizationOf"), V("u")
                    ),
                ],
                name="q4chain",
            ),
            [0],
        ),
        # Q12-like: dept heads of a university (chain with constant)
        "q12": QueryTemplate(
            lambda u0: Query(
                [
                    TriplePattern(V("x"), C("ub:worksFor"), V("y")),
                    TriplePattern(V("y"), C("ub:subOrganizationOf"), Const(u0)),
                ],
                name="q12",
            ),
            [d.lookup(u) for u in univs],
        ),
    }


def _terms(d: Dictionary) -> list[str]:
    return [d.decode_term(i) for i in range(len(d))]


@dataclass
class QueryTemplate:
    make: "callable"
    constants: list[int]

    def instantiate(self, rng: np.random.Generator) -> Query:
        c = self.constants[int(rng.integers(len(self.constants)))]
        return self.make(c)


class Workload:
    """A stream of template-instantiated queries (paper §6.4)."""

    def __init__(self, d: Dictionary, mix: dict[str, float] | None = None,
                 seed: int = 0):
        self.templates = lubm_queries(d)
        self.mix = mix or {k: 1.0 for k in self.templates}
        self.rng = np.random.default_rng(seed)

    def sample(self, n: int) -> list[Query]:
        names = list(self.mix)
        probs = np.array([self.mix[k] for k in names], dtype=np.float64)
        probs /= probs.sum()
        out = []
        for _ in range(n):
            name = names[int(self.rng.choice(len(names), p=probs))]
            out.append(self.templates[name].instantiate(self.rng))
        return out
