"""LUBM univ-bench data as integer ids, made in bulk with NumPy.

The shape is UBA's, the Lehigh University Benchmark's data generator, as
its data generation profile states it (Guo, Pan, Heflin, "LUBM: A
benchmark for OWL knowledge base systems", J. Web Semantics 3(2), 2005,
section 3.1 and the profile it publishes with UBA):

  University  15~25 Departments are subOrganizationOf it
  Department  7~10 FullProfessors, 10~14 AssociateProfessors,
              8~11 AssistantProfessors and 5~7 Lecturers worksFor it;
              one FullProfessor is headOf it; 10~20 ResearchGroups are
              subOrganizationOf it; UndergraduateStudent : Faculty =
              8~14 : 1 and GraduateStudent : Faculty = 3~4 : 1, every
              student memberOf it
  Faculty     teacherOf 1~2 Courses and 1~2 GraduateCourses, pairwise
              disjoint; undergraduate, masters and doctoral degree from a
              University; name, emailAddress, telephone; a Professor also
              a researchInterest; FullProfessors author 15~20
              Publications, Associate 10~18, Assistant 5~10, Lecturers 0~5
  Students    an UndergraduateStudent takesCourse 2~4 Courses and 1/5 of
              them have a Professor as advisor; a GraduateStudent
              takesCourse 1~3 GraduateCourses, has a Professor as advisor,
              an undergraduateDegreeFrom a University, co-authors 0~5
              Publications with Professors; 1/5~1/4 of them are
              TeachingAssistants of one Course each (pairwise different
              Courses), 1/4~1/3 ResearchAssistants

A degree's University is drawn from UBA's pool of 1,000 universities,
whether or not the run generates it; only the generated ones are typed and
named.  The counts (departments, people, courses taken, papers) are
drawn from the parameters alone and dealt out by the seed, so every seed
makes the same number of triples, linked otherwise.  Literals are ids
too: a name repeats across departments as UBA's ("GraduateStudent12"), an
email address is each person's own, every telephone is UBA's one
"xxx-xxx-xxxx".  No inference (the data holds the
asserted triples only).  Entities live in contiguous id ranges by class,
and every array is made at once, so LUBM(100), about 13.4 M triples,
takes a couple of seconds.  The draws are not UBA's Java generator's
(another generator, another order): the same profile, not the same bits.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from rdfbench.gen import Template, rng

__all__ = ["PREDICATES", "CLASSES", "PROFILE", "Layout", "generate",
           "templates"]

PREDICATES = (
    "rdf:type", "ub:name", "ub:emailAddress", "ub:telephone",
    "ub:researchInterest", "ub:subOrganizationOf", "ub:worksFor",
    "ub:headOf", "ub:memberOf", "ub:undergraduateDegreeFrom",
    "ub:mastersDegreeFrom", "ub:doctoralDegreeFrom", "ub:teacherOf",
    "ub:takesCourse", "ub:advisor", "ub:teachingAssistantOf",
    "ub:publicationAuthor",
)
CLASSES = (
    "ub:University", "ub:Department", "ub:ResearchGroup",
    "ub:FullProfessor", "ub:AssociateProfessor", "ub:AssistantProfessor",
    "ub:Lecturer", "ub:Course", "ub:GraduateCourse",
    "ub:UndergraduateStudent", "ub:GraduateStudent", "ub:TeachingAssistant",
    "ub:ResearchAssistant", "ub:Publication",
)
(TYPE, NAME, EMAIL, PHONE, INTEREST, SUBORG, WORKS, HEAD, MEMBER, UGRAD,
 MASTERS, DOCTORAL, TEACHER, TAKES, ADVISOR, TA_OF,
 AUTHOR) = range(len(PREDICATES))
(UNIVERSITY, DEPARTMENT, GROUP, FULL, ASSOCIATE, ASSISTANT, LECTURER,
 COURSE, GCOURSE, UNDERGRAD, GRAD, TA, RA, PUBLICATION) = range(
    len(PREDICATES), len(PREDICATES) + len(CLASSES))
RANKS = (FULL, ASSOCIATE, ASSISTANT, LECTURER)
#: the stream, apart from every seed's, that draws the counts
SHAPE = 0x53484150

#: UBA's profile; inclusive ranges are drawn uniformly.  A run's
#: ``params["profile"]`` may override keys (the tests' small data does);
#: a benchmark configuration states ``universities`` alone.
PROFILE = {
    "departments": (15, 25),
    "faculty": ((7, 10), (10, 14), (8, 11), (5, 7)),  # by RANKS
    "courses_a_faculty": (1, 2),
    "graduate_courses_a_faculty": (1, 2),
    "research_groups": (10, 20),
    "undergraduates_a_faculty": (8, 14),
    "graduates_a_faculty": (3, 4),
    "publications": ((15, 20), (10, 18), (5, 10), (0, 5)),  # by RANKS
    "undergraduate_courses": (2, 4),
    "graduate_courses": (1, 3),
    "undergraduate_advisor_one_in": 5,
    "teaching_assistant_one_in": (4, 5),
    "research_assistant_one_in": (3, 4),
    "graduate_coauthored": (0, 5),
    "degree_universities": 1000,
    "research_interests": 30,
}


@dataclass(frozen=True)
class Layout:
    """The first id and the count of each class's range."""

    universities: int  # generated
    univ0: int
    dept0: int
    departments: int
    faculty0: int
    faculty: int
    course0: int
    courses: int
    gcourse0: int
    gcourses: int
    undergrads: int
    grads: int
    n_ids: int
    n_triples: int


def _draw(g, lo_hi, n) -> np.ndarray:
    lo, hi = lo_hi
    return g.integers(lo, hi + 1, n, dtype=np.int64)


def _segments(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For groups of ``counts`` members laid end to end: each member's
    group and its index within the group."""
    counts = np.asarray(counts, np.int64)
    group = np.repeat(np.arange(len(counts)), counts)
    start = np.cumsum(counts) - counts
    return group, np.arange(int(counts.sum())) - start[group]


def _distinct(g, k: np.ndarray, n: np.ndarray, width: int) -> np.ndarray:
    """For each row, ``k[i]`` distinct draws from ``range(n[i])`` in the
    first ``k[i]`` of ``width`` columns (``k <= min(width, n)``)."""
    out = np.floor(g.random((len(k), width)) * n[:, None]).astype(np.int64)
    live = np.arange(width)[None, :] < k[:, None]
    while True:
        srt = np.sort(np.where(live, out, -1 - np.arange(width)), axis=1)
        bad = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not bad.any():
            return out
        out[bad] = np.floor(g.random((int(bad.sum()), width))
                            * n[bad, None]).astype(np.int64)


def _pick_in_groups(g, group: np.ndarray, n_groups: int,
                    want: np.ndarray) -> np.ndarray:
    """A mask choosing ``want[j]`` members of group j at random."""
    key = g.random(len(group))
    order = np.lexsort((key, group))
    _, rank = _segments(np.bincount(group, minlength=n_groups))
    chosen = np.zeros(len(group), dtype=bool)
    chosen[order] = rank < want[group[order]]
    return chosen


def _rows(s, p: int, o) -> np.ndarray:
    s = np.asarray(s, np.int64)
    return np.stack([s, np.full_like(s, p),
                     np.broadcast_to(np.asarray(o, np.int64), s.shape)],
                    axis=1)


def generate(params: dict, seed: int) -> tuple[np.ndarray, Layout]:
    """``(triples, layout)``: the (N, 3) int64 triples, all distinct, of
    ``params["universities"]`` universities."""
    prof = dict(PROFILE, **params.get("profile", {}))
    n_univ = int(params["universities"])
    pool = max(int(prof["degree_universities"]), n_univ)
    # every count is drawn from the parameters alone and dealt out by the
    # seed: every seed makes the same numbers of entities, courses taken,
    # papers and triples, and links them otherwise
    shape = np.random.default_rng([n_univ, SHAPE])
    g = rng(seed, 0)

    def dealt(lo_hi, n):
        return g.permutation(_draw(shape, lo_hi, n))

    # ---- counts
    depts_of_u = dealt(prof["departments"], n_univ)
    dept_univ, dept_local = _segments(depts_of_u)
    n_dept = len(dept_univ)
    # a department's counts are dealt as one row
    rows = np.stack([_draw(shape, r, n_dept) for r in (
        *prof["faculty"], prof["research_groups"],
        prof["undergraduates_a_faculty"], prof["graduates_a_faculty"],
        prof["teaching_assistant_one_in"],
        prof["research_assistant_one_in"])], 1)[g.permutation(n_dept)]
    by_rank = rows[:, :4]
    groups_of_d, ug_ratio, gr_ratio, ta_one_in, ra_one_in = rows[:, 4:].T
    fac_of_d = by_rank.sum(1)
    fac_dept, fac_local = _segments(fac_of_d)
    n_fac = len(fac_dept)
    # a department's faculty in RANKS order: rank and index within it
    rank_start = np.cumsum(by_rank, 1) - by_rank
    fac_rank = (fac_local[:, None] >= (rank_start + by_rank)[fac_dept]
                ).sum(1)
    fac_rank_local = fac_local - rank_start[fac_dept, fac_rank]
    profs_of_d = by_rank[:, :3].sum(1)
    fac_is_prof = fac_rank < 3
    c_of_f = dealt(prof["courses_a_faculty"], n_fac)
    gc_of_f = dealt(prof["graduate_courses_a_faculty"], n_fac)
    ug_of_d = fac_of_d * ug_ratio
    gr_of_d = fac_of_d * gr_ratio
    pubs_of_f = np.zeros(n_fac, np.int64)
    for r, lo_hi in enumerate(prof["publications"]):
        at = fac_rank == r
        pubs_of_f[at] = dealt(lo_hi, int(at.sum()))

    course_fac, course_local_f = _segments(c_of_f)
    gcourse_fac, _ = _segments(gc_of_f)
    course_dept, gcourse_dept = fac_dept[course_fac], fac_dept[gcourse_fac]
    c_of_d = np.bincount(course_dept, minlength=n_dept)
    gc_of_d = np.bincount(gcourse_dept, minlength=n_dept)
    _, course_local = _segments(c_of_d)
    _, gcourse_local = _segments(gc_of_d)
    group_dept, _ = _segments(groups_of_d)
    ug_dept, ug_local = _segments(ug_of_d)
    gr_dept, gr_local = _segments(gr_of_d)
    pub_fac, pub_local = _segments(pubs_of_f)

    # ---- id ranges
    sizes = {}
    order = [("univ", pool), ("dept", n_dept), ("group", len(group_dept)),
             ("fac", n_fac), ("course", len(course_fac)),
             ("gcourse", len(gcourse_fac)), ("ug", len(ug_dept)),
             ("gr", len(gr_dept)), ("pub", len(pub_fac)), ("phone", 1),
             ("interest", int(prof["research_interests"])),
             # name pools: one literal a class and index, shared as UBA's
             ("n_univ", pool), ("n_dept", int(depts_of_u.max())),
             ("n_fac", 4 * int(by_rank.max())),
             ("n_course", int(c_of_d.max())),
             ("n_gcourse", int(gc_of_d.max())),
             ("n_ug", int(ug_of_d.max())), ("n_gr", int(gr_of_d.max())),
             ("n_pub", int(pubs_of_f.max(initial=0))),
             ("email", n_fac + len(ug_dept) + len(gr_dept))]
    at = len(PREDICATES) + len(CLASSES)
    base = {}
    for key, n in order:
        base[key] = at
        sizes[key] = n
        at += n
    n_ids = at
    univ = base["univ"] + np.arange(n_univ)
    dept = base["dept"] + np.arange(n_dept)
    group = base["group"] + np.arange(len(group_dept))
    fac = base["fac"] + np.arange(n_fac)
    course = base["course"] + np.arange(len(course_fac))
    gcourse = base["gcourse"] + np.arange(len(gcourse_fac))
    ug = base["ug"] + np.arange(len(ug_dept))
    gr = base["gr"] + np.arange(len(gr_dept))
    pub = base["pub"] + np.arange(len(pub_fac))
    fac_start = np.cumsum(fac_of_d) - fac_of_d
    c_start = np.cumsum(c_of_d) - c_of_d
    gc_start = np.cumsum(gc_of_d) - gc_of_d
    email = base["email"] + np.arange(sizes["email"])

    # ---- draws
    degrees = base["univ"] + g.integers(0, pool, (n_fac, 3))
    interest = base["interest"] + g.integers(
        0, sizes["interest"], int(fac_is_prof.sum()))

    def a_professor(dept_of):
        return fac[fac_start[dept_of] + np.floor(
            g.random(len(dept_of)) * profs_of_d[dept_of]).astype(np.int64)]

    k_ug = dealt(prof["undergraduate_courses"], len(ug_dept))
    k_ug = np.minimum(k_ug, c_of_d[ug_dept])
    width = int(prof["undergraduate_courses"][1])
    pick = _distinct(g, k_ug, c_of_d[ug_dept], width)
    ug_rows = np.repeat(np.arange(len(ug_dept)), k_ug)
    ug_takes = course[c_start[ug_dept][ug_rows]
                      + pick[np.arange(width)[None, :] < k_ug[:, None]]]
    advised = g.permutation(shape.random(len(ug_dept)) * prof[
        "undergraduate_advisor_one_in"] < 1.0)
    ug_advisor = a_professor(ug_dept[advised])

    k_gr = dealt(prof["graduate_courses"], len(gr_dept))
    k_gr = np.minimum(k_gr, gc_of_d[gr_dept])
    width = int(prof["graduate_courses"][1])
    pick = _distinct(g, k_gr, gc_of_d[gr_dept], width)
    gr_rows = np.repeat(np.arange(len(gr_dept)), k_gr)
    gr_takes = gcourse[gc_start[gr_dept][gr_rows]
                       + pick[np.arange(width)[None, :] < k_gr[:, None]]]
    gr_advisor = a_professor(gr_dept)
    gr_ugrad = base["univ"] + g.integers(0, pool, len(gr_dept))

    # teaching assistants: 1 in 4~5 of a department's graduates, each of
    # another of its Courses; research assistants: 1 in 3~4
    n_ta = np.minimum(gr_of_d // ta_one_in, c_of_d)
    is_ta = _pick_in_groups(g, gr_dept, n_dept, n_ta)
    ta_course_pick = _pick_in_groups(g, course_dept, n_dept, n_ta)
    ta_by_dept = np.lexsort((gr[is_ta], gr_dept[is_ta]))
    tc_by_dept = np.lexsort((course[ta_course_pick],
                             course_dept[ta_course_pick]))
    ta_pairs = (gr[is_ta][ta_by_dept], course[ta_course_pick][tc_by_dept])
    n_ra = gr_of_d // ra_one_in
    is_ra = _pick_in_groups(g, gr_dept, n_dept, n_ra)

    # graduates co-author 0~5 of their department's professors' papers
    prof_pubs = np.bincount(fac_dept[pub_fac[fac_is_prof[pub_fac]]],
                            minlength=n_dept)
    k_co = np.minimum(dealt(prof["graduate_coauthored"], len(gr_dept)),
                      prof_pubs[gr_dept])
    width = int(prof["graduate_coauthored"][1])
    pick = _distinct(g, k_co, np.maximum(prof_pubs[gr_dept], 1), width)
    # the department's professors' publications, in id order
    prof_pub_ids = pub[fac_is_prof[pub_fac]]
    pp_start = np.cumsum(prof_pubs) - prof_pubs
    co_rows = np.repeat(np.arange(len(gr_dept)), k_co)
    co_pub = prof_pub_ids[pp_start[gr_dept][co_rows]
                          + pick[np.arange(width)[None, :] < k_co[:, None]]]

    # ---- triples
    n_fac_name = base["n_fac"] + fac_rank * int(by_rank.max()) \
        + fac_rank_local
    fac_email = email[:n_fac]
    ug_email = email[n_fac:n_fac + len(ug_dept)]
    gr_email = email[n_fac + len(ug_dept):]
    phone = base["phone"]
    head = fac[fac_start]  # the department's first FullProfessor
    parts = [
        _rows(univ, TYPE, UNIVERSITY),
        _rows(univ, NAME, base["n_univ"] + np.arange(n_univ)),
        _rows(dept, TYPE, DEPARTMENT),
        _rows(dept, NAME, base["n_dept"] + dept_local),
        _rows(dept, SUBORG, univ[dept_univ]),
        _rows(group, TYPE, GROUP),
        _rows(group, SUBORG, dept[group_dept]),
        _rows(fac, TYPE, np.asarray(RANKS)[fac_rank]),
        _rows(fac, NAME, n_fac_name),
        _rows(fac, EMAIL, fac_email),
        _rows(fac, PHONE, phone),
        _rows(fac, UGRAD, degrees[:, 0]),
        _rows(fac, MASTERS, degrees[:, 1]),
        _rows(fac, DOCTORAL, degrees[:, 2]),
        _rows(fac, WORKS, dept[fac_dept]),
        _rows(fac[fac_is_prof], INTEREST, interest),
        _rows(head, HEAD, dept),
        _rows(fac[course_fac], TEACHER, course),
        _rows(fac[gcourse_fac], TEACHER, gcourse),
        _rows(course, TYPE, COURSE),
        _rows(course, NAME, base["n_course"] + course_local),
        _rows(gcourse, TYPE, GCOURSE),
        _rows(gcourse, NAME, base["n_gcourse"] + gcourse_local),
        _rows(pub, TYPE, PUBLICATION),
        _rows(pub, NAME, base["n_pub"] + pub_local),
        _rows(pub, AUTHOR, fac[pub_fac]),
        _rows(co_pub, AUTHOR, gr[co_rows]),
        _rows(ug, TYPE, UNDERGRAD),
        _rows(ug, NAME, base["n_ug"] + ug_local),
        _rows(ug, EMAIL, ug_email),
        _rows(ug, PHONE, phone),
        _rows(ug, MEMBER, dept[ug_dept]),
        _rows(ug[ug_rows], TAKES, ug_takes),
        _rows(ug[advised], ADVISOR, ug_advisor),
        _rows(gr, TYPE, GRAD),
        _rows(gr, NAME, base["n_gr"] + gr_local),
        _rows(gr, EMAIL, gr_email),
        _rows(gr, PHONE, phone),
        _rows(gr, MEMBER, dept[gr_dept]),
        _rows(gr, UGRAD, gr_ugrad),
        _rows(gr[gr_rows], TAKES, gr_takes),
        _rows(gr, ADVISOR, gr_advisor),
        _rows(ta_pairs[0], TYPE, TA),
        _rows(ta_pairs[0], TA_OF, ta_pairs[1]),
        _rows(gr[is_ra], TYPE, RA),
    ]
    triples = np.concatenate(parts, axis=0)
    lay = Layout(universities=n_univ, univ0=base["univ"],
                 dept0=base["dept"], departments=n_dept,
                 faculty0=base["fac"], faculty=n_fac,
                 course0=base["course"], courses=len(course_fac),
                 gcourse0=base["gcourse"], gcourses=len(gcourse_fac),
                 undergrads=len(ug_dept), grads=len(gr_dept), n_ids=n_ids,
                 n_triples=len(triples))
    return triples, lay


def templates(lay: Layout) -> dict[str, Template]:
    """LUBM's queries 1, 2, 7, 9 and 12 over the asserted triples (no
    inference: a query's inferred class is left out, or taken by the
    asserted class or predicate that implies it, as said at each), and a
    four-hop chain."""
    return {
        # Q1: graduate students taking a given graduate course
        "q1": Template("q1", (("?x", TYPE, GRAD), ("?x", TAKES, "$")),
                       (lay.gcourse0, lay.gcourse0 + lay.gcourses)),
        # Q2: graduate students who are members of a department of the
        # university they took their first degree from: a triangle
        "q2": Template("q2", (("?x", TYPE, GRAD), ("?y", TYPE, UNIVERSITY),
                              ("?z", TYPE, DEPARTMENT), ("?x", MEMBER, "?z"),
                              ("?z", SUBORG, "?y"), ("?x", UGRAD, "?y"))),
        # Q7: the students of a given faculty member's courses (Q7's
        # Student is inferred, so left out; its Course is asserted)
        "q7": Template("q7", (("?x", TAKES, "?y"), ("?y", TYPE, COURSE),
                              ("$", TEACHER, "?y")),
                       (lay.faculty0, lay.faculty0 + lay.faculty)),
        # Q9: students taking a course their advisor teaches: a triangle
        # (its three inferred classes left out)
        "q9": Template("q9", (("?x", ADVISOR, "?y"), ("?y", TEACHER, "?z"),
                              ("?x", TAKES, "?z"))),
        # Q12 with worksFor for its inferred Chair: the faculty of a
        # given university's departments
        "q12": Template("q12", (("?x", WORKS, "?y"), ("?y", TYPE, DEPARTMENT),
                                ("?y", SUBORG, "$")),
                        (lay.univ0, lay.univ0 + lay.universities)),
        # every enrolment to its course's teacher, department and
        # university: the largest answer of the mix
        "q4chain": Template("q4chain", (("?s", TAKES, "?c"),
                                        ("?p", TEACHER, "?c"),
                                        ("?p", WORKS, "?dpt"),
                                        ("?dpt", SUBORG, "?u"))),
    }
