"""The LUBM generator: UBA's profile, its size against the published
datasets, and the same triples from the same seed."""
import numpy as np
import pytest

from rdfbench.gen import lubm

FULL = {"universities": 100}
#: total triples and departments (one file each) of LUBM(10, 0) and
#: LUBM(50, 0) as generated by UBA (Guo, Pan, Heflin 2005, table of the
#: test data sets)
PUBLISHED = {10: (1_316_993, 189), 50: (6_890_640, 999)}


def _by(triples, p):
    t = triples[triples[:, 1] == p]
    return t[:, 0], t[:, 2]


def _between(values, lo_hi):
    values = np.asarray(values)
    return values.min() >= lo_hi[0] and values.max() <= lo_hi[1]


def test_lubm100_size_and_distinct_triples():
    triples, lay = lubm.generate(FULL, 2**31 + 17)
    assert 13_000_000 < len(triples) == lay.n_triples < 14_500_000
    assert 15 * 100 <= lay.departments <= 25 * 100
    assert triples.min() >= 0 and triples.max() < lay.n_ids < 2**31
    bits = lay.n_ids.bit_length()
    assert 2 * bits + 5 < 63 and len(lubm.PREDICATES) <= 32
    packed = (triples[:, 0] << bits | triples[:, 2]) << 5 | triples[:, 1]
    assert len(np.unique(packed)) == len(triples)


@pytest.mark.parametrize("universities", sorted(PUBLISHED))
def test_size_a_department_near_the_published_datasets(universities):
    """UBA writes one file a department; the triples a department come
    within 6% of the published datasets' (measured: 4.3 to 4.9% under)."""
    total, files = PUBLISHED[universities]
    triples, lay = lubm.generate({"universities": universities}, 11)
    ratio = len(triples) / lay.departments / (total / files)
    assert 0.94 < ratio < 1.06


def test_class_counts_and_fan_outs():
    """Every range of UBA's profile, read back from the triples of one
    university."""
    triples, lay = lubm.generate({"universities": 1}, 3)
    P = lubm.PROFILE
    s, o = _by(triples, lubm.TYPE)
    of_type = {c: set(s[o == c].tolist()) for c in set(o.tolist())}
    dept_s, dept_u = _by(triples, lubm.SUBORG)
    depts = of_type[lubm.DEPARTMENT]
    assert _between([len(depts)], P["departments"])
    assert len(of_type[lubm.UNIVERSITY]) == 1
    works_s, works_o = _by(triples, lubm.WORKS)
    dept_of = dict(zip(works_s.tolist(), works_o.tolist()))
    for rank, lo_hi in zip(lubm.RANKS, P["faculty"]):
        per = np.bincount([dept_of[f] for f in of_type[rank]])
        assert _between(per[sorted(depts)], lo_hi)
    faculty = set(dept_of)
    professors = faculty - of_type[lubm.LECTURER]
    # teacherOf: 1~2 Courses and 1~2 GraduateCourses each, pairwise
    # disjoint
    t_s, t_o = _by(triples, lubm.TEACHER)
    assert len(set(t_o.tolist())) == len(t_o)
    for kind, key in ((lubm.COURSE, "courses_a_faculty"),
                      (lubm.GCOURSE, "graduate_courses_a_faculty")):
        mine = np.isin(t_o, list(of_type[kind]))
        assert _between(np.unique(t_s[mine], return_counts=True)[1],
                        P[key])
        assert set(t_s[mine].tolist()) == faculty
    # students: per-department ratios, courses of their own department
    m_s, m_o = _by(triples, lubm.MEMBER)
    member = dict(zip(m_s.tolist(), m_o.tolist()))
    fac_n = np.bincount(list(dept_of.values()))
    teacher_dept = {c: dept_of[f] for f, c in zip(t_s.tolist(),
                                                  t_o.tolist())}
    tk_s, tk_o = _by(triples, lubm.TAKES)
    a_s, a_o = _by(triples, lubm.ADVISOR)
    advisor = dict(zip(a_s.tolist(), a_o.tolist()))
    for kind, ratio, courses, key in (
            (lubm.UNDERGRAD, "undergraduates_a_faculty", lubm.COURSE,
             "undergraduate_courses"),
            (lubm.GRAD, "graduates_a_faculty", lubm.GCOURSE,
             "graduate_courses")):
        studs = of_type[kind]
        per = np.bincount([member[x] for x in studs])
        r = per[sorted(depts)] / fac_n[sorted(depts)]
        assert np.allclose(r, np.round(r)) and _between(r, P[ratio])
        mine = np.isin(tk_s, list(studs))
        assert np.isin(tk_o[mine], list(of_type[courses])).all()
        assert all(teacher_dept[c] == member[x] for x, c in
                   zip(tk_s[mine].tolist(), tk_o[mine].tolist()))
        counts = np.unique(tk_s[mine], return_counts=True)[1]
        assert len(counts) == len(studs) and _between(counts, P[key])
        assert all(advisor[x] in professors and dept_of[advisor[x]] ==
                   member[x] for x in studs if x in advisor)
    grads, ugs = of_type[lubm.GRAD], of_type[lubm.UNDERGRAD]
    assert grads <= set(advisor)
    share = len(ugs & set(advisor)) / len(ugs)
    assert 0.15 < share < 0.25  # 1 in 5
    # teaching assistants of pairwise different Courses; research ones
    ta_s, ta_o = _by(triples, lubm.TA_OF)
    assert set(ta_s.tolist()) == of_type[lubm.TA] <= grads
    assert len(set(ta_o.tolist())) == len(ta_o)
    assert 1 / 5.5 < len(of_type[lubm.TA]) / len(grads) < 1 / 3.5
    assert 1 / 4.5 < len(of_type[lubm.RA]) / len(grads) < 1 / 2.5
    # publications: authored by rank, co-authored by graduates
    au_s, au_o = _by(triples, lubm.AUTHOR)
    for rank, lo_hi in zip(lubm.RANKS, P["publications"]):
        n = [int((au_o == f).sum()) for f in of_type[rank]]
        assert _between(n, lo_hi)
    co = np.isin(au_o, list(grads))
    assert _between(np.bincount(au_o[co])[list(grads)], P[
        "graduate_coauthored"])
    # one head a department, a FullProfessor of it
    h_s, h_o = _by(triples, lubm.HEAD)
    assert sorted(h_o.tolist()) == sorted(depts)
    assert all(f in of_type[lubm.FULL] and dept_of[f] == d
               for f, d in zip(h_s.tolist(), h_o.tolist()))
    # every telephone is UBA's one literal; an email address is its own
    _, phones = _by(triples, lubm.PHONE)
    _, emails = _by(triples, lubm.EMAIL)
    assert len(set(phones.tolist())) == 1
    assert len(set(emails.tolist())) == len(emails)
    assert dept_u.size and lay.universities == 1


def test_same_seed_same_triples_other_seed_other_draws():
    a, _ = lubm.generate({"universities": 5}, 7)
    b, _ = lubm.generate({"universities": 5}, 7)
    c, _ = lubm.generate({"universities": 5}, 8)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    # the counts are the parameters', dealt out by the seed: the same
    # numbers of triples of each predicate, linked otherwise
    for x, y in ((a, c), (a, lubm.generate({"universities": 5}, 2**40)[0])):
        assert np.array_equal(np.bincount(x[:, 1]), np.bincount(y[:, 1]))
