"""Storage, hash and DSJ stages of the port against the JAX package.

The same numpy inputs (from a seed) go through ``repro`` and through
``repro_torch`` on the CPU:

  * ingest: the port's store leaves are bit-identical for one-shot and
    chunked ingest, and equal to the JAX package's, with equal statistics;
  * ``splitmix64`` (torch) equals ``splitmix64_np`` and the jnp hash;
  * every DSJ stage runs on one identical index — the JAX store's leaves
    carried over with ``ShardedTripleStore.from_numpy`` — and its outputs
    equal the JAX stage's outputs (all integers, bit-exact);
  * finalize over the filled prefix of each reply bucket equals finalize
    over whole buckets;
  * a warm fused chain query makes exactly one host sync.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax.numpy as jnp

from repro.core import dsj as JD
from repro.core import triples as JT
from repro.core.ingest import StreamIngestor as JIngestor
from repro.core.placement import HashPlacement as JHash
from repro.core.placement import splitmix64_jnp
from repro.core.placement import splitmix64_np as j_splitmix64_np
from repro.core.query import Const as JC
from repro.core.query import TriplePattern as JTP
from repro.core.query import Var as JV
from repro.core.substrate import SingleDeviceSubstrate as JSub
from repro.data.synthetic_rdf import generate, lubm_like
from repro_torch.core import dsj as TD
from repro_torch.core import triples as TT
from repro_torch.core.backend import quantize_capacity
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.ingest import StreamIngestor
from repro_torch.core.placement import HashPlacement, splitmix64, \
    splitmix64_np
from repro_torch.core.query import Const as TC
from repro_torch.core.query import Query as TQuery
from repro_torch.core.query import TriplePattern as TTP
from repro_torch.core.query import Var as TV
from repro_torch.core.substrate import trace_host_syncs

W = 4
LEAVES = ("spo_ps", "keys_ps", "spo_po", "keys_po", "counts")


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want) -> None:
    """Stage outputs (tuples, nested tuples, scalars) are bit-identical."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


def _jax_ingest(triples, chunks=None):
    ing = JIngestor(W, placement=JHash(W), substrate=JSub())
    for c in chunks or [triples]:
        ing.add_chunk(c)
    return ing.finish()


def _torch_ingest(triples, chunks=None):
    ing = StreamIngestor(W, placement=HashPlacement(W))
    for c in chunks or [triples]:
        ing.add_chunk(c)
    return ing.finish("cpu")


# ------------------------------------------------------------------- ingest
@pytest.mark.parametrize("source", ["lubm", "zipf"])
def test_store_leaves_one_shot_chunked_and_reference(source):
    if source == "lubm":
        triples = lubm_like(3, 2, 3, 4, 2)[1].astype(np.int64)
    else:
        triples = generate(3000, n_subjects=64, n_objects=512, seed=3)
    j_store, j_stats, j_nid = _jax_ingest(triples)
    t_store, t_stats, t_nid = _torch_ingest(triples)
    assert t_nid == j_nid
    for name in LEAVES:
        np.testing.assert_array_equal(_np(getattr(t_store, name)),
                                      np.asarray(getattr(j_store, name)))
    for size in (1, 97, 1000):
        chunks = [triples[i:i + size] for i in range(0, len(triples), size)]
        c_store, c_stats, _ = _torch_ingest(triples, chunks)
        for name in LEAVES:
            np.testing.assert_array_equal(_np(getattr(c_store, name)),
                                          _np(getattr(t_store, name)))
        assert c_stats.per_pred == t_stats.per_pred
    assert t_stats.n_triples == j_stats.n_triples
    assert {p: vars(st) for p, st in t_stats.per_pred.items()} == \
        {p: vars(st) for p, st in j_stats.per_pred.items()}
    np.testing.assert_array_equal(t_stats._degree, j_stats._degree)
    assert sorted(map(tuple, t_store.to_numpy().tolist())) == \
        sorted(map(tuple, np.asarray(triples).tolist()))


def test_splitmix64_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    ids = np.concatenate([
        np.array([0, 1, 2, 2**31 - 1, 2**31, 2**62, 2**63 - 1], np.int64),
        rng.integers(0, 2**63 - 1, 4096, dtype=np.int64),
    ])
    want = j_splitmix64_np(ids)
    np.testing.assert_array_equal(splitmix64_np(ids), want)
    np.testing.assert_array_equal(_np(splitmix64(torch.from_numpy(ids))),
                                  want)
    np.testing.assert_array_equal(np.asarray(splitmix64_jnp(
        jnp.asarray(ids))), want)
    # int32 inputs (projected ids, -1 pad) hash exactly like the jnp stage,
    # which casts to uint64 by sign extension
    i32 = np.array([-1, 0, 7, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        _np(splitmix64(torch.from_numpy(i32))),
        np.asarray(splitmix64_jnp(jnp.asarray(i32))))
    assert (want >= 0).all()


# ------------------------------------------------------------- DSJ stages
@pytest.fixture(scope="module")
def index():
    """One LUBM-style index in both packages: the JAX store and the port's
    store carried over from its leaves with ``from_numpy``."""
    d, triples = lubm_like(3, 2, 3, 4, 2)
    j_store, _, nid = _jax_ingest(triples.astype(np.int64))
    t_store = TT.ShardedTripleStore.from_numpy(
        *(np.asarray(getattr(j_store, n)) for n in LEAVES), nid,
        device="cpu")
    return d, j_store, t_store


def _pat(d, s, p, o):
    """The same pattern in both packages: names starting with '?' are
    variables, other strings dictionary terms."""
    def terms(V, C):
        return [V(x[1:]) if x.startswith("?") else C(d.lookup(x))
                for x in (s, p, o)]

    return JTP(*terms(JV, JC)), TTP(*terms(TV, TC))


PATTERNS = {
    "p_s": ("Prof0.0.0", "ub:teacherOf", "?y"),
    "p_o": ("?x", "rdf:type", "ub:Student"),
    "p": ("?x", "ub:advisor", "?y"),
    "var_p": ("?x", "?p", "?y"),
    "same_var": ("?x", "ub:advisor", "?x"),
}


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_match_ranges_and_match_first(index, name):
    d, js, ts = index
    jq, tq = _pat(d, *PATTERNS[name])
    jspec, tspec = JD.PatternSpec.of(jq), TD.PatternSpec.of(tq)
    jc, tc = JD.pattern_consts(jq), TD.pattern_consts(tq, "cpu")
    for use_po, k in ((False, 0), (True, 2)):
        _assert_same(TT.match_ranges(ts, tc[1], tc[k], use_po, ts.n_ids),
                     JT.match_ranges(js, jc[1], jc[k], use_po=use_po,
                                     nid=js.n_ids))
    for cap in (64, 256):  # 64 overflows for the unselective patterns
        _assert_same(TD.match_first(ts, tc, tspec, cap),
                     JD.match_first(js, jc, jspec, cap))


@pytest.mark.parametrize("col", [0, 1, 2])
def test_probe_values_and_gather_rows(index, col):
    d, js, ts = index
    rng = np.random.default_rng(col)
    vals = rng.integers(-1, 40, (W, 48)).astype(np.int32)
    valid = rng.random((W, 48)) > 0.2
    p = d.lookup("ub:advisor") if col != 1 else 0
    got = TT.probe_values(ts, torch.tensor(p, dtype=torch.int32),
                          torch.from_numpy(vals), torch.from_numpy(valid),
                          col, ts.n_ids)
    want = JT.probe_values(js, jnp.int32(p), jnp.asarray(vals),
                           jnp.asarray(valid), col=col, nid=js.n_ids)
    _assert_same(got, want)
    for cap in (16, 512):
        rows, src, v, tot = TT.gather_rows(ts, got[0], got[1], cap,
                                           use_po=col == 2)
        jrows, jsrc, jv, jtot = JT.gather_rows(js, want[0], want[1], cap,
                                               use_po=col == 2)
        _assert_same((rows, v, tot), (jrows, jv, jtot))
        m = _np(v)
        np.testing.assert_array_equal(_np(src)[m], np.asarray(jsrc)[m])


def _first(d, js, ts, pattern, cap):
    jq, tq = _pat(d, *pattern)
    jcols, jvalid, _ = JD.match_first(js, JD.pattern_consts(jq),
                                      JD.PatternSpec.of(jq), cap)
    tcols, tvalid, _ = TD.match_first(ts, TD.pattern_consts(tq, "cpu"),
                                      TD.PatternSpec.of(tq), cap)
    return (jcols, jvalid), (tcols, tvalid)


@pytest.mark.parametrize("case", ["hash", "bcast"])
@pytest.mark.parametrize("cap", [32, 1024])
def test_dsj_pipeline(index, case, cap):
    """project_unique -> exchange -> probe_and_reply -> finalize_join, as
    the executor chains them, at a capacity that overflows and one that
    does not: every intermediate equals the JAX stage's."""
    d, js, ts = index
    if case == "hash":  # q9: (x advisor y) |><| (y teacherOf z) on y = S
        first, nxt = ("?x", "ub:advisor", "?y"), ("?y", "ub:teacherOf", "?z")
        c1, c2, append = 1, 0, (2,)
    else:  # q7: (x takesCourse y) |><| (Prof teacherOf y) on y = O
        first, nxt = ("?x", "ub:takesCourse", "?y"), \
            ("Prof0.1.2", "ub:teacherOf", "?y")
        c1, c2, append = 1, 2, ()
    (jcols, jvalid), (tcols, tvalid) = _first(d, js, ts, first, 1024)
    jproj = JD.project_unique(jcols, jvalid, c1, cap)
    tproj = TD.project_unique(tcols, tvalid, c1, cap)
    _assert_same(tproj, jproj)
    if case == "hash":
        jx = JD.exchange_hash(jproj[0], jproj[1], cap)
        tx = TD.exchange_hash(tproj[0], tproj[1], cap)
    else:
        jx = JD.exchange_broadcast(jproj[0], jproj[1])
        tx = TD.exchange_broadcast(tproj[0], tproj[1])
    _assert_same(tx, jx)
    jq, tq = _pat(d, *nxt)
    jspec, tspec = JD.PatternSpec.of(jq), TD.PatternSpec.of(tq)
    jc, tc = JD.pattern_consts(jq), TD.pattern_consts(tq, "cpu")
    jr = JD.probe_and_reply(js, jx[0], jx[1], jc, jspec, c2, cap, cap)
    tr = TD.probe_and_reply(ts, tx[0], tx[1], tc, tspec, c2, cap, cap)
    _assert_same(tr, jr)
    _assert_same(
        TD.finalize_join(tcols, tvalid, tr[0], tr[1], c1, c2, (), append,
                         cap),
        JD.finalize_join(jcols, jvalid, jr[0], jr[1], c1, c2, (), append,
                         cap))


#: (first pattern, join pattern, c2, append) of each case of the prefix test;
#: the join runs broadcast on ?y, so a value's candidates come from every
#: replier holding it
PREFIX_CASES = {
    # many students a course, over every worker: keys tie across repliers
    "ties": (("?x", "ub:takesCourse", "?y"), ("?z", "ub:takesCourse", "?y"),
             2, (0,)),
    # one professor's courses sit on one worker: the other rows get nothing
    "empty_row": (("Prof0.0.0", "ub:teacherOf", "?y"),
                  ("?z", "ub:takesCourse", "?y"), 2, (0,)),
    # no course has an advisor: mc = 0
    "mc0": (("?x", "ub:takesCourse", "?y"), ("?y", "ub:advisor", "?z"), 0,
            (2,)),
    # the reply buckets sized to their fullest: mc = cap_cand
    "mc_full": (("?x", "ub:takesCourse", "?y"),
                ("?z", "ub:takesCourse", "?y"), 2, (0,)),
}


@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_finalize_prefix_equals_full_row(index, case):
    """``finalize_join`` and ``finalize_join_batch`` with ``cap_live =
    quantize_capacity(mc)`` equal the same calls over whole buckets, on
    ``probe_and_reply`` outputs: the filled prefix holds every live
    candidate, in the order the stable sort keeps."""
    d, js, ts = index
    first, nxt, c2, append = PREFIX_CASES[case]
    _, (cols, valid) = _first(d, js, ts, first, 1024)
    proj, pvalid, _ = TD.project_unique(cols, valid, cols.shape[-1] - 1, 1024)
    recv, rvalid, _ = TD.exchange_broadcast(proj, pvalid)
    _, tq = _pat(d, *nxt)
    spec, consts = TD.PatternSpec.of(tq), TD.pattern_consts(tq, "cpu")
    cap_cand = 1024
    cand, cvalid, _, mf, mc = TD.probe_and_reply(ts, recv, rvalid, consts,
                                                 spec, c2, 4096, cap_cand)
    if case == "mc_full":
        cap_cand = int(mc)
        cand, cvalid, _, mf, mc = TD.probe_and_reply(
            ts, recv, rvalid, consts, spec, c2, 4096, cap_cand)
    mc = int(mc)
    assert int(mf) <= 4096 and mc <= cap_cand
    cap_live = quantize_capacity(mc)
    if case == "ties":  # one sender's key from two repliers
        keys = [[set(cand[s, r, :, c2][cvalid[s, r]].tolist())
                 for r in range(W)] for s in range(W)]
        assert any(k[r] & k[r2] for k in keys for r in range(W)
                   for r2 in range(r))
    if case == "empty_row":
        live = cvalid.sum(dim=(1, 2))
        assert int(live.min()) == 0 < int(live.max())
    assert mc == 0 if case == "mc0" else mc > 0
    assert (cap_live >= cap_cand) if case == "mc_full" else \
        (cap_live < cap_cand)
    args = (c2, (), append, 2048)
    whole = TD.finalize_join(cols, valid, cand, cvalid, cols.shape[-1] - 1,
                             *args)
    _assert_same(TD.finalize_join(cols, valid, cand, cvalid,
                                  cols.shape[-1] - 1, *args, cap_live), whole)
    if case != "mc0":
        assert int(whole[1].sum()) > 0
    two = lambda x: torch.stack([x, x])
    batch = (two(cols), two(valid), two(cand), two(cvalid),
             cols.shape[-1] - 1) + args
    _assert_same(TD.finalize_join_batch(*batch, cap_live),
                 TD.finalize_join_batch(*batch))


@pytest.mark.parametrize("cap", [16, 1024])
def test_local_probe_join_and_chain(index, cap):
    """Case (i): (x type Student) |><| (x takesCourse y) |><| (x advisor z)
    on the pinned subject, stage by stage and as one fused chain."""
    d, js, ts = index
    pats = [("?x", "rdf:type", "ub:Student"), ("?x", "ub:takesCourse", "?y"),
            ("?x", "ub:advisor", "?z")]
    both = [_pat(d, *p) for p in pats]
    (jcols, jvalid), (tcols, tvalid) = _first(d, js, ts, pats[0], 1024)
    jsteps, tsteps = [], []
    for i, (jq, tq) in enumerate(both[1:]):
        width = 1 + i
        j_step = JD.ChainStep(JD.PatternSpec.of(jq), 0, 0, (), (2,))
        t_step = TD.ChainStep(TD.PatternSpec.of(tq), 0, 0, (), (2,))
        jsteps.append(j_step)
        tsteps.append(t_step)
        jout = JD.local_probe_join(js, jcols, jvalid, JD.pattern_consts(jq),
                                   j_step.spec, 0, 0, (), (2,), cap)
        tout = TD.local_probe_join(ts, tcols, tvalid,
                                   TD.pattern_consts(tq, "cpu"), t_step.spec,
                                   0, 0, (), (2,), cap)
        _assert_same(tout, jout)
        assert tout[0].shape[-1] == width + 1
        jcols, jvalid = jout[0], jout[1]
        tcols, tvalid = tout[0], tout[1]
    jconsts = jnp.stack([JD.pattern_consts(jq) for jq, _ in both])
    tconsts = torch.stack([TD.pattern_consts(tq, "cpu") for _, tq in both])
    caps = (1024, cap, cap)
    jq0, tq0 = both[0]
    jchain = JD.local_chain(js, jconsts, JD.PatternSpec.of(jq0), (0,),
                            tuple(jsteps), caps)
    tchain = TD.local_chain(ts, tconsts, TD.PatternSpec.of(tq0), (0,),
                            tuple(tsteps), caps)
    _assert_same(tchain, jchain)
    seed_j, seed_t = jchain[0][0], tchain[0][0]
    _assert_same(
        TD.local_chain_from(ts, seed_t[0], seed_t[1], tconsts[1:],
                            tuple(tsteps), caps[1:]),
        JD.local_chain_from(js, seed_j[0], seed_j[1], jconsts[1:],
                            tuple(jsteps), caps[1:]))


def test_warm_chain_query_makes_one_host_sync():
    d, triples = lubm_like(3, 2, 3, 4, 2)
    eng = AdHashEngine(triples, W, adaptive=False, device="cpu")
    star = TQuery([
        TTP(TV("x"), TC(d.lookup("rdf:type")), TC(d.lookup("ub:Student"))),
        TTP(TV("x"), TC(d.lookup("ub:takesCourse")), TV("c")),
        TTP(TV("x"), TC(d.lookup("ub:advisor")), TV("p")),
    ])
    cold, _ = eng.query(star)
    with trace_host_syncs() as t:
        rel, st = eng.query(star)
    assert st.route == "single-local-main" and st.mode == "parallel"
    assert t.host_transfers == 1
    assert rel.to_set() == cold.to_set() and len(rel.to_set()) > 0
