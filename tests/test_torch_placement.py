"""The port's placement layer and hot-key rebalancing against the JAX
package's, bit for bit.

Same numpy inputs through ``repro`` (``probe_backend="searchsorted"``) and
the port on ``device="cpu"``: the owner functions of a seeded directory
table (``owner_dest``, ``triple_dest``, ``value_dests``, ``place_triples_np``,
``owner_np``), the table's capacity classes, ``placement_state`` across the
two packages, the directory hash exchange, ``rebalance_deferred``, and the
directory engine — sequential and through ``query_batch`` — with its
skew detector: answers, ``comm_cells``, mode, route, ``n_retries``,
``n_rebalances``, ``rebalance_comm_cells``, the split entries, the placement
and pattern-index fingerprints, the five main-store tensors and
``load_balance``.  Integer outputs: nothing here has a tolerance.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro.core import dsj as JD
from repro.core import placement as JP
from repro.core.engine import AdHashEngine as JEngine
from repro.core.ingest import StreamIngestor as JIngestor
from repro.core.substrate import SingleDeviceSubstrate as JSub
from repro.data import synthetic_rdf as jdata
from repro.data.synthetic_rdf import Workload, lubm_like, zipf_skew, \
    zipf_workload
from repro_torch.core import dsj as TD
from repro_torch.core import placement as TP
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.ingest import StreamIngestor
from repro_torch.core.query import Query as TQuery
from repro_torch.data import synthetic_rdf as tdata

_DICT, _TRIPLES = lubm_like(2, 2, 2, 2)
# the reference tests' skew shape (tests/test_recovery.py)
_SKEW = dict(n_subjects=64, n_triples=4000, n_objects=64, n_predicates=8,
             exponent=1.8, seed=0)
_SKEW_KW = dict(frequency_threshold=3, capacity=256, skew_threshold=1.2)


def _port(q):
    return TQuery.from_json(q.to_json())


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stores_equal(j_store, t_store, what) -> None:
    for name, a, b in zip(("spo_ps", "keys_ps", "spo_po", "keys_po",
                           "counts"), j_store.tree_flatten()[0],
                          t_store.leaves()):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{what}: {name}")


def _seeded_pair(w: int, n_entries: int, seed: int):
    """The same directory table in both packages: random subjects with
    random split factors (up to the policy maximum)."""
    rng = np.random.default_rng(seed)
    j, t = JP.DirectoryPlacement(w), TP.DirectoryPlacement(w)
    assert j.max_split == t.max_split
    subs = rng.choice(1 << 20, n_entries, replace=False)
    logfs = rng.integers(0, j.max_split.bit_length(), n_entries)
    for s, lf in zip(subs, logfs):
        assert j.add_splits([s], logf=int(lf)) == \
            t.add_splits([s], logf=int(lf))
    return j, t, subs


# ------------------------------------------------------ the owner functions
@pytest.mark.parametrize("w", [3, 4, 6, 8])
def test_owner_functions_match_reference(w):
    """owner_dest, triple_dest and value_dests on table subjects, subjects
    not in the table and invalid lanes; then place_triples_np and
    owner_np.  The port takes any leading shape: (R, n) rows equal the
    reference's row by row."""
    j, t, subs = _seeded_pair(w, 40, seed=w)
    rng = np.random.default_rng(100 + w)
    r, n = 3, 500
    vals = rng.integers(0, 1 << 20, (r, n)).astype(np.int32)
    vals[:, :120] = rng.choice(subs, (r, 120))  # table hits
    vals[:, 120:130] = -1  # a projection's padding
    objs = rng.integers(0, 1 << 30, (r, n)).astype(np.int32)
    valid = rng.random((r, n)) < 0.85
    valid[:, 120:130] = False
    jt, tt = j.device_table(), t.device_table("cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    js, ts = j.stage_spec, t.stage_spec
    assert (ts.kind, ts.n_workers, ts.max_split) == \
        (js.kind, js.n_workers, js.max_split)
    t_v, t_o, t_m = (torch.from_numpy(x) for x in (vals, objs, valid))
    t_owner = ts.owner_dest(t_v, t_m, tt)
    t_trip = ts.triple_dest(t_v, t_o, t_m, tt)
    t_dests, t_dvalid = ts.value_dests(t_v, t_m, tt)
    assert t_dests.shape == (r, ts.max_split, n)
    for i in range(r):
        jv, jo, jm = (jnp.asarray(x[i]) for x in (vals, objs, valid))
        np.testing.assert_array_equal(t_owner[i].numpy(),
                                      _np(js.owner_dest(jv, jm, jt)))
        np.testing.assert_array_equal(t_trip[i].numpy(),
                                      _np(js.triple_dest(jv, jo, jm, jt)))
        jd, jdv = js.value_dests(jv, jm, jt)
        np.testing.assert_array_equal(t_dests[i].numpy(), _np(jd))
        np.testing.assert_array_equal(t_dvalid[i].numpy(), _np(jdv))
    assert (t_dvalid.sum(dim=1) > 1).any()  # some values really fan out
    triples = np.stack([vals.reshape(-1), np.zeros(r * n, np.int64),
                        objs.reshape(-1)], axis=1).astype(np.int64)
    np.testing.assert_array_equal(t.place_triples_np(triples),
                                  j.place_triples_np(triples))
    np.testing.assert_array_equal(t.owner_np(vals), j.owner_np(vals))
    assert [t.split_factor(s) for s in subs[:10]] == \
        [j.split_factor(s) for s in subs[:10]]
    assert t.fingerprint() == j.fingerprint()


def test_hash_placement_and_empty_table_match_reference():
    """Hash placement has no spec or table; a directory table with no entry
    is all padding and places every triple on its hash owner."""
    h = TP.HashPlacement(5)
    assert h.stage_spec is None and h.device_table("cpu") is None
    rng = np.random.default_rng(3)
    triples = rng.integers(0, 1 << 30, (1000, 3)).astype(np.int64)
    np.testing.assert_array_equal(h.place_triples_np(triples),
                                  JP.HashPlacement(5).place_triples_np(
                                      triples))
    np.testing.assert_array_equal(h.owner_np(triples[:, 0]),
                                  JP.HashPlacement(5).owner_np(triples[:, 0]))
    j, t = JP.DirectoryPlacement(5), TP.DirectoryPlacement(5)
    for a, b in zip(j.device_table(), t.device_table("cpu")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(t.place_triples_np(triples),
                                  h.place_triples_np(triples))
    assert t.fingerprint() == j.fingerprint()
    assert TP.resolve_placement(None, 5).fingerprint() == ("hash", 5)
    with pytest.raises(ValueError, match="workers"):
        TP.resolve_placement(t, 4)
    with pytest.raises(ValueError, match="unknown"):
        TP.resolve_placement("range", 4)


def test_table_capacity_growth_matches_reference():
    """Power-of-two capacity classes (floor 64) and the version counter as
    the table grows; the device table is rebuilt only when the version
    moves, and its contents are the reference's."""
    j, t = JP.DirectoryPlacement(8), TP.DirectoryPlacement(8)
    subs = np.arange(1000, 1300)
    seen = []
    for lo, hi in ((0, 1), (1, 63), (63, 64), (64, 65), (65, 200),
                   (150, 260)):
        before = t.device_table("cpu")
        assert t.device_table("cpu") is before  # cached within a version
        assert j.add_splits(subs[lo:hi]) == t.add_splits(subs[lo:hi])
        assert (t.version, t.table_capacity()) == \
            (j.version, j.table_capacity())
        after = t.device_table("cpu")
        assert after is not before
        for a, b in zip(j.device_table(), after):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        seen.append(t.table_capacity())
    assert seen == [64, 64, 64, 128, 256, 512]
    assert t.add_splits(subs[:5]) == [] and t.version == j.version
    with pytest.raises(ValueError, match="split factor"):
        t.add_splits([1], logf=4)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("new_w", [None, 3])
def test_placement_state_crosses_packages(writer, new_w):
    """``placement_state`` written by one package and read by the other:
    equal fingerprints at the same W, and the same re-derived table at
    W' = 3 (base shards under the new modulus, factors clamped)."""
    j, t, _ = _seeded_pair(8, 30, seed=11)
    state = (JP if writer == "repro" else TP).placement_state(
        j if writer == "repro" else t)
    assert JP.placement_state(j) == TP.placement_state(t)
    got = TP.placement_from_state(state, new_w)
    want = JP.placement_from_state(state, new_w)
    assert got.fingerprint() == want.fingerprint()
    if new_w is None:
        assert got.fingerprint() == t.fingerprint()
    else:
        assert got.w == 3 and set(got.entries) == set(t.entries)
    hash_state = TP.placement_state(TP.HashPlacement(6))
    assert hash_state == JP.placement_state(JP.HashPlacement(6))
    assert TP.placement_from_state(hash_state, new_w).fingerprint() == \
        JP.placement_from_state(hash_state, new_w).fingerprint()


# ------------------------------------------------ data, ingest and the DSJ
def test_zipf_skew_and_split_candidates_match_reference():
    for kw in (_SKEW, dict(n_subjects=300, n_triples=20_000,
                           n_objects=1 << 21, n_predicates=4, exponent=1.8,
                           seed=3)):
        got, want = tdata.zipf_skew(**kw), jdata.zipf_skew(**kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    triples = zipf_skew(**_SKEW)
    plc_j, plc_t = JP.DirectoryPlacement(4), TP.DirectoryPlacement(4)
    ji = JIngestor(4, placement=plc_j, substrate=JSub())
    ti = StreamIngestor(4, placement=plc_t)
    for i in range(0, len(triples), 700):
        ji.add_chunk(triples[i:i + 700])
        ti.add_chunk(triples[i:i + 700])
    for k_max in (64, 5):
        (js, jd), (ts, td) = ji.split_candidates(k_max), \
            ti.split_candidates(k_max)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(td, jd)
    assert StreamIngestor(4, placement=plc_t).split_candidates() is None


@pytest.mark.parametrize("batched", [False, True])
def test_directory_hash_exchange_matches_reference(batched):
    """exchange_hash / exchange_hash_batch under a directory spec: each
    value fans out to its split set in one bucket_by_dest launch of F*n
    rows; recv, recv_valid, cells and max_bucket equal the reference's."""
    w, b, n, cap_peer = 4, 3, 64, 64
    j, t, subs = _seeded_pair(w, 12, seed=5)
    rng = np.random.default_rng(9)
    proj = rng.integers(0, 1 << 20, (b, w, n)).astype(np.int32)
    proj[..., :20] = rng.choice(subs, (b, w, 20))
    valid = rng.random((b, w, n)) < 0.8
    proj = np.where(valid, proj, -1).astype(np.int32)
    jt, tt = j.device_table(), t.device_table("cpu")
    if batched:
        got = TD.exchange_hash_batch(torch.from_numpy(proj),
                                     torch.from_numpy(valid), cap_peer,
                                     spec=t.stage_spec, table=tt)
        want = JD.exchange_hash_batch(jnp.asarray(proj), jnp.asarray(valid),
                                      cap_peer, spec=j.stage_spec, table=jt)
    else:
        got = TD.exchange_hash(torch.from_numpy(proj[0]),
                               torch.from_numpy(valid[0]), cap_peer,
                               spec=t.stage_spec, table=tt)
        want = JD.exchange_hash(jnp.asarray(proj[0]), jnp.asarray(valid[0]),
                                cap_peer, spec=j.stage_spec, table=jt)
    for g, wnt, name in zip(got, want, ("recv", "recv_valid", "cells",
                                         "max_bucket")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                      err_msg=name)
    # a cap_peer that the fan-out overflows reports the true maximum
    small = TD.exchange_hash(torch.from_numpy(proj[0]),
                             torch.from_numpy(valid[0]), 8,
                             spec=t.stage_spec, table=tt)
    assert int(small[3]) == int(got[3].reshape(-1)[0]) > 8


def _rebalance(eng, subjects):
    """Split ``subjects`` on an engine and move its main store."""
    eng.placement.add_splits(subjects)
    store, moved = eng.ird.rebalance_deferred(eng.placement).finalize()
    eng._publish_store(store)
    return moved


def _hub_subjects(triples, k: int) -> np.ndarray:
    deg = np.bincount(triples[:, 0])
    return np.argsort(-deg, kind="stable")[:k]


def test_rebalance_deferred_matches_reference():
    """IRD's main-store move: the five rebuilt tensors, the moved cells,
    and counts equal to the placement's own census of the triples."""
    kw = dict(adaptive=False, capacity=256, placement="directory")
    j = JEngine(_TRIPLES, 4, probe_backend="searchsorted", **kw)
    t = AdHashEngine(_TRIPLES, 4, device="cpu", **kw)
    hubs = _hub_subjects(_TRIPLES, 5)
    assert _rebalance(t, hubs) == _rebalance(j, hubs) > 0
    _stores_equal(j.store, t.store, "rebalanced store")
    np.testing.assert_array_equal(
        t.store.counts.numpy(),
        np.bincount(t.placement.place_triples_np(_TRIPLES), minlength=4))


def _lockstep(j, t, queries, batched: bool) -> None:
    if batched:
        jres = j.query_batch(queries)
        tres = t.query_batch([_port(q) for q in queries])
    else:
        jres = [j.query(q) for q in queries]
        tres = [t.query(_port(q)) for q in queries]
    for q, (jr, js), (tr, ts) in zip(queries, jres, tres):
        assert tr.to_set() == jr.to_set(), q.name
        assert (ts.comm_cells, ts.mode, ts.route, ts.n_retries, ts.plan) == \
            (js.comm_cells, js.mode, js.route, js.n_retries, js.plan), q.name
    assert t.pattern_index.fingerprint() == j.pattern_index.fingerprint()
    assert t.placement.fingerprint() == j.placement.fingerprint()
    for f in ("n_queries", "comm_cells", "n_parallel", "n_parallel_replica",
              "n_distributed", "n_redistributions", "ird_comm_cells",
              "n_rebalances", "rebalance_comm_cells", "n_batch_dispatches"):
        assert getattr(t.report, f) == getattr(j.report, f), f


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_directory_engine_matches_reference(adaptive, batched):
    """A seeded directory engine on the LUBM-like graph, its five hub
    subjects split and its store moved: case (i) demoted to hash DSJ and
    every staged exchange fanning out, through ``query`` or
    ``query_batch``."""
    kw = dict(adaptive=adaptive, frequency_threshold=2, capacity=256,
              placement="directory")
    j = JEngine(_TRIPLES, 4, probe_backend="searchsorted", **kw)
    t = AdHashEngine(_TRIPLES, 4, device="cpu", **kw)
    assert not t.placement.local_join_safe
    hubs = _hub_subjects(_TRIPLES, 5)
    _rebalance(j, hubs)
    _rebalance(t, hubs)
    queries = Workload(_DICT, seed=4).sample(10) * 2
    _lockstep(j, t, queries, batched)
    assert any(st.n_dsj for st in [t.query(_port(q))[1]
                                   for q in queries[:6]])


@pytest.mark.parametrize("batched", [False, True])
def test_skew_detector_matches_reference(batched):
    """The hub-triples skew detector: the same subjects split at the same
    query, the same store moves (five tensors), the same load balance —
    and a directory store whose counts are the placement's census."""
    triples = zipf_skew(**_SKEW)
    queries = zipf_workload(40, n_subjects=64, n_predicates=8, exponent=1.8,
                            seed=1)
    kw = dict(placement="directory", **_SKEW_KW)
    j = JEngine(triples, 4, probe_backend="searchsorted", **kw)
    t = AdHashEngine(triples, 4, device="cpu", **kw)
    before = int(t.store.counts.max())
    _lockstep(j, t, queries, batched)
    assert t.report.n_rebalances >= 1
    assert t.placement.entries == j.placement.entries
    _stores_equal(j.store, t.store, "main store after the rebalances")
    assert t.load_balance() == j.load_balance()
    assert int(t.store.counts.max()) < before
    np.testing.assert_array_equal(
        t.store.counts.numpy(),
        np.bincount(t.placement.place_triples_np(triples), minlength=4))


def test_hash_engine_never_rebalances():
    """Hash placement cannot split: the same skew, no rebalance in either
    package, and no split-candidate pool is built."""
    triples = zipf_skew(**_SKEW)
    queries = zipf_workload(12, n_subjects=64, n_predicates=8, exponent=1.8,
                            seed=1)
    j = JEngine(triples, 4, probe_backend="searchsorted", **_SKEW_KW)
    t = AdHashEngine(triples, 4, device="cpu", **_SKEW_KW)
    lb = t.load_balance()
    assert lb["max"] > _SKEW_KW["skew_threshold"] * lb["mean"]
    _lockstep(j, t, queries, False)
    assert t.report.n_rebalances == j.report.n_rebalances == 0
    assert t._split_candidates is None
    assert t.load_balance() == j.load_balance()
