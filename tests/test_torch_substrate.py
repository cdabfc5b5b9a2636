"""The port's mesh substrate in one process, against the JAX package.

A world-size-1 gloo group (built and left by a fixture) runs the mesh's
collective code path for real: every exchange is an ``all_to_all_single``,
every broadcast an ``all_gather_into_tensor``, every cross-rank total or
cell count an ``all_reduce`` at the host's read, each with one rank.  Held
here:

  * the substrate API (the default single device, ``shard_store`` /
    ``shard_relation`` round trips, worker counts the mesh does not divide,
    the degenerate ``DistributedSubstrate``), the launcher's argv split and
    env protocol -- the counterparts of ``tests/test_substrate_mesh.py``'s
    and ``tests/test_multihost.py``'s in-process tests;
  * every mesh stage against the single-device stage on the same inputs,
    and which collectives it issues (``trace_collectives``): ``all_to_all``
    at every hash exchange and reply route, ``all_gather`` at every
    broadcast, none in the stage bodies of the shard-local route and the
    fused chains -- single and batched; the port's counterpart of the
    reference's compiled-HLO assertions;
  * the mesh engine against ``repro``'s single-device engine (W = 4,
    ``lubm_like(2, 2, 2, 2)``), sequential and batched across the adaptive
    lifecycle: answers, ``comm_cells``, modes, routes (the substrate name
    aside), ``n_retries``, reports and pattern-index fingerprints; and one
    host sync (one ``all_reduce``, at the sync) per warm chain query.

Two processes are ``tests/test_torch_multihost.py``'s.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core  # noqa: F401  (x64 on, as the reference runs)
from repro.core.engine import AdHashEngine as JEngine
from repro.data.synthetic_rdf import Workload as JWorkload
from repro_torch.core import dsj
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.query import Const, Query, TriplePattern, Var
from repro_torch.core.relation import Relation
from repro_torch.core.substrate import (DistributedSubstrate, MeshSubstrate,
                                        SingleDeviceSubstrate, Substrate,
                                        trace_collectives, trace_host_syncs)
from repro_torch.data.synthetic_rdf import lubm_like, lubm_queries
from repro_torch.launch import multihost
from repro_torch.launch.__main__ import _split_target
from repro_torch.launch.multihost import init_from_env, launch_localhost

from reference import match_query

_DICT, _TRIPLES = lubm_like(2, 2, 2, 2)
_KW = dict(adaptive=True, frequency_threshold=2, capacity=256)


def _port(q):
    return Query.from_json(q.to_json())


def _suffix(route: str) -> str:
    return route.split("-", 1)[1] if route else route


def _answer(rel, st) -> tuple:
    return (rel.to_set(), st.comm_cells, st.mode, _suffix(st.route),
            st.n_retries)


# ------------------------------------------------------ no process group
def test_init_from_env_without_coordinator_is_noop(monkeypatch):
    monkeypatch.delenv("ADHASH_COORDINATOR", raising=False)
    assert init_from_env(device="cpu") is False
    assert not dist.is_initialized()


def test_split_target_module_form():
    opts, target = _split_target(
        ["--nprocs", "2", "--device", "cpu", "-m", "mod", "--flag"])
    assert opts == ["--nprocs", "2", "--device", "cpu"]
    assert target == ["-m", "mod", "--flag"]


def test_split_target_script_form():
    opts, target = _split_target(["--nprocs=2", "w.py", "--x", "1"])
    assert opts == ["--nprocs=2"]
    assert target == ["w.py", "--x", "1"]


def test_launch_localhost_rejects_zero_processes():
    with pytest.raises(ValueError, match="n_processes"):
        launch_localhost(0, ["-m", "x"], device="cpu")


def test_default_substrate_is_single_device():
    eng = AdHashEngine(_TRIPLES, 3, adaptive=False, capacity=256,
                       device="cpu")
    assert isinstance(eng.substrate, SingleDeviceSubstrate)
    assert eng.substrate.n_devices == 1 and eng.substrate.mesh is None
    # one substrate instance serves the whole engine
    assert eng.executor.sub is eng.substrate
    assert eng.parallel_exec.sub is eng.substrate
    assert eng.ird.sub is eng.substrate
    assert eng.replicas.sub is eng.substrate
    assert eng.store.mesh is None and eng.store.n_workers == 3
    # the base substrate binds the module-level stages themselves
    assert Substrate.match_first is dsj.match_first
    assert Substrate.exchange_hash is dsj.exchange_hash


# ------------------------------------------------- a world-size-1 group
@pytest.fixture(scope="module")
def group():
    """A world-size-1 gloo group for the module, then none."""
    assert not dist.is_initialized()
    multihost.ensure_initialized(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    yield
    multihost.shutdown()
    assert not dist.is_initialized()


@pytest.fixture
def mesh(group):
    return MeshSubstrate(device="cpu")


def test_mesh_substrate_parity_sequential(mesh):
    """Mesh engine == the reference's single device, query by query, across
    the adaptive lifecycle (distributed -> IRD -> parallel-replica)."""
    qs = JWorkload(_DICT, seed=7).sample(4) * 2
    ref = JEngine(_TRIPLES, 4, probe_backend="searchsorted", **_KW)
    eng = AdHashEngine(_TRIPLES, 4, substrate=mesh, device="cpu", **_KW)
    got = [_answer(*eng.query(_port(q))) for q in qs]
    want = [_answer(*ref.query(q)) for q in qs]
    assert got == want
    assert any(a[2] == "parallel-replica" for a in got)
    assert any(a[1] > 0 for a in got), "the workload never communicated"
    for f in ("comm_cells", "ird_comm_cells", "ird_triples",
              "n_redistributions", "n_parallel_replica"):
        assert getattr(eng.report, f) == getattr(ref.report, f), f
    assert eng.pattern_index.fingerprint() == ref.pattern_index.fingerprint()
    assert eng.load_balance() == ref.load_balance()
    for q in qs[:4]:
        rel, st = eng.query(_port(q))
        assert st.route.startswith("mesh") or st.route == ""
        assert set(map(tuple, rel.project_to(_port(q).vars))) == \
            match_query(_TRIPLES, q), q.name


def test_mesh_substrate_parity_batched(mesh):
    """``query_batch`` on the mesh == the reference's sequential single
    device, down to the pattern-index fingerprint and replica footprint."""
    qs = JWorkload(_DICT, seed=13).sample(5) * 2
    ref = JEngine(_TRIPLES, 4, probe_backend="searchsorted", **_KW)
    eng = AdHashEngine(_TRIPLES, 4, substrate=mesh, device="cpu", **_KW)
    want = [_answer(*ref.query(q))[:3] for q in qs]
    got = [_answer(*r)[:3] for r in eng.query_batch([_port(q) for q in qs])]
    assert got == want
    assert eng.pattern_index.fingerprint() == ref.pattern_index.fingerprint()
    np.testing.assert_array_equal(eng.replicas.per_worker_triples(),
                                  ref.replicas.per_worker_triples())


def test_mesh_substrate_shard_store_roundtrip(mesh):
    eng = AdHashEngine(_TRIPLES, 4, adaptive=False, capacity=256,
                       device="cpu")
    placed = mesh.shard_store(eng.store)
    assert placed.mesh is mesh and placed.n_workers == 4
    assert mesh.shard_store(placed) is placed  # already this mesh's
    np.testing.assert_array_equal(placed.to_numpy(), eng.store.to_numpy())
    assert placed.n_ids == eng.store.n_ids
    for a, b in zip(placed.host_leaves(), eng.store.leaves()):
        np.testing.assert_array_equal(a, b.numpy())
    assert mesh.local_worker_slice(4) == slice(0, 4)
    (q,) = JWorkload(_DICT, seed=3).sample(1)
    rel, _ = eng.query(_port(q))
    placed_rel = mesh.shard_relation(rel)
    assert placed_rel.mesh is mesh and placed_rel.vars == rel.vars
    assert placed_rel.to_set() == rel.to_set()
    other = MeshSubstrate(device="cpu")
    with pytest.raises(ValueError, match="another mesh"):
        other.shard_store(placed)
    with pytest.raises(ValueError, match="another mesh"):
        other.shard_relation(placed_rel)


def test_mesh_substrate_rejects_indivisible_workers(mesh, monkeypatch):
    """A worker count the mesh size does not divide is refused, by the
    substrate and by the engine (mesh size 2 by hand: one rank here)."""
    monkeypatch.setattr(mesh, "n_devices", 2)
    mesh.check_workers(4)
    with pytest.raises(ValueError, match="divisible"):
        mesh.check_workers(3)
    with pytest.raises(ValueError, match="divisible"):
        AdHashEngine(_TRIPLES, 3, substrate=mesh, device="cpu", **_KW)
    with pytest.raises(ValueError, match="1/2 share"):
        mesh.globalize_worker_array(np.zeros((4, 2), np.int32), 4)


def test_degenerate_distributed_substrate_is_mesh(group):
    """Without a coordinator the distributed substrate is a one-rank mesh
    named "distributed": the collective path, the same answers."""
    sub = DistributedSubstrate(device="cpu")
    assert sub.name == "distributed"
    assert sub.n_processes == 1 and sub.process_id == 0
    assert sub.local_worker_slice(4) == slice(0, 4)
    kw = dict(adaptive=False, capacity=256, device="cpu")
    a = AdHashEngine(_TRIPLES, 4, substrate=MeshSubstrate(device="cpu"),
                     **kw)
    b = AdHashEngine.ingest_stream(np.array_split(_TRIPLES, 5), 4,
                                   substrate=sub, **kw)
    for x, y in zip(a.store.leaves(), b.store.leaves()):
        assert torch.equal(x, y)
    adv = _DICT.lookup("ub:advisor")
    q = Query([TriplePattern(Var("x"), Const(adv), Var("y"))])
    (ra, sa), (rb, sb) = a.query(q), b.query(q)
    assert ra.to_set() == rb.to_set() and sa.comm_cells == sb.comm_cells
    assert sb.route == "distributed-local-main"


# ------------------------------------------- each stage, its collectives
def _stage_inputs():
    """Inputs of every stage at W = 4: a store, a first match of
    (?x advisor ?y), its projection on ?y, and the exchanges of a join with
    (?y worksFor ?z) -- ?y a subject, so the hash route."""
    eng = AdHashEngine(_TRIPLES, 4, adaptive=False, capacity=256,
                       device="cpu")
    store = eng.store
    adv, works = _DICT.lookup("ub:advisor"), _DICT.lookup("ub:worksFor")
    first = TriplePattern(Var("x"), Const(adv), Var("y"))
    join = TriplePattern(Var("y"), Const(works), Var("z"))
    spec, jspec = dsj.PatternSpec.of(first), dsj.PatternSpec.of(join)
    c1, c2 = dsj.pattern_consts(first, "cpu"), dsj.pattern_consts(join, "cpu")
    cols, valid, _ = dsj.match_first(store, c1, spec, 64)
    proj, pvalid, _ = dsj.project_unique(cols, valid, 1, 64)
    recv, rvalid, _, _ = dsj.exchange_hash(proj, pvalid, 64)
    cand, cvalid, *_ = dsj.probe_and_reply(store, recv, rvalid, c2, jspec,
                                           0, 256, 64)
    step = dsj.ChainStep(jspec, 1, 0, (), (2,))
    b = 2
    bt = lambda *xs: [torch.stack([x, x]) for x in xs]
    bcols, bvalid, bproj, bpvalid, brecv, brvalid, bcand, bcvalid = bt(
        cols, valid, proj, pvalid, recv, rvalid, cand, cvalid)
    bc1, bc2 = c1.expand(b, 3), c2.expand(b, 3)
    chain_c = torch.stack([c1, c2])
    return {
        "match_rows": ((store, c1, spec, 64), 0),
        "match_first": ((store, c1, spec, 64), 0),
        "project_unique": ((cols, valid, 1, 64), 0),
        "exchange_hash": ((proj, pvalid, 64), 2),
        "exchange_broadcast": ((proj, pvalid), 2),
        "probe_and_reply": ((store, recv, rvalid, c2, jspec, 0, 256, 64), 2),
        "finalize_join": ((cols, valid, cand, cvalid, 1, 0, (), (2,), 256),
                          0),
        "local_probe_join": ((store, cols, valid, c2, jspec, 1, 0, (), (2,),
                              256), 0),
        "match_first_local": ((store, c1, spec, 64), 0),
        "local_probe_join_local": ((store, cols, valid, c2, jspec, 1, 0, (),
                                    (2,), 256), 0),
        "local_chain": ((store, chain_c, spec, (0, 1), (step,), (64, 256)),
                        0),
        "local_chain_from": ((store, cols, valid, chain_c[1:], (step,),
                              (256,)), 0),
        "match_first_batch": ((store, bc1, spec, 64), 0),
        "project_unique_batch": ((bcols, bvalid, 1, 64), 0),
        "exchange_hash_batch": ((bproj, bpvalid, 64), 2),
        "exchange_broadcast_batch": ((bproj, bpvalid), 2),
        "probe_and_reply_batch": ((store, brecv, brvalid, bc2, jspec, 0, 256,
                                   64), 2),
        "finalize_join_batch": ((bcols, bvalid, bcand, bcvalid, 1, 0, (),
                                 (2,), 256), 0),
        "local_probe_join_batch": ((store, bcols, bvalid, bc2, jspec, 1, 0,
                                    (), (2,), 256), 0),
        "local_chain_batch": ((store, chain_c.expand(b, 2, 3), spec, (0, 1),
                               (step,), (64, 256)), 0),
        "local_chain_from_batch": ((store, bcols, bvalid,
                                    chain_c[1:].expand(b, 1, 3), (step,),
                                    (256,)), 0),
    }


_INPUTS: dict | None = None

# (all_to_all, all_gather) a stage body issues on the mesh: the exchanges
# ship values and masks; every other stage issues none.  No stage body
# all_reduces: the host reduces totals and cells at its reads
_EXPECTED = {
    "match_rows": (0, 0), "match_first": (0, 0), "project_unique": (0, 0),
    "exchange_hash": (2, 0), "exchange_broadcast": (0, 2),
    "probe_and_reply": (2, 0), "finalize_join": (0, 0),
    "local_probe_join": (0, 0), "match_first_local": (0, 0),
    "local_probe_join_local": (0, 0), "local_chain": (0, 0),
    "local_chain_from": (0, 0), "match_first_batch": (0, 0),
    "project_unique_batch": (0, 0), "exchange_hash_batch": (2, 0),
    "exchange_broadcast_batch": (0, 2), "probe_and_reply_batch": (2, 0),
    "finalize_join_batch": (0, 0), "local_probe_join_batch": (0, 0),
    "local_chain_batch": (0, 0), "local_chain_from_batch": (0, 0),
}


def _flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [y for x in out for y in _flat(x)]
    return [out]


@pytest.mark.parametrize("stage", sorted(_EXPECTED))
def test_mesh_stage_matches_single_and_its_collectives(mesh, stage):
    """Each mesh stage's outputs equal the single-device stage's (totals
    and cells as values), and its body issues the collectives of
    ``_EXPECTED`` -- all_to_all at the hash exchange and reply route,
    all_gather at the broadcast, none on the shard-local route."""
    global _INPUTS
    if _INPUTS is None:
        _INPUTS = _stage_inputs()
    args, _ = _INPUTS[stage]
    if stage in ("match_rows", "match_first", "match_first_local",
                 "local_probe_join", "local_probe_join_local", "local_chain",
                 "local_chain_from", "probe_and_reply", "match_first_batch",
                 "probe_and_reply_batch", "local_probe_join_batch",
                 "local_chain_batch", "local_chain_from_batch"):
        args = (mesh.shard_store(args[0]),) + args[1:]
    want = _flat(getattr(SingleDeviceSubstrate(), stage)(*_INPUTS[stage][0]))
    with trace_collectives() as tc:
        got = _flat(getattr(mesh, stage)(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dim() == 0:
            assert int(g) == int(w)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)
    a2a, ag = _EXPECTED[stage]
    assert tc.count("all_to_all", "stage") == a2a
    assert tc.count("all_gather", "stage") == ag
    assert tc.count("all_reduce") == 0
    assert tc.count(where="host") == 0


def test_mesh_block_transpose_matches_the_transpose(mesh):
    """One rank: the receiver-major all_to_all is the global transpose, for
    every layout the stages hand it (bool masks included)."""
    g = torch.Generator().manual_seed(0)
    for k in (0, 1, 2):
        # (*batch, W_local_send, W, *rest); W == W_local on one rank
        x = torch.randint(0, 99, (3,) * k + (4, 4, 5, 2), generator=g,
                          dtype=torch.int32)
        got = mesh._block_transpose(x, k)
        assert torch.equal(got, x.transpose(k, k + 1))
        assert torch.equal(mesh._block_transpose(x > 50, k),
                           (x > 50).transpose(k, k + 1))
        # a strided view, as the batched reply route hands it
        y = x.transpose(-1, -2)
        assert torch.equal(mesh._block_transpose(y, k),
                           y.transpose(k, k + 1))


# ------------------------------------------------ engine-level collectives
def test_warm_chain_query_one_host_sync_one_host_all_reduce(mesh):
    """A warm case-(i) chain: the fused route, one host sync, and its only
    collective the all_reduce at that sync; a pattern-index hit issues no
    collective in a stage body either."""
    star = lubm_queries(_DICT)["q1"].instantiate(np.random.default_rng(3))
    eng = AdHashEngine(_TRIPLES, 4, substrate=mesh, device="cpu",
                       **dict(_KW, frequency_threshold=100))
    single = AdHashEngine(_TRIPLES, 4, device="cpu",
                          **dict(_KW, frequency_threshold=100))
    rel, st = eng.query(star)
    assert st.route == "mesh-local-main" and st.comm_cells == 0
    assert rel.to_set() == single.query(star)[0].to_set()
    with trace_host_syncs() as tr, trace_collectives() as tc:
        eng.query(star)
    assert tr.host_transfers == 1
    assert dict(tc.counts) == {("all_reduce", "host"): 1}

    adv = _DICT.lookup("ub:advisor")
    hot = Query([TriplePattern(Var("x"), Const(adv), Var("y"))], name="hot")
    eng2 = AdHashEngine(_TRIPLES, 4, substrate=mesh, device="cpu", **_KW)
    for _ in range(3):
        rel, st = eng2.query(hot)
    assert st.mode == "parallel-replica" and st.route == "mesh-local"
    with trace_collectives() as tc:
        rel2, st2 = eng2.query(hot)
    assert rel2.to_set() == rel.to_set() and st2.comm_cells == 0
    assert tc.count(where="stage") == 0 and tc.count(where="host") >= 1


def test_staged_query_collectives(mesh):
    """A query with a hash DSJ and one with a broadcast DSJ: all_to_all at
    each hash exchange and reply route, all_gather at each broadcast."""
    adv, works = _DICT.lookup("ub:advisor"), _DICT.lookup("ub:worksFor")
    member = _DICT.lookup("ub:memberOf")
    hashq = Query([TriplePattern(Var("x"), Const(adv), Var("y")),
                   TriplePattern(Var("y"), Const(works), Var("z"))])
    bcastq = Query([TriplePattern(Var("x"), Const(adv), Var("y")),
                    TriplePattern(Var("w"), Const(member), Var("y"))])
    kw = dict(adaptive=False, capacity=256, device="cpu")
    eng = AdHashEngine(_TRIPLES, 4, substrate=mesh, **kw)
    single = AdHashEngine(_TRIPLES, 4, **kw)
    for q, gathers in ((hashq, 0), (bcastq, 2)):
        with trace_collectives() as tc:
            rel, st = eng.query(q)
        rel_s, st_s = single.query(q)
        assert (rel.to_set(), st.comm_cells, st.n_dsj) == \
            (rel_s.to_set(), st_s.comm_cells, st_s.n_dsj)
        assert st.n_dsj == 1
        # the reply route always; the hash exchange unless broadcast
        assert tc.count("all_to_all", "stage") == (2 if gathers else 4)
        assert tc.count("all_gather", "stage") == gathers
    rel = eng.query(hashq)[0]
    assert isinstance(rel, Relation) and rel.mesh is mesh
