"""The port's non-adaptive engine against the JAX package's, end to end.

Same triples, same queries, ``adaptive=False`` on both sides, the port on
``device="cpu"``: answers (``Relation.to_set()``), ``comm_cells``, mode,
route and ``n_retries`` must be equal query by query — on the paper's
running example and on a ``lubm_like(2, 2, 2, 2)`` workload over all six
templates, under the default settings and the paper's ablations, and
along the overflow-retry ladder.  Also: the port imports neither jax nor
``repro``, it raises on what it has not ported yet (the mesh substrates)
and builds a directory-placement engine, and ``device="cuda"`` without a
card raises.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paper_example import expected_fig2, load_example, prof_query, \
    prof_query3
from repro.core.engine import AdHashEngine as JEngine
from repro.core.query import TriplePattern as JTP
from repro.core.query import Var as JV
from repro.core.query import Query as JQuery
from repro.data.synthetic_rdf import lubm_like, lubm_queries
from repro_torch.core.engine import AdHashEngine
from repro_torch.core.health import HealthState
from repro_torch.core.query import Query as TQuery
from repro_torch.core.query import Var as TV

ROOT = Path(__file__).resolve().parents[1]


def _port(q: JQuery) -> TQuery:
    """The same query in the port's own query classes."""
    return TQuery.from_json(q.to_json())


def _assert_engines_agree(j_eng, t_eng, queries) -> list:
    stats = []
    for q in queries:
        jrel, jst = j_eng.query(q)
        trel, tst = t_eng.query(_port(q))
        assert trel.to_set() == jrel.to_set(), q.name
        assert (tst.comm_cells, tst.mode, tst.route, tst.n_retries,
                tst.n_dsj, tst.n_local_joins, tst.plan) == \
            (jst.comm_cells, jst.mode, jst.route, jst.n_retries,
             jst.n_dsj, jst.n_local_joins, jst.plan), q.name
        stats.append(tst)
    for f in ("n_queries", "n_parallel", "n_distributed", "comm_cells"):
        assert getattr(t_eng.report, f) == getattr(j_eng.report, f), f
    return stats


def test_paper_example_matches_reference():
    d, triples = load_example()
    star = JQuery([JTP(JV("s"), prof_query(d).patterns[1].p, JV("p")),
                   JTP(JV("s"), prof_query3(d).patterns[2].p, JV("u"))],
                  name="star")
    queries = [prof_query(d), prof_query3(d), star]
    for w in (2, 3):
        j_eng = JEngine(triples, w, adaptive=False)
        t_eng = AdHashEngine(triples, w, adaptive=False, device="cpu")
        stats = _assert_engines_agree(j_eng, t_eng, queries)
        assert stats[2].route == "single-local-main"
        rel, _ = t_eng.query(_port(prof_query(d)))
        got = {tuple(r) for r in rel.project_to([TV("prof"), TV("stud")])
               .tolist()}
        assert got == expected_fig2(d)


CONFIGS = {  # the paper's ablations (§6.3.1) and the chain route off
    "default": {},
    "no_locality": {"locality_aware": False},
    "no_pinned": {"pinned_opt": False},
    "no_chain": {"local_chain": False},
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_lubm_workload_matches_reference(config):
    d, triples = lubm_like(2, 2, 2, 2)
    queries = [t.make(c) for t in lubm_queries(d).values()
               for c in t.constants[:3]]
    assert len({q.name for q in queries}) == 6
    kw = CONFIGS[config]
    j_eng = JEngine(triples, 4, adaptive=False, **kw)
    t_eng = AdHashEngine(triples, 4, adaptive=False, device="cpu", **kw)
    stats = _assert_engines_agree(j_eng, t_eng, queries)
    if config == "default":
        assert {s.route for s in stats} == {"", "single-local-main"}


def test_retry_ladder_matches_reference():
    """At capacity 64 the shards outgrow the first capacity class: staged
    and chain routes walk the same power-of-two ladder, with equal
    ``n_retries`` and answers."""
    d, triples = lubm_like(3, 2, 3, 4, 2)
    j_eng = JEngine(triples, 2, adaptive=False)
    t_eng = AdHashEngine(triples, 2, adaptive=False, device="cpu")
    retries = 0
    for t in lubm_queries(d).values():
        jq = t.make(t.constants[0])
        tq = _port(jq)
        jp, tp = j_eng.planner.plan(jq), t_eng.planner.plan(tq)
        assert (tp.ordering, [v.name for v in tp.join_vars]) == \
            (jp.ordering, [v.name for v in jp.join_vars])
        jrel, jst = j_eng.executor.execute(jq, jp.ordering, jp.join_vars,
                                           capacity=64)
        trel, tst = t_eng.executor.execute(tq, tp.ordering, tp.join_vars,
                                           capacity=64)
        assert trel.to_set() == jrel.to_set()
        assert (tst.n_retries, tst.comm_cells, tst.route) == \
            (jst.n_retries, jst.comm_cells, jst.route)
        retries += tst.n_retries
    assert retries > 0, "capacity 64 did not exercise the ladder"


def test_dark_shard_demotes_chain_to_staged_route():
    """While a shard is dark the fused chain route is demoted to the staged
    path, with the same answers and the ``single-degraded`` route tag."""
    d, triples = lubm_like(2, 2, 2, 2)
    t = lubm_queries(d)["q1"]
    queries = [t.make(c) for c in t.constants[:2]]
    j_eng = JEngine(triples, 4, adaptive=False)
    t_eng = AdHashEngine(triples, 4, adaptive=False, device="cpu")
    assert isinstance(t_eng.health, HealthState)
    assert t_eng.executor.health is t_eng.health
    for q in queries:
        assert t_eng.query(_port(q))[1].route == "single-local-main"
    j_eng.health.mark_failed(1)
    t_eng.health.mark_failed(1)
    for q in queries:
        jrel, jst = j_eng.query(q)
        trel, tst = t_eng.query(_port(q))
        assert tst.route == jst.route == "single-degraded"
        assert trel.to_set() == jrel.to_set()
        assert (tst.mode, tst.comm_cells, tst.n_retries) == \
            (jst.mode, jst.comm_cells, jst.n_retries)


def test_ingest_stream_equals_one_shot():
    d, triples = lubm_like(2, 2, 2, 2)
    one = AdHashEngine(triples, 4, adaptive=False, device="cpu")
    chunks = [triples[i:i + 50] for i in range(0, len(triples), 50)]
    streamed = AdHashEngine.ingest_stream(chunks, 4, adaptive=False,
                                          device="cpu")
    for name in ("spo_ps", "keys_ps", "spo_po", "keys_po", "counts"):
        assert torch.equal(getattr(one.store, name),
                           getattr(streamed.store, name))
    for t in lubm_queries(d).values():
        q = _port(t.make(t.constants[0]))
        assert one.query(q)[0].to_set() == streamed.query(q)[0].to_set()


def test_unported_options_raise():
    """No engine option is unported any more: the directory placement
    builds on the CPU, with and without adaptivity, and so does a mesh
    substrate over a world-size-1 gloo group (the same store)."""
    _, triples = lubm_like(1, 1, 1, 1)
    for adaptive in (False, True):
        eng = AdHashEngine(triples, 2, adaptive=adaptive,
                           placement="directory", device="cpu")
        assert eng.placement.name == "directory"
        assert not eng.placement.local_join_safe
        assert eng._split_candidates is not None
        assert int(eng.store.counts.sum()) == len(np.unique(triples, axis=0))
    import torch.distributed as dist

    from repro_torch.core.substrate import MeshSubstrate

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        MeshSubstrate(device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = AdHashEngine(triples, 2, adaptive=False, device="cpu",
                            substrate=MeshSubstrate(device="cpu"))
        assert mesh.substrate.name == "mesh"
        single = AdHashEngine(triples, 2, adaptive=False, device="cpu")
        for a, b in zip(mesh.store.host_leaves(), single.store.leaves()):
            np.testing.assert_array_equal(a, b.numpy())
    finally:
        dist.destroy_process_group()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, triples = lubm_like(1, 1, 1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        AdHashEngine(triples, 2, adaptive=False)  # device defaults to cuda
    from repro_torch.core.triples import ShardedTripleStore

    z = np.zeros((1, 1, 3), np.int32)
    k = np.zeros((1, 1), np.int64)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedTripleStore.from_numpy(z, k, z, k, np.zeros(1, np.int32), 1)


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_repro_import_in_port_sources():
    """No import statement of the port or of chip_smoke.py names jax or
    repro (lazy imports inside functions included)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
