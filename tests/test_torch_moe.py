"""The port's MoE family, partitioning baselines and tuned-kernel table
against the JAX package, on the CPU.

Inputs are made from a seed with numpy; MoE weights are made by the JAX
package and carried across as numpy.  The JAX side runs without a mesh.

Tolerances: ``moe_ffn``'s output 1e-4 in float32 and 2e-2 in bfloat16
(atol = rtol, the repository's ``TOL``); its diagnostics (``dropped``,
``expert_load``, ``route_counts``) and ``slot_map_for_plan`` bit-exact; the
train step's loss and grad_norm 1e-5 relative (float32, summation order);
the partitioning baselines and the tuned table bit-exact.

bf16 near-ties: the router's logits are bf16 values, so two gates of a
token can be equal or one bf16 rounding apart, and the two packages' bf16
products may round one logit differently.  Where a token's set of top-k
experts differs between the packages, the test shows that the reference's
gap between its k-th and (k+1)-th gate is below one bf16 ulp, then holds
the other tokens' rows to the tolerance (a token's output depends only on
its own routes while no token is dropped).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax
import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import partition as JP
from repro.data.synthetic_rdf import lubm_like, zipf_skew
from repro.data.tokens import make_batch as jax_make_batch
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import moe as JM
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim import adamw as JO
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import partition as TP
from repro_torch.data.tokens import make_batch
from repro_torch.kernels import build, tuning
from repro_torch.launch.train import make_train_step
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MOE_ARCHS = ["qwen2-moe-a2.7b", "moonshot-v1-16b-a3b"]


def _cfgs(arch: str, dtype: str, **moe):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return jcfg, tcfg


def _moe_pair(jcfg, seed: int = 0):
    """The reference's MoE parameters and the port's ``MoE`` holding them."""
    jp = JM.init_moe(jax.random.key(seed), jcfg)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    tp = TM.MoE({k: t(v) for k, v in jp.items() if k != "shared"},
                SwiGLU({k: t(v) for k, v in jp["shared"].items()}))
    return jp, tp


def _top_sets(gates: np.ndarray, k: int) -> list[frozenset]:
    """Each token's set of top-k experts, the lower expert first among
    equal gates (``jax.lax.top_k``'s order)."""
    order = np.argsort(-gates, axis=1, kind="stable")[:, :k]
    return [frozenset(row.tolist()) for row in order]


def _routes(jp, tp, x: np.ndarray, jcfg, tcfg):
    """Per-token top-k sets of each package, and the reference's gates,
    each from its own router product (``moe.py``'s first lines)."""
    jx = jnp.asarray(x, jcfg.cdtype).reshape(-1, x.shape[-1])
    jgates = np.asarray(jax.nn.softmax(
        (jx @ jp["router"].astype(jx.dtype)).astype(jnp.float32), axis=-1))
    tx = torch.from_numpy(x).to(tcfg.cdtype).reshape(-1, x.shape[-1])
    with torch.no_grad():
        tgates = torch.softmax((tx @ tp.router.to(tx.dtype)).float(),
                               dim=-1).numpy()
    k = jcfg.moe.top_k
    return _top_sets(jgates, k), _top_sets(tgates, k), jgates


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _check_moe(jp, tp, x, jcfg, tcfg, slot_map, dtype):
    """The port's ``moe_ffn`` against the reference's (the near-tie rule
    above); returns the port's diagnostics."""
    jo, jd = jax.jit(JM.moe_ffn, static_argnums=(2, 3))(
        jp, jnp.asarray(x, JDT[dtype]), jcfg, slot_map)
    with torch.no_grad():
        to, td = TM.moe_ffn(tp, torch.from_numpy(x).to(TDT[dtype]), tcfg,
                            slot_map)
    assert to.dtype == TDT[dtype] and to.shape == x.shape
    jsets, tsets, jgates = _routes(jp, tp, x, jcfg, tcfg)
    differ = [i for i, (a, b) in enumerate(zip(jsets, tsets)) if a != b]
    keep = np.ones(len(jsets), bool)
    if differ:
        assert dtype == "bfloat16", differ  # float32 routes alike
        assert int(jd["dropped"]) == 0  # rows stay independent
        k = jcfg.moe.top_k
        for i in differ:
            g = np.sort(jgates[i])[::-1]
            assert g[k - 1] - g[k] < _bf16_ulp(g[k - 1]), (i, g)
        keep[differ] = False
    else:
        for name in ("dropped", "expert_load", "route_counts"):
            np.testing.assert_array_equal(td[name].numpy(),
                                          np.asarray(jd[name]), err_msg=name)
    got = to.float().numpy().reshape(len(keep), -1)[keep]
    want = np.asarray(jo, np.float32).reshape(len(keep), -1)[keep]
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    return td, differ


# ----------------------------------------------------- (a) moe_ffn itself
@pytest.mark.parametrize("plan", ["none", "experts01", "hottest2"])
@pytest.mark.parametrize("shape", [(2, 8), (4, 32), (5, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_jax(dtype, shape, plan):
    """Outputs within TOL, diagnostics bit-exact, with no plan, the plan
    (0, 1) of tests/test_adaptive.py and the two hottest experts of the
    no-plan load; (5, 1) is a decode step's (B, 1)."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", dtype)
    jp, tp = _moe_pair(jcfg, seed=len(shape) + shape[1])
    x = np.random.default_rng(shape[0] * 100 + shape[1]).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    e = jcfg.moe.n_experts
    slot_map = None
    if plan == "experts01":
        slot_map = TM.slot_map_for_plan(e, (0, 1))
    elif plan == "hottest2":
        d0, _ = _check_moe(jp, tp, x, jcfg, tcfg, None, dtype)
        hot = tuple(np.argsort(-d0["expert_load"].numpy(),
                               kind="stable")[:2].tolist())
        slot_map = TM.slot_map_for_plan(e, hot)
    td, _ = _check_moe(jp, tp, x, jcfg, tcfg, slot_map, dtype)
    assert td["expert_load"].shape == (len(slot_map or range(e)),)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_drops_like_jax(dtype):
    """capacity_factor 0.5: tokens are dropped, and the count, the loads
    and the outputs (dropped contributions absent) are the reference's."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", dtype, capacity_factor=0.5)
    jp, tp = _moe_pair(jcfg, seed=3)
    x = np.random.default_rng(3).normal(
        size=(4, 32, jcfg.d_model)).astype(np.float32)
    for slot_map in (None, TM.slot_map_for_plan(jcfg.moe.n_experts, (2, 5))):
        td, differ = _check_moe(jp, tp, x, jcfg, tcfg, slot_map, dtype)
        assert not differ and int(td["dropped"]) > 0


def test_moe_ffn_is_deterministic_and_remat_free_of_bmm():
    """Two calls give the same bits; the "dots" policy saves the router
    and shared-expert products (mm) and not the batched expert products."""
    from repro_torch.models import transformer as TT

    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "bfloat16")
    _, tp = _moe_pair(jcfg)
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, 16, tcfg.d_model)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        a, _ = TM.moe_ffn(tp, x, tcfg)
        b, _ = TM.moe_ffn(tp, x, tcfg)
    assert torch.equal(a, b)
    assert torch.ops.aten.bmm.default not in TT._DOTS


def test_slot_map_for_plan_matches_jax():
    for e, hot in ((8, ()), (8, (0, 1)), (60, (7, 3, 59, 0, 1, 2, 30, 31))):
        assert TM.slot_map_for_plan(e, hot) == JM.slot_map_for_plan(e, hot)


# ------------------- (b) the counterparts of tests/test_adaptive.py:144-183
def test_moe_hot_expert_replication_preserves_output():
    """With ample capacity, replicating hot experts keeps the output
    (replica slots compute with identical weights) and the replica slots
    take load; the reference agrees on both."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "bfloat16")
    model = build_model(tcfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.key(0))), tcfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 8, tcfg.d_model)).astype(np.float32)).to(tcfg.cdtype)
    moe = params.blocks[0].moe
    slot_map = TM.slot_map_for_plan(tcfg.moe.n_experts, (0, 1))
    with torch.no_grad():
        base, d0 = TM.moe_ffn(moe, x, tcfg, slot_map=None)
        rep, d1 = TM.moe_ffn(moe, x, tcfg, slot_map=slot_map)
    assert model.cfg is tcfg
    assert int(d0["dropped"]) == 0 and int(d1["dropped"]) == 0
    np.testing.assert_allclose(base.float().numpy(), rep.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    assert d1["expert_load"][tcfg.moe.n_experts:].sum() > 0


def test_moe_replication_reduces_peak_slot_load():
    """Replicating the two hottest experts lowers (never raises) the peak
    per-slot load, at the reference test's shapes and seeds."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "bfloat16")
    params = params_from_numpy(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.key(1))), tcfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 32, tcfg.d_model)).astype(np.float32)).to(tcfg.cdtype)
    moe = params.blocks[0].moe
    with torch.no_grad():
        _, d0 = TM.moe_ffn(moe, x, tcfg)
        load0 = d0["expert_load"].numpy()
        hot = tuple(np.argsort(-load0)[:2].tolist())
        _, d1 = TM.moe_ffn(moe, x, tcfg, TM.slot_map_for_plan(
            tcfg.moe.n_experts, hot))
    load1 = d1["expert_load"].numpy()
    assert load1.max() <= load0.max()
    assert load1[tcfg.moe.n_experts:].sum() > 0


# ------------------------------------------- (c) configs and the model API
def test_moe_configs_match_jax():
    from repro.configs import get_config as jax_get_config

    for arch in MOE_ARCHS:
        for get, jget in ((get_config, jax_get_config),
                          (get_smoke_config, jax_smoke_config)):
            mine, theirs = (dataclasses.asdict(get(arch)),
                            dataclasses.asdict(jget(arch)))
            assert all(theirs[k] is None for k in set(theirs) - set(mine))
            assert mine == {k: theirs[k] for k in mine}, arch
        full, jfull = get_config(arch), jax_get_config(arch)
        assert full.param_count() == jfull.param_count()
        assert full.active_param_count() == jfull.active_param_count()
        assert full.adaptive.expert_replication == 8
    assert get_config("qwen2-moe-a2.7b").param_count() == 14_315_585_536


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_tree_and_init(arch):
    """The port's parameters name the reference's leaves (the shared
    expert under ``blocks/moe/shared``), with the reference's shapes, and
    ``init`` draws every leaf on the generator's device."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jp = jax_build_model(jcfg).init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    got = params_to_numpy(tp)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    fresh = build_model(tcfg, device="cpu").init(0)
    assert jax.tree.map(np.shape, params_to_numpy(fresh)) == \
        jax.tree.map(np.shape, want)
    assert sum(p.numel() for p in fresh.parameters()) == \
        sum(np.size(a) for a in jax.tree.leaves(want))


# ------------------------------ (d) a train step (tests/test_system.py:80)
def test_moe_train_steps_match_jax_and_loss_falls():
    """The mesh-free counterpart of tests/test_system.py::
    test_lm_train_step_under_local_mesh: qwen2-moe's smoke config (float32
    compute), lr 5e-3, six steps on one batch; step 1's loss and grad_norm
    against the reference's, and the loss falls."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", "float32")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ocfg = AdamWConfig(lr=5e-3)
    jstep = jax.jit(jax_make_train_step(jm, JO.AdamWConfig(lr=5e-3)))
    tstep = make_train_step(tm, ocfg)
    jb = jax_make_batch(jcfg, 4, 32, 0)
    tb = make_batch(tcfg, 4, 32, 0, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    _, _, jmet = jstep(jp, JO.adamw_init(jp), jb)
    opt = adamw_init(tp)
    losses = []
    for i in range(6):
        tp, opt, met = tstep(tp, opt, tb)
        losses.append(float(met["loss"]))
        if i == 0:
            np.testing.assert_allclose(losses[0], float(jmet["loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(met["grad_norm"]),
                                       float(jmet["grad_norm"]), rtol=1e-5)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_moe_clis_run_without_jax(cli):
    """``--arch qwen2-moe-a2.7b --smoke --device cpu`` through each CLI in
    a fresh interpreter, with neither jax nor the JAX package imported;
    moonshot through the serve CLI too."""
    runs = {"serve": ["['--arch', 'qwen2-moe-a2.7b', '--smoke', '--device',"
                      " 'cpu', '--steps', '3', '--batches', '2']",
                      "['--arch', 'moonshot-v1-16b-a3b', '--smoke',"
                      " '--device', 'cpu', '--steps', '2', '--batches', '2']"],
            "train": ["['--arch', 'qwen2-moe-a2.7b', '--smoke', '--steps',"
                      " '2', '--batch', '2', '--seq', '16', '--device',"
                      " 'cpu']"]}[cli]
    code = (
        "import sys\n"
        f"from repro_torch.launch import {cli}\n"
        + "".join(f"{cli}.main({a})\n" for a in runs)
        + "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.models.moe' in sys.modules\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen2-moe-a2.7b device=cpu" in out.stdout
    if cli == "serve":
        assert "arch=moonshot-v1-16b-a3b device=cpu" in out.stdout
    else:
        assert "done" in out.stdout


# ------------------------------------------ (e) the partitioning baselines
def _partition_inputs(name: str) -> np.ndarray:
    if name == "lubm":
        return lubm_like(2, 2, 2, 2)[1]
    return zipf_skew(n_subjects=64, n_triples=4000, n_objects=64,
                     n_predicates=8, exponent=1.8, seed=0)


@pytest.mark.parametrize("w", [1, 3, 8])
@pytest.mark.parametrize("data", ["lubm", "zipf"])
def test_partition_baselines_bit_exact(data, w):
    """Every assignment, its BalanceReport row and mincut_lite's edge cut
    equal the reference's (bench_startup.py's calls)."""
    triples = _partition_inputs(data)
    n_ids = int(triples.max()) + 1
    for name, kw in (("partition_by_subject", {}),
                     ("partition_by_subject", {"mix": False}),
                     ("partition_by_object", {}),
                     ("partition_random", {"seed": 3}),
                     ("mincut_lite", {"n_ids": n_ids, "passes": 8}),
                     ("mincut_lite", {"seed": 1, "passes": 2})):
        got = getattr(TP, name)(triples, w, **kw)
        want = getattr(JP, name)(triples, w, **kw)
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {kw}")
        assert TP.partition_balance(got, w).as_row() == \
            JP.partition_balance(want, w).as_row()
    label = np.zeros(n_ids, dtype=np.int32)
    label[triples[:, 0]] = TP.mincut_lite(triples, w, n_ids=n_ids)
    assert TP.edge_cut(triples, label) == JP.edge_cut(triples, label)
    assert TP.edge_cut(triples[:0], label) == JP.edge_cut(triples[:0],
                                                          label) == 0.0


# ------------------------------------------------- (f) the tuned table
@pytest.fixture
def tuned_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ADHASH_TUNED_DIR", str(tmp_path))
    yield tmp_path
    tuning._load_table.cache_clear()


def test_default_tiles_are_the_sources_constants():
    """With no table the build defines each tile as its source's own
    ``#ifndef`` default, and the Python mirrors give the same tiles."""
    table = tuning.tuned_table("sm90")
    assert table == tuning.DEFAULTS
    assert build.defines(table) == ["-DADHASH_SCAN_ITEMS=8",
                                    "-DADHASH_RADIX_ITEMS=16"]
    assert build._tiles(table) == (8192, 4096)
    for src, macro, value in (("common.cuh", "ADHASH_SCAN_ITEMS", 8),
                              ("compact.cu", "ADHASH_RADIX_ITEMS", 16)):
        text = (build.CSRC / src).read_text()
        assert f"#ifndef {macro}\n#define {macro} {value}\n#endif" in text


def test_tuned_dir_is_honoured_and_changes_build_key(tuned_dir):
    """ADHASH_TUNED_DIR is read on every call; a saved table changes the
    build key, the -D flags and the Python mirrors together (no nvcc)."""
    base_key = build._digest(tuning.DEFAULTS)
    assert tuning.tuned_path() == tuned_dir / "sm90.json"
    assert tuning.tuned_table() == tuning.DEFAULTS
    path = tuning.save_tuned({"scan": {"items": 4}}, meta={"by": "test"})
    assert path == tuned_dir / "sm90.json"
    assert json.loads(path.read_text())["platform"] == "sm90"
    table = tuning.tuned_table()  # the cache was cleared by save_tuned
    assert table["scan"] == {"items": 4}
    assert table["unique_compact"] == {"items": 16}
    assert tuning.block_config("scan") == {"items": 4}
    with pytest.raises(KeyError, match="unknown kernel"):
        tuning.block_config("semijoin_probe")
    assert build.defines(build._build_table()) == [
        "-DADHASH_SCAN_ITEMS=4", "-DADHASH_RADIX_ITEMS=16"]
    assert build._tiles(table) == (4096, 4096)
    assert build._digest(build._build_table()) != base_key == \
        build._digest(tuning.DEFAULTS)
    tuning.save_tuned({"unique_compact": {"items": 8}}, platform="cpu")
    assert tuning.tuned_table("cpu")["unique_compact"] == {"items": 8}
    assert build._tiles(tuning.tuned_table("cpu")) == (8192, 2048)


def test_unreadable_table_falls_back_to_defaults(tuned_dir):
    (tuned_dir / "sm90.json").write_text("{not json")
    assert tuning.tuned_table() == tuning.DEFAULTS
    assert build.defines(build._build_table()) == \
        build.defines(tuning.DEFAULTS)


def test_save_adaptivity_writes_the_tuned_table(tmp_path):
    """The snapshot holds ``tuned/<platform>.json`` in the loader's format
    and the manifest the same table under the platform, as the
    reference's does; pointing ADHASH_TUNED_DIR at it loads it."""
    from repro.checkpoint.checkpoint import CheckpointManager as JManager
    from repro.core.engine import AdHashEngine as JEngine
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.core.engine import AdHashEngine

    triples = lubm_like(2, 2, 2, 2)[1]
    snaps = {}
    for pkg, Eng, Mgr, kw in (("j", JEngine, JManager,
                               {"probe_backend": "searchsorted"}),
                              ("t", AdHashEngine, CheckpointManager,
                               {"device": "cpu"})):
        mgr = Mgr(tmp_path / pkg)
        mgr.save_adaptivity(Eng(triples, 4, capacity=256, **kw), step=1)
        snaps[pkg] = mgr.load_adaptivity()
    for m in snaps.values():
        tuned = Path(m["_dir"]) / "tuned"
        assert [p.name for p in tuned.iterdir()] == ["cpu.json"]
        on_disk = json.loads((tuned / "cpu.json").read_text())
        assert on_disk == {"platform": "cpu", "kernels": m["tuned"]["cpu"]}
    assert snaps["t"]["tuned"] == {"cpu": tuning.DEFAULTS}
    try:
        os.environ["ADHASH_TUNED_DIR"] = str(Path(snaps["t"]["_dir"]) /
                                             "tuned")
        assert tuning.tuned_table("cpu") == tuning.DEFAULTS
    finally:
        del os.environ["ADHASH_TUNED_DIR"]


def test_moe_cuda_entry_points_without_a_card_raise(monkeypatch):
    """No fallback: the moe archs' entry points default to the card and
    raise where there is none, as the dense ones do."""
    from repro_torch.models import transformer as TT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in MOE_ARCHS:
        cfg = get_smoke_config(arch)
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            make_batch(cfg, 1, 4, 0)
        with pytest.raises(RuntimeError, match="cuda"):
            params_from_numpy({}, cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            TT.init_lm_cache(cfg, 1, 4)
