"""The port's mesh and cache options on the serving path (ROADMAP 12d.1)
against the JAX package, on the CPU.

Multi-rank legs run as ``tests/test_torch_multihost.py`` runs its own: one
``launch_localhost(4, ..., device="cpu")`` run of a torch-only child (4
gloo ranks: meshes (1, 4) and (2, 2)) and one of 2 ranks (mesh (1, 2)),
each with a timeout.  Their reference outputs come from one JAX
subprocess with 4 forced host devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4``, as ``tests/test_adaptive.py``
runs its multi-device test), which runs beside them.  Inputs and weights
are made here, from seeds, and handed to all three as numpy.

Counterparts of the reference's tests: ``test_adaptive.py``'s
``adaptive_embed`` single-device, overflow and multi-device tests, and
``test_optimizations.py::test_serve_loop_runs_with_controller`` (on a
world-size-1 gloo mesh, in process).  The reference's multi-device test
takes ``jax.grad`` through ``adaptive_embed``'s ``shard_map``, which fails
under jax 0.9 (ROADMAP §3), so the port's gradient is held to
``jax.grad`` of the plain ``embed``.

Tolerances: embedding rows, overflow counts, specs and plans are
bit-exact; the gradient 1e-6; ``moe_ffn_sharded`` in float32 1e-5; the
2-layer float32 ``lm_forward`` under all options 1e-4 and its loss 1e-5
relative (two layers of float32 products summed in another order, as
``tests/test_torch_lm.py`` holds float32 models).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax
import jax.numpy as jnp

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.adaptive import AdaptiveShardingController as JaxController
from repro.launch import mesh as JMESH
from repro.launch import shardings as JSH
from repro.models import embedding as JE
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, SHAPES, get_smoke_config
from repro_torch.core.adaptive import AdaptiveShardingController
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import shardings as TSH
from repro_torch.launch.multihost import launch_localhost
from repro_torch.launch.serve import serve_loop
from repro_torch.models import embedding as TE
from repro_torch.models import moe as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe_sharded import moe_ffn_sharded
from repro_torch.models.transformer import RuntimeOptions

ROOT = Path(__file__).resolve().parents[1]
SHAPES_4 = ((1, 4), (2, 2))
HOT = tuple(range(48))  # the reference test's plan
PLAN = (1, 5)  # hot experts given a replica slot
LEG_TIMEOUT = 240


def _f32(name: str):
    """The JAX and port smoke configs of ``name`` in float32."""
    return (dataclasses.replace(jax_smoke_config(name), dtype="float32"),
            dataclasses.replace(get_smoke_config(name), dtype="float32"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_module(p: dict) -> TM.MoE:
    t = lambda a: torch.from_numpy(np.array(a))
    return TM.MoE({k: t(p[k]) for k in ("router", "w1", "w3", "w2")},
                  SwiGLU({k: t(v) for k, v in p["shared"].items()})
                  if "shared" in p else None)


# ------------------------------------------------------------- the inputs
@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> tuple[dict, Path]:
    """Seeded inputs and weights (numpy), written for the three runs."""
    cfg = jax_smoke_config("llama3-8b")
    mcfg, _ = _f32("qwen2-moe-a2.7b")
    rng = np.random.default_rng(0)
    v = cfg.vocab_size
    lm_tokens = rng.integers(0, v, (2, 32))
    inp = {
        "table": np.asarray(JE.init_embedding(jax.random.key(0), cfg)
                            ["table"]),
        "ids": rng.integers(0, v, (4, 16)),
        "cold_ids": rng.integers(64, v, (4, 16)),  # all cold
        "moe": _np_tree(JM.init_moe(jax.random.key(1), mcfg)),
        "moe_x": rng.normal(size=(4, 8, mcfg.d_model)).astype(np.float32),
        "slot_map": JM.slot_map_for_plan(mcfg.moe.n_experts, PLAN),
        "lm": _np_tree(JT.init_lm(jax.random.key(2), mcfg)),
        "lm_tokens": lm_tokens,
        "lm_labels": rng.integers(0, v, (2, 32)),
        "lm_hot": tuple(int(i) for i in np.unique(lm_tokens)[::2]),
        # each of 4 pod ranks' own gradients and error-feedback residuals
        "pod": {"g": {"a": rng.normal(size=(4, 8, 16)).astype(np.float32),
                      "b": rng.normal(size=(4, 5)).astype(np.float32)},
                "r": {"a": (rng.normal(size=(4, 8, 16)) * 1e-3
                            ).astype(np.float32),
                      "b": (rng.normal(size=(4, 5)) * 1e-3
                            ).astype(np.float32)}},
    }
    path = tmp_path_factory.mktemp("mesh") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, path


_REF = textwrap.dedent(
    r'''
    import os
    import pickle
    import sys

    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.core  # noqa: F401
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.models.common import shard_map
    from repro.optim import compression as JC
    from repro.models import transformer as JT
    from repro.models.embedding import adaptive_embed, embed
    from repro.models.moe_sharded import moe_ffn_sharded

    assert len(jax.devices()) == 4
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    out = {}

    def mesh(shape):
        n = shape[0] * shape[1]
        return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    cfg = get_smoke_config("llama3-8b")
    p = {"table": jnp.asarray(inp["table"])}
    for shape in ((1, 4), (2, 2)):
        for case, hot, cap, key in (("main", tuple(range(48)), 64, "ids"),
                                    ("overflow", (), 4, "cold_ids")):
            o, over = jax.jit(lambda q, i: adaptive_embed(
                q, i, cfg, hot, cap, mesh(shape)))(
                    p, jnp.asarray(inp[key], jnp.int32))
            out[("embed", shape, case)] = (np.asarray(o, np.float32),
                                           int(over))
    ids = jnp.asarray(inp["ids"], jnp.int32)
    out["plain_embed"] = np.asarray(embed(p, ids, cfg), np.float32)
    out["grad"] = np.asarray(jax.grad(lambda q: jnp.sum(
        embed(q, ids, cfg).astype(jnp.float32) ** 2))(p)["table"])

    mcfg = get_smoke_config("qwen2-moe-a2.7b")
    mcfg = mcfg.__class__(**{**mcfg.__dict__, "dtype": "float32"})
    for shape in ((1, 4), (2, 2)):
        for plan in (None, tuple(inp["slot_map"])):
            out[("moe", shape, plan is not None)] = np.asarray(jax.jit(
                lambda q, x: moe_ffn_sharded(q, x, mcfg, mesh(shape),
                                             slot_map=plan))(
                    inp["moe"], jnp.asarray(inp["moe_x"])))

    opts = JT.RuntimeOptions(
        mesh=mesh((1, 2)), sharded_moe=True, adaptive_embedding=True,
        hot_ids=inp["lm_hot"], cold_frac=0.4,
        slot_map=tuple(inp["slot_map"]))
    toks = jnp.asarray(inp["lm_tokens"], jnp.int32)
    out["lm_forward"] = np.asarray(jax.jit(lambda q, t: JT.lm_forward(
        q, t, mcfg, opts=opts))(inp["lm"], toks))
    out["lm_loss"] = float(jax.jit(lambda q, t, l: JT.lm_loss(
        q, t, l, mcfg, opts=opts))(inp["lm"], toks,
                                   jnp.asarray(inp["lm_labels"], jnp.int32)))

    # pod_allreduce_compressed over a 4-device pod axis, each device with
    # its own gradients and residuals
    pod = Mesh(np.array(jax.devices()[:4]), ("pod",))

    def body(g, r):
        g = jax.tree.map(lambda x: x[0], g)
        st = JC.EFState(residual=jax.tree.map(lambda x: x[0], r))
        q, _, _ = JC.compress_tree(g, st)
        mean, new = JC.pod_allreduce_compressed(g, st, axis="pod")
        lead = lambda t: jax.tree.map(lambda x: x[None], t)
        return lead(q), lead(mean), lead(new.residual)

    spec = {"a": P("pod"), "b": P("pod")}
    q, mean, res = jax.jit(shard_map(
        body, mesh=pod, in_specs=(spec, spec),
        out_specs=(spec, spec, spec)))(inp["pod"]["g"], inp["pod"]["r"])
    out["pod"] = tuple(jax.tree.map(np.asarray, x) for x in (q, mean, res))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
    '''
)

_CHILD4 = textwrap.dedent(
    r'''
    import dataclasses
    import pickle
    import sys
    import types

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch import nn
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.models.collectives import axis_rank
    from repro_torch.launch.shardings import param_specs, place
    from repro_torch.models import embedding as TE
    from repro_torch.models import moe as TM
    from repro_torch.models.mlp import SwiGLU
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.moe_sharded import moe_ffn_sharded
    from repro_torch.models.transformer import hidden_loss
    from repro_torch.optim import compression as TC

    assert "jax" not in sys.modules and "repro" not in sys.modules
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    rank = dist.get_rank()
    meshes = {(1, 4): M.make_local_mesh("cpu"),
              (2, 2): init_device_mesh("cpu", (2, 2),
                                       mesh_dim_names=M.AXES)}
    assert tuple(meshes[(1, 4)].shape) == (1, 4)
    res = {}
    t = lambda a: torch.from_numpy(np.array(a))

    cfg = get_smoke_config("llama3-8b")

    def placed(mesh, table):
        holder = nn.Module()
        holder.embed = TE.Embedding({"table": table})
        return place(holder, mesh, param_specs(holder, mesh)).embed

    for shape, mesh in meshes.items():
        for case, hot, cap, key in (("main", tuple(range(48)), 64, "ids"),
                                    ("overflow", (), 4, "cold_ids")):
            for how in ("whole", "placed"):
                e = (TE.Embedding({"table": t(inp["table"])})
                     if how == "whole" else placed(mesh, t(inp["table"])))
                with torch.no_grad():
                    o, over = TE.adaptive_embed(e, t(inp[key]), cfg, hot,
                                                cap, mesh)
                res[("embed", shape, case, how)] = (o.float().numpy(),
                                                    int(over))
        # the gradient reaches the placed rows through both paths
        e = placed(mesh, t(inp["table"]))
        o, _ = TE.adaptive_embed(e, t(inp["ids"]), cfg, tuple(range(48)),
                                 64, mesh)
        (o.float() ** 2).sum().backward()
        res[("grad", shape)] = (axis_rank(mesh, "data"),
                                axis_rank(mesh, "model"),
                                e.table.grad.numpy())

        # the vocab-parallel plain lookup, the tied head (the table's rows
        # gathered) and loss of a placed table against the whole one
        # (mamba2-130m ties them)
        scfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                                   dtype="float32")
        model = build_model(scfg, device="cpu")
        whole = model.init(0)
        part = place(model.init(0), mesh, param_specs(whole, mesh))
        ids = t(inp["ids"])
        h = torch.randn((4, 16, scfg.d_model),
                        generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            res[("vocab", shape)] = [
                [f(p.embed) for p in (whole, part)] for f in (
                    lambda e: TE.embed(e, ids, scfg).numpy(),
                    lambda e: TE.lm_head(e, h, scfg).numpy(),
                    lambda e: float(hidden_loss(
                        types.SimpleNamespace(embed=e), h, ids, scfg)))]

    mcfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                               dtype="float32")
    p = TM.MoE({k: t(inp["moe"][k]) for k in ("router", "w1", "w3", "w2")},
               SwiGLU({k: t(v) for k, v in inp["moe"]["shared"].items()}))
    for shape, mesh in meshes.items():
        for plan in (None, tuple(inp["slot_map"])):
            with torch.no_grad():
                res[("moe", shape, plan is not None)] = moe_ffn_sharded(
                    p, t(inp["moe_x"]), mcfg, mesh, slot_map=plan).numpy()

    # pod_allreduce_compressed over the 4 ranks, each with its own
    # gradients and residuals
    g = {k: t(v[rank]) for k, v in inp["pod"]["g"].items()}
    st = TC.EFState(residual={k: t(v[rank])
                              for k, v in inp["pod"]["r"].items()})
    q, _, _ = TC.compress_tree(g, st)
    mean, new = TC.pod_allreduce_compressed(g, st)
    res["pod"] = tuple({k: x.numpy() for k, x in d.items()}
                       for d in (q, mean, new.residual))

    with open(f"{sys.argv[2]}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    '''
)

_CHILD2 = textwrap.dedent(
    r'''
    import dataclasses
    import pickle
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shardings import param_specs, place
    from repro_torch.models import transformer as TT
    from repro_torch.models.convert import params_from_numpy

    assert "jax" not in sys.modules and "repro" not in sys.modules
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    mesh = make_local_mesh("cpu")
    assert tuple(mesh.shape) == (1, 2)
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              dtype="float32")
    params = params_from_numpy(inp["lm"], cfg, "cpu")
    params = place(params, mesh, param_specs(params, mesh))
    assert params.embed.table.shape[0] == cfg.vocab_size // 2
    opts = TT.RuntimeOptions(
        mesh=mesh, sharded_moe=True, adaptive_embedding=True,
        hot_ids=inp["lm_hot"], cold_frac=0.4,
        slot_map=tuple(inp["slot_map"]))
    toks = torch.from_numpy(inp["lm_tokens"])
    with torch.inference_mode():
        h = TT.lm_forward(params, toks, cfg, opts=opts)
        loss = TT.lm_loss(params, toks, torch.from_numpy(inp["lm_labels"]),
                          cfg, opts=opts)
    with open(f"{sys.argv[2]}/rank{dist.get_rank()}.pkl", "wb") as f:
        pickle.dump({"lm_forward": h.numpy(), "lm_loss": float(loss)}, f)
    dist.barrier()
    '''
)


def _launch(n: int, code: str, inp_path: Path, tmp: Path, results: dict,
            key: str) -> None:
    script = tmp / f"child{n}.py"
    script.write_text(code)
    out = tmp / f"out{n}"
    out.mkdir()
    results[key] = (launch_localhost(
        n, [str(script), str(inp_path), str(out)], device="cpu",
        timeout=LEG_TIMEOUT, env={"OMP_NUM_THREADS": "1"}, retries=1), out)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory) -> dict:
    """The reference's outputs on 4 host devices and each port rank's,
    from three runs side by side."""
    _, inp_path = inputs
    tmp = tmp_path_factory.mktemp("mesh_runs")
    ref_out = tmp / "ref.pkl"
    env = {**os.environ,
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(inp_path),
                            str(ref_out)], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    results: dict = {}
    legs = [threading.Thread(target=_launch, args=(n, code, inp_path, tmp,
                                                   results, key))
            for n, code, key in ((4, _CHILD4, "four"), (2, _CHILD2, "two"))]
    for th in legs:
        th.start()
    try:
        stdout, stderr = ref.communicate(timeout=LEG_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
        for th in legs:
            th.join(LEG_TIMEOUT + 30)
    assert "OK" in stdout, stderr[-3000:]
    out = {"ref": pickle.loads(ref_out.read_bytes())}
    for key in ("four", "two"):
        procs, outdir = results[key]
        for r in procs:
            assert r.ok, (key, r.process_id, r.stderr[-3000:])
        out[key] = [pickle.loads((outdir / f"rank{r.process_id}.pkl")
                                 .read_bytes()) for r in procs]
    return out


# ------------------------------------------- counterparts of the reference
@pytest.fixture(scope="module")
def mesh1():
    """A world-size-1 gloo mesh in this process, its group left at the
    end: other test files of the same worker start without one."""
    import torch.distributed as dist

    from repro_torch.launch import multihost

    assert not dist.is_initialized()
    mesh = TMESH.make_local_mesh("cpu")
    assert tuple(mesh.shape) == (1, 1)
    yield mesh
    multihost.shutdown()


def _jax_mesh11():
    return jax.make_mesh((1, 1), ("data", "model"))


def test_adaptive_embed_single_device_matches_plain(mesh1):
    """``tests/test_adaptive.py``'s test on a world-size-1 gloo mesh: with
    no hot rows and with 64, the rows equal the plain lookup (the port's
    and the reference's) and nothing overflows."""
    cfg = get_smoke_config("llama3-8b")
    jcfg = jax_smoke_config("llama3-8b")
    jp = JE.init_embedding(jax.random.key(0), jcfg)
    p = TE.Embedding({"table": torch.from_numpy(np.array(jp["table"]))})
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16))
    plain = TE.embed(p, torch.from_numpy(ids), cfg)
    ref = np.asarray(JE.embed(jp, jnp.asarray(ids, jnp.int32), jcfg),
                     np.float32)
    np.testing.assert_array_equal(plain.detach().float().numpy(), ref)
    for hot in ((), tuple(range(0, 64))):
        out, over = TE.adaptive_embed(p, torch.from_numpy(ids), cfg, hot,
                                      32, mesh1)
        jout, jover = jax.jit(lambda q, i: JE.adaptive_embed(
            q, i, jcfg, hot, 32, _jax_mesh11()))(jp, jnp.asarray(ids,
                                                               jnp.int32))
        assert int(over) == int(jover) == 0
        assert out.dtype == cfg.cdtype
        got = out.detach().float().numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)
        np.testing.assert_array_equal(got, np.asarray(jout, np.float32))


def test_adaptive_embed_overflow_reported(mesh1):
    """All-cold tokens past a capacity of 4 overflow, by the reference's
    count."""
    cfg = get_smoke_config("llama3-8b")
    jcfg = jax_smoke_config("llama3-8b")
    jp = JE.init_embedding(jax.random.key(0), jcfg)
    p = TE.Embedding({"table": torch.from_numpy(np.array(jp["table"]))})
    ids = np.random.default_rng(1).integers(64, cfg.vocab_size, (2, 16))
    _, over = TE.adaptive_embed(p, torch.from_numpy(ids), cfg, (), 4, mesh1)
    _, jover = jax.jit(lambda q, i: JE.adaptive_embed(
        q, i, jcfg, (), 4, _jax_mesh11()))(jp, jnp.asarray(ids, jnp.int32))
    assert int(over) == int(jover) == 32 - 4


@pytest.mark.parametrize("shape", SHAPES_4)
@pytest.mark.parametrize("case", ["main", "overflow"])
def test_adaptive_embed_multidevice_subprocess(runs, shape, case):
    """``tests/test_adaptive.py``'s 4-device test on 4 gloo ranks: every
    rank's rows and overflow equal the reference's ``adaptive_embed`` on
    4 host devices, with the table whole and placed by ``param_specs``;
    the main case also equals the plain lookup."""
    want, want_over = runs["ref"][("embed", shape, case)]
    if case == "main":
        assert want_over == 0
        np.testing.assert_allclose(want, runs["ref"]["plain_embed"],
                                   atol=1e-6)
    else:
        assert want_over > 0
    for res in runs["four"]:
        for how in ("whole", "placed"):
            got, over = res[("embed", shape, case, how)]
            assert over == want_over, (how, over, want_over)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES_4)
def test_adaptive_embed_gradient_reaches_the_table(runs, shape):
    """The placed table's gradient of sum(emb ** 2), summed over the data
    axis as data-parallel training sums it and joined over ``model``,
    equals ``jax.grad`` of the plain lookup (1e-6), and is not zero."""
    d, m = shape
    full = {}
    for res in runs["four"]:
        dr, mr, g = res[("grad", shape)]
        full[mr] = full.get(mr, 0) + g
    assert sorted(full) == list(range(m))
    got = np.concatenate([full[r] for r in range(m)])
    want = runs["ref"]["grad"]
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert float(np.abs(got).sum()) > 0


@pytest.mark.parametrize("shape", SHAPES_4)
def test_placed_table_lookup_and_tied_head(runs, shape):
    """On a table cut to each rank's rows, the plain lookup, the tied LM
    head and the loss equal the whole table's (mamba2-130m, float32)."""
    for res in runs["four"]:
        (e0, e1), (h0, h1), (l0, l1) = res[("vocab", shape)]
        np.testing.assert_array_equal(e1, e0)
        np.testing.assert_allclose(h1, h0, atol=1e-6)
        np.testing.assert_allclose(l1, l0, rtol=1e-6)


@pytest.mark.parametrize("shape", SHAPES_4)
@pytest.mark.parametrize("plan", [False, True], ids=["no-plan", "2-replicas"])
def test_moe_ffn_sharded_matches_jax(runs, shape, plan):
    """Each rank's output equals the reference's on 4 host devices
    (float32, 1e-5), with no plan and with 2 hot experts replicated (10
    slots padded to 12 over 4 ranks)."""
    want = runs["ref"][("moe", shape, plan)]
    for res in runs["four"]:
        np.testing.assert_allclose(res[("moe", shape, plan)], want,
                                   atol=1e-5, rtol=1e-5)


def test_lm_forward_under_all_options_matches_jax(runs):
    """qwen2-moe's smoke model (float32) on 2 ranks, params placed by
    ``param_specs``, with the adaptive embedding, the sharded moe and a
    2-replica plan: hidden states and loss equal the reference's on 2
    host devices (1e-4, 1e-5 relative) on each rank."""
    for res in runs["two"]:
        np.testing.assert_allclose(res["lm_forward"],
                                   runs["ref"]["lm_forward"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(res["lm_loss"], runs["ref"]["lm_loss"],
                                   rtol=1e-5)


def test_pod_allreduce_compressed_four_ranks_matches_jax(runs):
    """``pod_allreduce_compressed`` on 4 gloo ranks, each with its own
    gradients and error-feedback residuals, against the reference's under
    ``shard_map`` over a 4-device ``pod`` axis: each rank's int8 payload
    bit for bit, the mean and the new residual within 1e-6."""
    want_q, want_mean, want_res = runs["ref"]["pod"]
    for rank, res in enumerate(runs["four"]):
        q, mean, residual = res["pod"]
        for k in want_q:
            np.testing.assert_array_equal(q[k], want_q[k][rank], err_msg=k)
            np.testing.assert_allclose(mean[k], want_mean[k][rank],
                                       atol=1e-6, rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(residual[k], want_res[k][rank],
                                       atol=1e-6, rtol=1e-6, err_msg=k)
        assert any(np.any(q[k] != want_q[k][(rank + 1) % 4])
                   for k in want_q)  # the ranks' payloads differ


@pytest.mark.parametrize("plan", [None, (1, 5)])
def test_moe_ffn_sharded_one_rank_is_moe_ffn(mesh1, plan):
    """At one rank the sharded dispatch is ``moe_ffn`` (float32, bit for
    bit: the same routing, capacity, sort and combine order)."""
    jcfg, cfg = _f32("qwen2-moe-a2.7b")
    p = _moe_module(_np_tree(JM.init_moe(jax.random.key(1), jcfg)))
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))
    slot_map = (None if plan is None else
                TM.slot_map_for_plan(cfg.moe.n_experts, plan))
    with torch.no_grad():
        want, _ = TM.moe_ffn(p, x, cfg, slot_map)
        got = moe_ffn_sharded(p, x, cfg, mesh1, slot_map=slot_map)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_serve_loop_runs_with_controller(mesh1):
    """``tests/test_optimizations.py``'s test on the port: mamba2-130m's
    smoke model served on a world-size-1 mesh with its params placed by
    ``param_specs`` -- two batch times and a plan with hot rows; the
    tokens equal ``serve_loop``'s without a mesh (the controllers' decayed
    heat counts, an order-sensitive record of every token, are equal),
    and the plan equals the reference's controller fed the same tokens."""
    cfg = get_smoke_config("mamba2-130m")
    model = build_model(cfg, opts=RuntimeOptions(mesh=mesh1), device="cpu")
    placed = TSH.place(model.init(0), mesh1,
                       TSH.param_specs(model.init(0), mesh1))
    assert placed.embed.mesh is mesh1
    seen = []

    class Recording(AdaptiveShardingController):
        def observe(self, ids):
            seen.append(np.array(ids))
            super().observe(ids)

    kw = dict(batch_size=2, max_len=16, steps=4, n_batches=2)
    ctrl = Recording(cfg.vocab_size, budget=32)
    times, plan = serve_loop(model, placed, controller=ctrl,
                             rng=np.random.default_rng(0), **kw)
    assert len(times) == 2
    assert plan is not None and plan.n_hot > 0
    plain = build_model(cfg, device="cpu")
    ctrl2 = AdaptiveShardingController(cfg.vocab_size, budget=32)
    _, plan2 = serve_loop(plain, plain.init(0), controller=ctrl2,
                          rng=np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(ctrl.heat.counts, ctrl2.heat.counts)
    jctrl = JaxController(cfg.vocab_size, budget=32)
    for i, ids in enumerate(seen):
        jctrl.observe(ids)
        if (i + 1) % kw["steps"] == 0:
            jplan = jctrl.replan()
    for a, b in ((plan, plan2), (plan, jplan)):
        assert (a.hot_ids, a.coverage, a.version) == \
            (b.hot_ids, b.coverage, b.version)


# ------------------------------------------------------- the spec rules
class _PortMesh:
    """A stand-in mesh of the given axis sizes: the spec rules read only
    the mesh's shape."""

    def __init__(self, sizes: dict[str, int]):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, i: int) -> int:
        return self._sizes[i]


def _jax_mesh(sizes: dict[str, int]):
    return types.SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a tree of the reference's PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    names = lambda path: tuple(str(k.key) if hasattr(k, "key") else
                               str(k.idx) for k in path)
    return {names(path): tuple(spec) for path, spec in flat}


MESH_SIZES = [{"data": 1, "model": 4}, {"data": 2, "model": 2},
              {"pod": 2, "data": 2, "model": 2}]


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_and_cache_specs_match_jax(arch):
    """``param_specs`` leaf by leaf on the reference's tree of every arch's
    smoke model, ``cache_specs`` on its decode cache (and the int8 cache
    where the arch has one), on (1, 4), (2, 2) and (2, 2, 2) meshes and
    without a mesh; ``Stats.bytes_of`` of the parameters."""
    jcfg = jax_smoke_config(arch)
    cfg = get_smoke_config(arch)
    jm = jax_build_model(jcfg)
    jshapes = jax.eval_shape(jm.init, jax.random.key(0))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    caches = [(jm.init_cache(2, 8), model.init_cache(2, 8))]
    if cfg.family in ("dense", "moe"):
        opts8 = dict(kv_cache_int8=True)
        caches.append((
            jax_build_model(jcfg, opts=JT.RuntimeOptions(**opts8))
            .init_cache(2, 8),
            build_model(cfg, opts=RuntimeOptions(**opts8),
                        device="cpu").init_cache(2, 8)))
    assert TSH.Stats.bytes_of(params) == JSH.Stats.bytes_of(jshapes)
    for sizes in [None] + MESH_SIZES:
        jmesh = None if sizes is None else _jax_mesh(sizes)
        tmesh = None if sizes is None else _PortMesh(sizes)
        want = _ref_specs(JSH.param_specs(jshapes, jmesh))
        assert TSH.param_specs(params, tmesh) == want, sizes
        if sizes is None:
            continue
        for jc, tc in caches:
            for gb in (2, 4, 8):
                want = _ref_specs(JSH.cache_specs(jc, jcfg, jmesh, gb))
                assert TSH.cache_specs(tc, cfg, tmesh, gb) == want, \
                    (sizes, gb)


@pytest.mark.parametrize("sizes", MESH_SIZES)
def test_batch_specs_match_jax(sizes):
    """``batch_specs`` for every arch and every shape of ``SHAPES``, each
    kind."""
    jmesh, tmesh = _jax_mesh(sizes), _PortMesh(sizes)
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            for kind in ("train", "prefill", "decode"):
                want = {k: tuple(v) for k, v in JSH.batch_specs(
                    jax_smoke_config(arch), jmesh, JSHAPES[name],
                    kind).items()}
                assert TSH.batch_specs(get_smoke_config(arch), tmesh,
                                       shape, kind) == want


def test_local_mesh_rule_and_batch_axes_match_jax(monkeypatch):
    """``make_local_mesh``'s shape and ``batch_axes`` for world sizes 1, 2,
    4, 6, 8 and 16 (the reference's shape read through a stand-in
    ``jax.make_mesh``)."""
    for n in (1, 2, 4, 6, 8, 16):
        monkeypatch.setattr(jax, "devices", lambda n=n: list(range(n)))
        monkeypatch.setattr(jax, "make_mesh",
                            lambda shape, axes: (tuple(shape), tuple(axes)))
        jshape, jaxes = JMESH.make_local_mesh()
        assert TMESH.local_mesh_shape(n) == jshape and jaxes == TMESH.AXES
        sizes = dict(zip(jaxes, jshape))
        for gb in (1, 2, 3, 4, 8, 12, 16, 256):
            assert TMESH.batch_axes(_PortMesh(sizes), gb) == \
                JMESH.batch_axes(_jax_mesh(sizes), gb)


def test_production_mesh_needs_its_ranks(mesh1):
    """A world of one rank is no production mesh: the error names the 256
    (or 512) ranks it needs."""
    with pytest.raises(ValueError, match="256 ranks"):
        TMESH.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        TMESH.make_production_mesh(multi_pod=True, device="cpu")
