"""LM training under a mesh (the training half of the mesh options):
the port's train step on gloo ranks against the reference's train step,
the tensor-parallel collectives' gradients, the checkpoint saved on a mesh
and restored onto another, and the train CLI on ranks.

Multi-rank legs run as ``tests/test_torch_mesh.py`` runs its own: one
``launch_localhost(4, ..., device="cpu")`` run of a torch-only child
(meshes (1, 4), (2, 2) and (4, 1)), one of 2 ranks (mesh (1, 2)) and one
run of the train CLI through the launcher, side by side, each with a
timeout; the reference's steps are computed in this process meanwhile.
Inputs and weights are made here, from seeds, and handed to the children
as numpy.

The oracle is the reference's ``make_train_step`` jitted on one host
device without a mesh, fed the same weights (through ``convert``) and
batch: its sharded path raises ``ShardingTypeError`` at the embedding
gather of a ``model``-sharded table under jax 0.9 (the reason
``tests/test_system.py::test_lm_train_step_under_local_mesh`` fails), and
GSPMD computes the unsharded jit's math.

Cases, each on every mesh, float32 smoke configs of qwen2-moe-a2.7b and
qwen1.5-4b: the plain batch; qwen2-moe at capacity factor 0.5, where the
global dispatch drops assignments (asserted on the ranks); qwen1.5-4b with
labels masked unevenly over the batch (data shards count different
labels); recurrentgemma-2b (``hybrid``: 4 query heads over 1 KV head, a
window of 16 under T = 32, the RG-LRU cut per channel) and whisper-tiny
(``audio``: 32 frames, a vocabulary of 512, so its token table ``tok`` is
cut).  The LM head is vocab-parallel wherever ``model`` has more than one
rank (``embed.out`` cut by columns, a tied table by rows).

Limits: the loss and ``grad_norm`` within 1e-5 relative; each gradient
leaf, gathered whole, within 1e-5 of its largest magnitude, except the key
bias ``bk``, whose gradient is zero in exact arithmetic (it adds q.b to
every logit of a row, which the softmax does not see), so that both sides
are rounding noise: it is held within 1e-5 of the largest gradient of the
model; each updated parameter within 1e-5 of max(1, its leaf's largest
magnitude), and an element whose reference gradient lies within 10 times
its leaf's gradient limit of zero within a further 2 lr: AdamW's first
step moves an element by lr * g / (|g| + eps / scale), so a gradient
known to within the limit near zero fixes neither the sign nor the size
of its step.  Checkpoint leaves are bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax

from repro.checkpoint.checkpoint import _flatten_with_names as jax_flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.launch import multihost
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.multihost import launch_localhost
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import adamw_init

ROOT = Path(__file__).resolve().parents[1]
MESHES_4 = ((1, 4), (2, 2), (4, 1))
LEG_TIMEOUT = 240
CASES = {
    "moe": ("qwen2-moe-a2.7b", None, False),
    "moe-drop": ("qwen2-moe-a2.7b", 0.5, False),
    "dense": ("qwen1.5-4b", None, False),
    "dense-masked": ("qwen1.5-4b", None, True),
    "hybrid": ("recurrentgemma-2b", None, False),
    "audio": ("whisper-tiny", None, False),
}
#: leaves each case must have cut where ``model`` has more than one rank
CUT = {"moe": ("blocks.0.attn.wq", "blocks.0.moe.w1", "embed.out"),
       "dense": ("blocks.0.attn.wq", "blocks.0.mlp.w1", "embed.out"),
       "hybrid": ("groups.0.rec1.mixer.w_x", "groups.0.rec1.mixer.lam",
                  "groups.0.rec2.mixer.w_i", "groups.0.attn.mixer.wq",
                  "groups.0.rec1.mlp.w1", "embed.table"),
       "audio": ("dec.0.cross.wq", "dec.0.self.wq", "enc.0.attn.wq",
                 "enc.0.mlp.w1", "tok")}


def _cfgs(case: str):
    """The JAX and port float32 configs of a case."""
    arch, cap, _ = CASES[case]
    out = []
    for cfg in (jax_smoke_config(arch), get_smoke_config(arch)):
        cfg = dataclasses.replace(cfg, dtype="float32")
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap))
        out.append(cfg)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------- the inputs
@pytest.fixture(scope="module")
def inputs(tmp_path_factory) -> tuple[dict, Path]:
    """Seeded weights (the reference's init) and batches, as numpy."""
    inp = {}
    for i, case in enumerate(CASES):
        jcfg, _ = _cfgs(case)
        jb = _np(jax_make_batch(jcfg, 4, 32, 0))
        if CASES[case][2]:  # rows 0, 1 keep 1 label in 8; rows 2, 3 all
            keep = np.ones_like(jb["labels"], bool)
            keep[:2] = np.arange(32) % 8 == 0
            jb["labels"] = np.where(keep, jb["labels"], -1)
        inp[case] = {"params": _np(jax_build_model(jcfg).init(
            jax.random.key(i))), "batch": jb}
    path = tmp_path_factory.mktemp("mesh_train") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, path


def _reference(inp: dict) -> dict:
    """Each case's loss, gradients, grad_norm and updated parameters from
    the reference's train step, jitted on one device without a mesh."""
    out = {}
    for case in CASES:
        jcfg, _ = _cfgs(case)
        model = jax_build_model(jcfg)
        p = jax.tree.map(jax.numpy.asarray, inp[case]["params"])
        b = jax.tree.map(jax.numpy.asarray, inp[case]["batch"])
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(p, b)
        step = jax.jit(jax_make_train_step(model, JAdamWConfig()))
        new, _, met = step(p, jax_adamw_init(p), b)
        out[case] = {"loss": float(loss), "grads": _np(grads),
                     "grad_norm": float(met["grad_norm"]),
                     "params": _np(new)}
    return out


_CHILD = textwrap.dedent(
    r'''
    import dataclasses
    import pickle
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.checkpoint.checkpoint import _flatten_with_names as flat
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.tokens import make_batch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.serve import serve_loop
    from repro_torch.launch.shardings import gather_whole, param_specs, place
    from repro_torch.launch.train import loss_and_grads, make_train_step
    from repro_torch.models import collectives as C
    from repro_torch.models import moe as TM
    from repro_torch.models.convert import (cache_to_numpy, params_from_numpy,
                                            params_to_numpy)
    from repro_torch.models.model_zoo import build_model
    from repro_torch.models.whisper import whisper_encode
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    assert "jax" not in sys.modules and "repro" not in sys.modules
    torch.set_num_threads(1)
    inp_path, out_dir, shapes = sys.argv[1], sys.argv[2], sys.argv[3]
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    rank = dist.get_rank()
    meshes = {}
    for s in shapes.split(","):
        shape = tuple(int(x) for x in s.split("x"))
        meshes[shape] = init_device_mesh("cpu", shape,
                                         mesh_dim_names=M.AXES)
    res = {}
    t = lambda a: torch.from_numpy(np.array(a))
    CASES = {"moe": ("qwen2-moe-a2.7b", None), "moe-drop":
             ("qwen2-moe-a2.7b", 0.5), "dense": ("qwen1.5-4b", None),
             "dense-masked": ("qwen1.5-4b", None),
             "hybrid": ("recurrentgemma-2b", None),
             "audio": ("whisper-tiny", None)}

    def batch_of(case):
        return {k: t(v) if k == "frames" else t(v).long()
                for k, v in inp[case]["batch"].items()}

    def cfg_of(case):
        arch, cap = CASES[case]
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if cap is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cap))
        return cfg

    def placed(cfg, tree, mesh):
        p = params_from_numpy(tree, cfg, "cpu")
        return place(p, mesh, param_specs(p, mesh))

    dropped = []
    inner = TM.moe_ffn

    def spy(*a, **k):
        out, diag = inner(*a, **k)
        dropped.append(int(diag["dropped"]))
        return out, diag

    TM.moe_ffn = spy
    for shape, mesh in meshes.items():
        for case in CASES:
            cfg = cfg_of(case)
            model = build_model(cfg, device="cpu")
            batch = batch_of(case)
            p = placed(cfg, inp[case]["params"], mesh)
            dropped.clear()
            loss, grads = loss_and_grads(model, p, batch, mesh)
            grads = params_to_numpy(gather_whole(grads, p.placement))
            step = make_train_step(model, AdamWConfig(), mesh)
            p, _, met = step(p, adamw_init(p), batch)
            whole = params_to_numpy(gather_whole(
                dict(p.named_parameters()), p.placement))
            res[("step", shape, case)] = {
                "loss": float(met["loss"]), "loss_grads": float(loss),
                "grad_norm": float(met["grad_norm"]), "grads": grads,
                "params": whole, "dropped": list(dropped),
                "cut": sorted(p.placement.cut)}
    TM.moe_ffn = inner

    # decode on a placed model (the serving path: the batch replicated,
    # the cut attention reads its KV heads of a whole cache, a cut RG-LRU
    # keeps its channels of the state, whisper reads encoder states made
    # by the placed encoder)
    for shape, mesh in meshes.items():
        for case in ("dense", "moe", "hybrid", "audio"):
            cfg = cfg_of(case)
            model = build_model(cfg, device="cpu")
            p = placed(cfg, inp[case]["params"], mesh)
            batch = batch_of(case)
            toks = batch["tokens"][:2]
            extra = {}
            if case == "audio":
                with torch.no_grad():
                    extra["enc"] = whisper_encode(p, batch["frames"][:2],
                                                  cfg)
            cache = model.init_cache(2, 8, p)
            steps = []
            for pos in range(4):
                lg, cache = model.decode(p, cache, {
                    "tokens": toks[:, pos:pos + 1], "pos": pos, **extra})
                steps.append(lg.numpy().copy())
            res[("decode", shape, case)] = steps
            if case == "hybrid":
                res[("state", shape)] = (
                    {k: tuple(v.shape) for k, v in cache["rec1"].items()},
                    cache_to_numpy(cache, p))
                # the serving loop on the placed model (the mesh path of
                # launch.serve)
                times, _ = serve_loop(model, p, batch_size=2, max_len=8,
                                      steps=3, n_batches=2)
                res[("serve", shape)] = len(times)

    # the column- and row-parallel pair and the owner fetch, against the
    # whole computation
    for shape, mesh in meshes.items():
        g = C.axis_group(mesh, "model")
        m, r = C.axis_size(mesh, "model"), C.axis_rank(mesh, "model")
        gen = torch.Generator().manual_seed(5)
        x0 = torch.randn(6, 8, generator=gen)
        w1 = torch.randn(8, 16, generator=gen)
        w2 = torch.randn(16, 8, generator=gen)
        f = 16 // m
        x = x0.clone().requires_grad_()
        a = w1[:, r * f:(r + 1) * f].clone().requires_grad_()
        b = w2[r * f:(r + 1) * f].clone().requires_grad_()
        h = F.silu(C.copy_to_parallel(x, g) @ a) @ b
        y = C.all_reduce_replicated(h, g)
        (y ** 2).sum().backward()
        own = torch.randn(3, 8, generator=gen)  # rank 0's rows
        w = (own * (r == 0)).requires_grad_()
        z = C.all_reduce_sum(w, g)
        ((z * (r + 1)) ** 2).sum().backward()
        res[("tp", shape)] = (r, y.detach().numpy(), x.grad.numpy(),
                              a.grad.numpy(), b.grad.numpy(),
                              z.detach().numpy(), w.grad.numpy())
        # the whole of an activation cut by columns (all_gather_parallel),
        # read by each rank's gate columns and times its own columns, as
        # the RG-LRU's gates read the conv output
        xs0 = torch.randn(6, 8, generator=gen)
        wg = torch.randn(8, 8, generator=gen)
        wv = torch.randn(8, 5, generator=gen)
        c = 8 // m
        xs = xs0[:, r * c:(r + 1) * c].clone().requires_grad_()
        whole = C.all_gather_parallel(xs, g, -1)
        gate = torch.sigmoid(whole @ wg[:, r * c:(r + 1) * c]) * xs
        zz = C.all_reduce_replicated(gate @ wv[r * c:(r + 1) * c], g)
        with C.trace_collectives() as events:
            (zz ** 2).sum().backward()
        res[("gather", shape)] = (r, whole.detach().numpy(),
                                  zz.detach().numpy(), xs.grad.numpy(),
                                  [kind for kind, _ in events])

    if "1x4" in shapes.split(","):
        # the step-0 repair: a checkpoint saved on (1, 4) holds whole leaves
        cfg = cfg_of("moe")
        m14 = meshes[(1, 4)]
        p = placed(cfg, inp["moe"]["params"], m14)
        CheckpointManager(f"{out_dir}/ckpt_fresh").save(p, adamw_init(p), 1)
        # a step, then a save on (1, 4) restored onto (2, 2)
        model = build_model(cfg, device="cpu")
        batch = {k: t(v).long() for k, v in inp["moe"]["batch"].items()}
        opt = adamw_init(p)
        p, opt, _ = make_train_step(model, AdamWConfig(), m14)(p, opt, batch)
        CheckpointManager(f"{out_dir}/ckpt_step").save(p, opt, 1)
        # fresh weights of another seed, restored onto (2, 2) by the mesh
        q = build_model(cfg, device="cpu").init(1)
        qo = adamw_init(place(q, meshes[(2, 2)], param_specs(q,
                                                             meshes[(2, 2)])))
        q, qo, st = CheckpointManager(f"{out_dir}/ckpt_step").restore_latest(
            q, qo, mesh=meshes[(2, 2)])
        res["restored"] = (C.axis_rank(meshes[(2, 2)], "model"), st,
                           params_to_numpy(q), flat(qo),
                           dict(q.placement.cut))
        # the same for the hybrid's and whisper's cut leaves (the RG-LRU,
        # the GeLU MLPs, the token table)
        for case in ("hybrid", "audio"):
            cfg = cfg_of(case)
            model = build_model(cfg, device="cpu")
            p = placed(cfg, inp[case]["params"], m14)
            opt = adamw_init(p)
            p, opt, _ = make_train_step(model, AdamWConfig(), m14)(
                p, opt, batch_of(case))
            CheckpointManager(f"{out_dir}/ckpt_{case}").save(p, opt, 1)
            q = model.init(1)
            qo = adamw_init(place(q, meshes[(2, 2)],
                                  param_specs(q, meshes[(2, 2)])))
            q, qo, st = CheckpointManager(
                f"{out_dir}/ckpt_{case}").restore_latest(
                    q, qo, mesh=meshes[(2, 2)])
            res[("restored", case)] = (
                C.axis_rank(meshes[(2, 2)], "model"), st,
                params_to_numpy(q), flat(qo), dict(q.placement.cut))

        # the counterpart of test_lm_train_step_under_local_mesh
        cfg = get_smoke_config("qwen2-moe-a2.7b")
        model = build_model(cfg, device="cpu")
        mesh = M.make_local_mesh("cpu")
        p = model.init(0)
        p = place(p, mesh, param_specs(p, mesh))
        opt = adamw_init(p)
        step = make_train_step(model, AdamWConfig(lr=5e-3), mesh)
        batch = make_batch(cfg, 4, 32, 0, device="cpu")
        losses = []
        for _ in range(6):
            p, opt, met = step(p, opt, batch)
            losses.append(float(met["loss"]))
        res["falls"] = (tuple(mesh.shape), losses)

    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    '''
)


def _launch(n: int, shapes: str, inp_path: Path, tmp: Path,
            results: dict) -> None:
    script = tmp / "child.py"
    out = tmp / f"out{n}"
    out.mkdir()
    results[n] = (launch_localhost(
        n, [str(script), str(inp_path), str(out), shapes], device="cpu",
        timeout=LEG_TIMEOUT, env={"OMP_NUM_THREADS": "1"}, retries=1), out)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory) -> dict:
    """Each rank's results of the 4- and 2-rank children and the train
    CLI's run on 4 ranks, and the reference's steps, side by side."""
    inp, inp_path = inputs
    tmp = tmp_path_factory.mktemp("mesh_train_runs")
    (tmp / "child.py").write_text(_CHILD)
    results: dict = {}
    cli: dict = {}

    def run_cli() -> None:
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT / "src") + os.pathsep +
               os.environ.get("PYTHONPATH", "")}
        cli["run"] = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch", "--nprocs", "4",
             "--device", "cpu", "--timeout", str(LEG_TIMEOUT), "-m",
             "repro_torch.launch.train", "--arch", "qwen2-moe-a2.7b",
             "--smoke", "--steps", "3", "--batch", "4", "--seq", "32"],
            env=env, capture_output=True, text=True,
            timeout=LEG_TIMEOUT + 30)

    legs = [threading.Thread(target=_launch, args=(n, shapes, inp_path, tmp,
                                                   results))
            for n, shapes in ((4, "1x4,2x2,4x1"), (2, "1x2"))]
    legs.append(threading.Thread(target=run_cli))
    for th in legs:
        th.start()
    try:
        ref = _reference(inp)
    finally:
        for th in legs:
            th.join(LEG_TIMEOUT + 60)
    out = {"ref": ref, "cli": cli["run"], "dir": results[4][1]}
    for n in (4, 2):
        procs, outdir = results[n]
        for r in procs:
            assert r.ok, (n, r.process_id, r.stderr[-3000:])
        out[n] = [pickle.loads((outdir / f"rank{r.process_id}.pkl")
                               .read_bytes()) for r in procs]
    return out


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, np.asarray(tree)


def _check_step(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss_grads"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    g, w = dict(_leaves(got["grads"])), dict(_leaves(want["grads"]))
    assert sorted(g) == sorted(w)
    top = max(float(np.abs(a).max()) for a in w.values())
    limit = {path: 1e-5 * (top if path.endswith("/bk") else
                           float(np.abs(b).max())) for path, b in w.items()}
    for path, b in w.items():
        np.testing.assert_allclose(g[path], b, rtol=0, atol=limit[path],
                                   err_msg=path)
    grads = w
    g, w = dict(_leaves(got["params"])), dict(_leaves(want["params"]))
    assert sorted(g) == sorted(w)
    lr = JAdamWConfig().lr
    for path, b in w.items():
        near_zero = np.abs(grads[path]) <= 10 * limit[path]
        atol = 1e-5 * max(1.0, float(np.abs(b).max())) + 2 * lr * near_zero
        assert np.all(np.abs(g[path] - b) <= atol), (
            path, float(np.abs(g[path] - b).max()))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_step_matches_jax(runs, shape, case):
    """One train step on every rank of the mesh against the reference's
    step on one device: loss, gradients and updated parameters gathered
    whole, grad_norm.  The layers are cut where the mesh has a model axis
    (``CUT``: the hybrid's RG-LRU, attention and MLP, whisper's attention,
    GeLU MLP and token table, every head), and the drop case drops on the
    global batch.  Whisper's b1, which the spec keeps whole, holds its
    whole gradient on every rank."""
    ranks = runs[2] if shape == (1, 2) else runs[4]
    for res in ranks:
        got = res[("step", shape, case)]
        _check_step(got, runs["ref"][case])
        if shape[1] > 1:
            want = CUT[case.split("-")[0]]
            assert set(want) <= set(got["cut"]), (want, got["cut"])
        else:
            assert got["cut"] == []
        if case == "moe-drop":
            assert got["dropped"] and min(got["dropped"]) > 0, got["dropped"]


@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_tensor_parallel_collectives_gradients(runs, shape):
    """A column-parallel then a row-parallel product through
    ``copy_to_parallel`` and ``all_reduce_replicated``: the output and the
    input's gradient equal the whole computation's on every rank, each
    weight slice's gradient is its slice of the whole gradient; an
    ``all_reduce_sum`` of rank 0's rows, used by each rank in its own way,
    gives rank 0 the sum of every rank's gradient."""
    ranks = runs[2] if shape == (1, 2) else runs[4]
    m = shape[1]
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(6, 8, generator=gen)
    w1 = torch.randn(8, 16, generator=gen).requires_grad_()
    w2 = torch.randn(16, 8, generator=gen).requires_grad_()
    own = torch.randn(3, 8, generator=gen)
    x = x0.clone().requires_grad_()
    y = torch.nn.functional.silu(x @ w1) @ w2
    (y ** 2).sum().backward()
    f = 16 // m
    for res in ranks:
        r, gy, gx, ga, gb, z, gw = res[("tp", shape)]
        np.testing.assert_allclose(gy, y.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gx, x.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ga, w1.grad[:, r * f:(r + 1) * f].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gb, w2.grad[r * f:(r + 1) * f].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(z, own.numpy())
        want = sum(2 * (i + 1) ** 2 for i in range(m)) * own.numpy()
        np.testing.assert_allclose(gw, want, rtol=1e-6)


@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gather_parallel_gradients(runs, shape):
    """``all_gather_parallel`` joins the ranks' columns of an activation
    into the whole one, which each rank's gate columns read beside its own
    columns (the RG-LRU's pattern): the whole activation, the output and
    each rank's input gradient equal the whole computation's, and the
    backward issues a reduce-scatter (keeping only this rank's slice, as
    ``all_gather_replicated``'s backward does, would drop the other
    ranks' parts of the gradient)."""
    ranks = runs[2] if shape == (1, 2) else runs[4]
    m = shape[1]
    gen = torch.Generator().manual_seed(5)
    for size in ((6, 8), (8, 16), (16, 8), (3, 8)):
        torch.randn(*size, generator=gen)  # the draws of the pair above
    xs0 = torch.randn(6, 8, generator=gen)
    wg = torch.randn(8, 8, generator=gen)
    wv = torch.randn(8, 5, generator=gen)
    x = xs0.clone().requires_grad_()
    z = (torch.sigmoid(x @ wg) * x) @ wv
    (z ** 2).sum().backward()
    c = 8 // m
    for res in ranks:
        r, whole, gz, gx, kinds = res[("gather", shape)]
        np.testing.assert_array_equal(whole, xs0.numpy())
        np.testing.assert_allclose(gz, z.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(gx, x.grad[:, r * c:(r + 1) * c].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert ("reduce-scatter" in kinds) == (m > 1), kinds


def _whole_decode(inp: dict, case: str):
    """Four teacher-forced decode steps of the whole model on one process
    (logits of each step) and its cache after them."""
    from repro_torch.models.whisper import whisper_encode

    _, cfg = _cfgs(case)
    model = build_model(cfg, device="cpu")
    p = params_from_numpy(inp[case]["params"], cfg, "cpu")
    batch = inp[case]["batch"]
    toks = torch.from_numpy(np.array(batch["tokens"])).long()[:2]
    extra = {}
    if case == "audio":
        with torch.no_grad():
            extra["enc"] = whisper_encode(
                p, torch.from_numpy(np.array(batch["frames"]))[:2], cfg)
    cache = model.init_cache(2, 8)
    want = []
    for pos in range(4):
        lg, cache = model.decode(p, cache, {"tokens": toks[:, pos:pos + 1],
                                            "pos": pos, **extra})
        want.append(lg.numpy())
    return want, cache


@pytest.mark.parametrize("case", ["dense", "moe", "hybrid", "audio"])
@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_on_a_placed_model(runs, inputs, shape, case):
    """Four teacher-forced decode steps (the batch's tokens fed in) of a
    model placed on the mesh equal the whole model's on one process
    (float32, 1e-5 of the logits' largest magnitude): the cut attention
    reads and writes its KV heads of a whole cache, the cut FFN and expert
    stacks sum over ``model``, a cut RG-LRU steps its channels of the
    state, whisper decodes over the placed encoder's states, and the
    vocab-parallel logits are gathered at the end of each step."""
    inp, _ = inputs
    want, _ = _whole_decode(inp, case)
    ranks = runs[2] if shape == (1, 2) else runs[4]
    for res in ranks:
        for got, w in zip(res[("decode", shape, case)], want):
            np.testing.assert_allclose(got, w, rtol=0,
                                       atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_hybrid_decode_state_holds_a_ranks_channels(runs, inputs, shape):
    """The held departure from the reference's ``cache_specs`` (which
    keeps the RG-LRU state replicated over ``model``): a cut RG-LRU's
    decode state holds this rank's W / m channels of ``h`` and of the conv
    ring, and ``cache_to_numpy(cache, params)`` gathers them into the
    whole model's state after the same four steps (1e-5 of its largest
    magnitude); the attention ring stays whole."""
    from repro_torch.models.convert import cache_to_numpy

    inp, _ = inputs
    _, cfg = _cfgs("hybrid")
    _, cache = _whole_decode(inp, "hybrid")
    want = dict(_leaves(cache_to_numpy(cache)))
    w = cfg.hybrid.lru_width // shape[1]
    ranks = runs[2] if shape == (1, 2) else runs[4]
    for res in ranks:
        shapes, got = res[("state", shape)]
        assert shapes == {"conv": (1, 2, 3, w), "h": (1, 2, w)}, shapes
        got = dict(_leaves(got))
        assert sorted(got) == sorted(want)
        for path, b in want.items():
            np.testing.assert_allclose(got[path], b, rtol=0, atol=1e-5 * max(
                1.0, float(np.abs(b).max())), err_msg=path)


@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_serve_loop_on_a_placed_hybrid(runs, shape):
    """``launch.serve.serve_loop`` (the serving CLI's mesh path) decodes
    two request batches on a recurrentgemma-2b placed on the mesh, its
    cache made for the placed model, on every rank."""
    ranks = runs[2] if shape == (1, 2) else runs[4]
    assert [res[("serve", shape)] for res in ranks] == [2] * len(ranks)


@pytest.mark.parametrize("case", ["dense", "moe", "hybrid"])
@pytest.mark.parametrize("shape", MESHES_4 + ((1, 2),),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_lm_head_is_vocab_parallel(runs, shape, case):
    """The LM head is cut wherever ``model`` has more than one rank:
    ``embed.out`` by columns (dense, moe; (D, V / m) on each rank), a tied
    table by rows (the hybrid); the loss and the head's gradient, gathered
    whole, still equal the reference's step (the file's limits)."""
    ranks = runs[2] if shape == (1, 2) else runs[4]
    want = runs["ref"][case]
    leaf = "embed/table" if case == "hybrid" else "embed/out"
    ref = dict(_leaves(want["grads"]))[leaf]
    for res in ranks:
        got = res[("step", shape, case)]
        name = leaf.replace("/", ".")
        assert (name in got["cut"]) == (shape[1] > 1), got["cut"]
        np.testing.assert_allclose(got["loss_grads"], want["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(
            dict(_leaves(got["grads"]))[leaf], ref, rtol=0,
            atol=1e-5 * float(np.abs(ref).max()))


def test_checkpoint_saved_on_a_mesh_holds_whole_leaves(runs, inputs):
    """A checkpoint saved on four gloo ranks of a (1, 4) mesh, reloaded
    with ``np.load``, equals the reference's ``_flatten_with_names`` of
    the same weights, unsharded, leaf by leaf, bit for bit; its moments
    are whole zeros."""
    inp, _ = inputs
    d = runs["dir"] / "ckpt_fresh" / "step0000000001"
    want = jax_flatten(inp["moe"]["params"])
    with np.load(d / "params.npz") as z:
        got = dict(z)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    jopt = jax_flatten(jax_adamw_init(inp["moe"]["params"]))
    with np.load(d / "opt.npz") as z:
        got = dict(z)
    assert sorted(got) == sorted(jopt)
    for name, arr in jopt.items():
        assert got[name].shape == arr.shape, name
        np.testing.assert_array_equal(got[name], 0 * arr, err_msg=name)


def _whole_files(d: Path) -> tuple[dict, dict]:
    with np.load(d / "params.npz") as z:
        params = dict(z)
    with np.load(d / "opt.npz") as z:
        opt = dict(z)
    return params, opt


def _slice(arr: np.ndarray, dim: int | None, m: int, r: int) -> np.ndarray:
    if dim is None:
        return arr
    size = arr.shape[dim] // m
    index = [slice(None)] * arr.ndim
    index[dim] = slice(r * size, (r + 1) * size)
    return arr[tuple(index)]


def test_checkpoint_restores_onto_another_mesh(runs):
    """A step saved on (1, 4) restores onto (2, 2): every rank's
    parameters and moments equal its slice of the whole leaves, bit for
    bit, and the step counter is restored."""
    _check_restored(runs, "ckpt_step", "restored")


@pytest.mark.parametrize("case", ["hybrid", "audio"])
def test_checkpoint_of_a_cut_family_restores_across_meshes(runs, case):
    """The hybrid's and whisper's steps saved on (1, 4) (the RG-LRU, the
    GeLU MLPs, the token table and the head cut) restore onto (2, 2),
    every rank its slices bit for bit, and onto (1, 1) in this process,
    the whole leaves bit for bit."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import _flatten_with_names
    from repro_torch.models.convert import params_to_numpy

    _check_restored(runs, f"ckpt_{case}", ("restored", case))
    params, opt = _whole_files(runs["dir"] / f"ckpt_{case}" /
                               "step0000000001")
    _, cfg = _cfgs(case)
    assert not dist.is_initialized()
    mesh = make_local_mesh("cpu")
    try:
        q = build_model(cfg, device="cpu").init(1)
        qo = adamw_init(q)
        q, qo, step = CheckpointManager(
            str(runs["dir"] / f"ckpt_{case}")).restore_latest(q, qo,
                                                              mesh=mesh)
    finally:
        multihost.shutdown()
    assert step == 1 and q.placement.cut == {}
    for path, arr in _leaves(params_to_numpy(q)):
        np.testing.assert_array_equal(arr, params[path], err_msg=path)
    for name, arr in _flatten_with_names(qo).items():
        np.testing.assert_array_equal(arr, opt[name], err_msg=name)


def _check_restored(runs, ckpt: str, key) -> None:
    """Every (2, 2) rank's restored parameters and moments (``key`` of its
    results) are its slices of checkpoint ``ckpt``'s whole leaves."""
    from repro_torch.models.convert import ref_path

    params, opt = _whole_files(runs["dir"] / ckpt / "step0000000001")
    for res in runs[4]:
        r, step, got_p, got_o, cut = res[key]
        assert step == 1 and int(got_o[".step"]) == int(opt[".step"]) == 1
        dims = {}
        for name, dim in cut.items():
            path, layer = ref_path(name)
            dims["/".join(path)] = dim + (layer is not None)
        assert dims, "nothing was cut on (2, 2)"
        for path, arr in _leaves(got_p):
            np.testing.assert_array_equal(
                arr, _slice(params[path], dims.get(path), 2, r),
                err_msg=path)
        for name, arr in got_o.items():
            if name == ".step":
                continue
            leaf = name.split("/", 1)[1]
            np.testing.assert_array_equal(
                arr, _slice(opt[name], dims.get(leaf), 2, r), err_msg=name)


def test_checkpoint_restores_onto_one_rank(runs):
    """The same step restores onto a (1, 1) mesh in this process: the
    whole leaves, bit for bit."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpoint import _flatten_with_names
    from repro_torch.models.convert import params_to_numpy

    params, opt = _whole_files(runs["dir"] / "ckpt_step" / "step0000000001")
    _, cfg = _cfgs("moe")
    assert not dist.is_initialized()
    mesh = make_local_mesh("cpu")
    try:
        q = build_model(cfg, device="cpu").init(1)
        qo = adamw_init(q)
        q, qo, step = CheckpointManager(
            str(runs["dir"] / "ckpt_step")).restore_latest(q, qo, mesh=mesh)
    finally:
        multihost.shutdown()
    assert step == 1 and q.placement.cut == {}
    for path, arr in _leaves(params_to_numpy(q)):
        np.testing.assert_array_equal(arr, params[path], err_msg=path)
    for name, arr in _flatten_with_names(qo).items():
        np.testing.assert_array_equal(arr, opt[name], err_msg=name)


def test_lm_train_step_under_local_mesh(runs):
    """``tests/test_system.py::test_lm_train_step_under_local_mesh`` on 4
    gloo ranks: the qwen2-moe smoke config, ``make_batch(cfg, 4, 32, 0)``,
    ``AdamWConfig(lr=5e-3)``, 6 steps under ``make_local_mesh()``: the
    loss falls, and every rank reports the same losses."""
    seen = [res["falls"] for res in runs[4]]
    shape, losses = seen[0]
    assert shape == (1, 4)
    assert all(s == seen[0] for s in seen), seen
    assert losses[-1] < losses[0], losses


def test_train_cli_on_four_ranks(runs):
    """``python -m repro_torch.launch --nprocs 4 --device cpu -m
    repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke --steps 3
    --batch 4 --seq 32``: every rank trains on the (1, 4) mesh and ends."""
    run = runs["cli"]
    assert run.returncode == 0, run.stderr[-3000:]
    for pid in range(4):
        assert f"[p{pid}] done" in run.stdout, run.stdout[-3000:]
        assert f"[p{pid}] arch=qwen2-moe-a2.7b" in run.stdout
    assert "mesh=(1, 4)" in run.stdout
