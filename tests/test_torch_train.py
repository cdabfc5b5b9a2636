"""The port's LM training path against the JAX package, on the CPU.

Inputs, weights and gradients are made from a seed with numpy (or by the
JAX package) and handed to both packages: weights and gradient trees
through ``repro_torch.models.convert.params_from_numpy``, the port's
back through ``params_to_numpy`` and ``opt_state_to_numpy``.  The JAX side
runs without a mesh.  On CPU tensors the attention wrapper runs its plain
forward and ``flash_attention_bwd_plain`` inside ``FlashAttentionFn``; the
CUDA backward is held to that version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, each for summation order in float32:
  * AdamW: 1e-6 relative, plus 1e-6 of the leaf's largest magnitude for
    entries that cancel to near zero (the moments of opposite-signed
    gradients);
  * the attention backward against ``jax.grad`` of ``_blocked_attn``: 1e-5
    (atol = rtol; O(1) inputs);
  * the loss, 1e-5 relative; each gradient leaf of a two-layer smoke model,
    1e-4 relative in L2 (the sums of two layers and a 512-way softmax);
  * three train steps: losses 1e-5 relative, parameters 1e-5 absolute at
    the default learning rate (3e-4): Adam's normalised step m / sqrt(v)
    turns a rounding difference in a gradient near zero into up to lr;
  * compression: bit-exact (both packages round half to even);
  * the same port computation with remat on and off: 1e-6 (the recompute
    runs the same ops, the backward may sum in another order).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core  # noqa: F401  (x64 on, as in production)
import jax
import jax.numpy as jnp

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import attention as JA
from repro.models.common import shard_map
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim import adamw as JO
from repro.optim import compression as JC
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import make_batch
from repro_torch.kernels.flash_attention.ops import (FlashAttentionFn,
                                                     flash_attention,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
from repro_torch.launch import multihost
from repro_torch.launch.multihost import launch_localhost
from repro_torch.launch.train import make_train_step
from repro_torch.models.convert import (opt_state_from_numpy,
                                        opt_state_to_numpy, params_from_numpy,
                                        params_to_numpy, ref_path)
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import compression as TC
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "qwen1.5-4b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
         "mamba2-130m", "recurrentgemma-2b", "internvl2-2b", "whisper-tiny"]


def _f32(arch: str):
    """The JAX and port smoke configs of ``arch`` in float32."""
    return (dataclasses.replace(jax_smoke_config(arch), dtype="float32"),
            dataclasses.replace(get_smoke_config(arch), dtype="float32"))


def _leaves(tree) -> list[tuple[str, np.ndarray]]:
    """(path, array) of a nested dict's (and list's) leaves, keys sorted;
    an empty list (a hybrid model's empty tail) has none."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, a) for k in sorted(tree)
                for p, a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}/{p}" if p else str(i), a) for i, x in enumerate(tree)
                for p, a in _leaves(x)]
    return [("", np.asarray(tree))]


def _tree_close(got, want, rtol: float, scaled_atol: float = 0.0) -> None:
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        atol = scaled_atol * max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=path)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _models(arch: str, seed: int = 0):
    jcfg, tcfg = _f32(arch)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, jp, build_model(tcfg, device="cpu"), tp


def _random_like(tree, rng, scale: float):
    return jax.tree.map(
        lambda a: (rng.normal(size=np.shape(a)) * scale).astype(np.float32),
        tree)


# ------------------------------------------------------------ (a) AdamW
@pytest.mark.parametrize("clip", [True, False])
def test_adamw_update_matches_jax(clip):
    """Three steps on a random tree shaped like the qwen1.5-4b smoke model:
    parameters, m, v, the step and grad_norm, with the global-norm clip
    active (gradients of norm ~ 100) or not (norm ~ 0.1)."""
    jcfg, tcfg = _f32("qwen1.5-4b")
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0))
    rng = np.random.default_rng(3)
    p_np = _random_like(shapes, rng, 0.5)
    ocfg = AdamWConfig()
    jp = jax.tree.map(jnp.asarray, p_np)
    jo = JO.adamw_init(jp)
    tp = params_from_numpy(p_np, tcfg, "cpu")
    to = adamw_init(tp)
    n = sum(np.size(a) for a in jax.tree.leaves(p_np))
    for _ in range(3):
        g_np = _random_like(shapes, rng, (10.0 if clip else 0.01) /
                            np.sqrt(n / 100))
        jp, jo, jinfo = JO.adamw_update(ocfg, jp, jax.tree.map(jnp.asarray,
                                                               g_np), jo)
        grads = {k: v.detach() for k, v in
                 params_from_numpy(g_np, tcfg, "cpu").named_parameters()}
        tp, to, tinfo = adamw_update(ocfg, tp, grads, to)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        assert (float(jinfo["grad_norm"]) > ocfg.grad_clip) == clip
    step, m, v = opt_state_to_numpy(to)
    assert step == int(jo.step) == 3 and to.step.dtype == torch.int32
    _tree_close(params_to_numpy(tp), jax.tree.map(np.asarray, jp), 1e-6,
                1e-6)
    _tree_close(m, jax.tree.map(np.asarray, jo.m), 1e-6, 1e-6)
    _tree_close(v, jax.tree.map(np.asarray, jo.v), 1e-6, 1e-6)


def test_adamw_state_is_the_reference_tree():
    """m and v are float32 trees in the reference's structure, blocks
    stacked on axis 0; a parameter's moment is a view into them; the
    converters carry a state both ways."""
    jcfg, tcfg, jm, jp, tm, tp = _models("llama3-8b")
    to = adamw_init(tp)
    jo = JO.adamw_init(jp)
    for tree, jtree in ((to.m, jo.m), (to.v, jo.v)):
        assert [(p, a.shape) for p, a in _leaves(
            jax.tree.map(lambda t: t.numpy(), tree))] == \
            [(p, a.shape) for p, a in _leaves(jtree)]
    assert ref_path("blocks.1.attn.wq") == (("blocks", "attn", "wq"), 1)
    assert ref_path("embed.table") == (("embed", "table"), None)
    rng = np.random.default_rng(0)
    m_np = _random_like(jax.tree.map(np.asarray, jo.m), rng, 1.0)
    st = opt_state_from_numpy(np.int32(7), m_np, m_np, device="cpu")
    step, m, v = opt_state_to_numpy(st)
    assert step == 7
    _tree_close(m, m_np, 0.0)
    _tree_close(v, m_np, 0.0)
    np.testing.assert_allclose(
        float(global_norm(p.detach() for p in tp.parameters())),
        float(JO.global_norm(jp)), rtol=1e-6)


# ------------------------------------------------------ (b) compression
def _grad_tree(rng):
    return {"w": (rng.normal(size=(64, 64)) * 3).astype(np.float32),
            "b": [rng.normal(size=(17,)).astype(np.float32),
                  np.linspace(-2.5, 2.5, 11, dtype=np.float32)]}


def test_compress_tree_is_bit_exact_with_jax():
    """q and scales equal the reference's bit for bit over three steps of
    error feedback (half-way values included: linspace hits x / scale =
    k + 0.5), and so do the residuals and the decompressed tree."""
    rng = np.random.default_rng(1)
    g = _grad_tree(rng)
    jst = JC.ef_init(jax.tree.map(jnp.asarray, g))
    tst = TC.ef_init(jax.tree.map(torch.from_numpy, g))
    for step in range(3):
        g = _grad_tree(rng) if step else g
        jq, js, jst = JC.compress_tree(jax.tree.map(jnp.asarray, g), jst)
        tq, ts, tst = TC.compress_tree(jax.tree.map(torch.from_numpy, g),
                                       tst)
        for want, got in ((jq, tq), (js, ts), (jst.residual, tst.residual),
                          (JC.decompress_tree(jq, js),
                           TC.decompress_tree(tq, ts))):
            for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(
                    jax.tree.map(lambda t: t.numpy(), got))):
                assert np.asarray(a).dtype == b.dtype
                np.testing.assert_array_equal(np.asarray(a), b)
        assert tq["w"].dtype == torch.int8


def test_error_feedback_accumulates_residual():
    """The counterpart of tests/test_substrates.py's: one dominant value
    sets the scale, sub-quantum values round to zero and are carried."""
    g = {"w": torch.tensor([127.0] + [0.3] * 7)}
    state = TC.ef_init(g)
    q1, s1, state = TC.compress_tree(g, state)
    assert int(q1["w"][1]) == 0  # rounded away this step...
    assert float(state.residual["w"][1]) == pytest.approx(0.3)  # ...kept
    # ...and sent the next step, when 0.3 + 0.3 rounds to one quantum
    q2, _, state = TC.compress_tree(g, state)
    assert int(q2["w"][1]) == 1
    assert float(state.residual["w"][1]) == pytest.approx(-0.4)


@pytest.fixture
def gloo_world():
    """A world-size-1 gloo group for the test, then none (other test files
    of the same worker start without one)."""
    assert not dist.is_initialized()
    multihost.ensure_initialized(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    yield dist.group.WORLD
    multihost.shutdown()
    assert not dist.is_initialized()


def test_pod_allreduce_compressed_one_rank_matches_jax(gloo_world):
    """One gloo rank against the reference's shard_map over a (1,) mesh
    (tests/test_substrates.py::test_compressed_allreduce_close_to_exact):
    the same bits, and within one quantum of the exact gradient."""
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32)}
    mesh = jax.make_mesh((1,), ("pod",))
    spec = jax.sharding.PartitionSpec()
    jout, jst = shard_map(
        lambda grads: JC.pod_allreduce_compressed(
            grads, JC.ef_init(grads), axis="pod"),
        mesh=mesh, in_specs=(spec,), out_specs=(spec, spec),
        check_vma=False)(jax.tree.map(jnp.asarray, g))
    tg = jax.tree.map(torch.from_numpy, g)
    tout, tst = TC.pod_allreduce_compressed(tg, TC.ef_init(tg), gloo_world)
    np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))
    np.testing.assert_array_equal(tst.residual["w"].numpy(),
                                  np.asarray(jst.residual["w"]))
    scale = np.abs(g["w"]).max() / 127.0
    assert np.abs(tout["w"].numpy() - g["w"]).max() <= scale * 1.01


_CHILD = textwrap.dedent(
    r'''
    import pickle
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.optim.compression import (ef_init,
                                               pod_allreduce_compressed)

    assert "jax" not in sys.modules and "repro" not in sys.modules
    rank = dist.get_rank()
    rng = np.random.default_rng(100 + rank)
    g = {"w": (rng.normal(size=(33, 7)) * (1 + rank)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    tg = {"w": torch.from_numpy(g["w"]), "b": [torch.from_numpy(g["b"][0])]}
    state = ef_init(tg)
    outs = []
    for _ in range(2):
        out, state = pod_allreduce_compressed(tg, state)
        outs.append({"w": out["w"].numpy(), "b": out["b"][0].numpy(),
                     "rw": state.residual["w"].numpy()})
    with open(sys.argv[1] + f".{rank}", "wb") as f:
        pickle.dump({"g": g, "outs": outs}, f)
    '''
)


def _np_quantize(x):
    scale = np.maximum(np.abs(x).max(), np.float32(1e-12)) / np.float32(127)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, np.float32(scale), x - q.astype(np.float32) * scale


def test_pod_allreduce_compressed_two_gloo_ranks(tmp_path):
    """Two processes, one gloo group: each rank's result is the numpy
    formula -- the int8 payloads summed as int32, times the largest scale,
    over 2 -- for two steps of error feedback, bit for bit."""
    script, out = tmp_path / "child.py", tmp_path / "out"
    script.write_text(_CHILD)
    results = launch_localhost(2, [str(script), str(out)], device="cpu",
                               timeout=120.0, retries=1,
                               env={"OMP_NUM_THREADS": "2"})
    for r in results:
        assert r.ok, f"p{r.process_id} rc={r.returncode}\n{r.stderr[-4000:]}"
    ranks = [pickle.loads(Path(f"{out}.{r}").read_bytes()) for r in (0, 1)]
    res = [{"w": np.zeros_like(r["g"]["w"]), "b": np.zeros_like(r["g"]["b"][0])}
           for r in ranks]
    for step in range(2):
        parts = {}
        for name, get in (("w", lambda g: g["w"]), ("b", lambda g: g["b"][0])):
            qs = [_np_quantize(get(r["g"]) + res[i][name])
                  for i, r in enumerate(ranks)]
            for i, (_, _, nr) in enumerate(qs):
                res[i][name] = nr
            acc = sum(q.astype(np.int32) for q, _, _ in qs)
            parts[name] = acc.astype(np.float32) * max(s for _, s, _ in qs) \
                / np.float32(2)
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(r["outs"][step]["w"], parts["w"])
            np.testing.assert_array_equal(r["outs"][step]["b"], parts["b"])
            np.testing.assert_array_equal(r["outs"][step]["rw"], res[i]["w"])


# ------------------------------------------- (c) the attention backward
def _attn_inputs(rng, b, t, s, h, kv, d):
    mk = lambda n, heads: rng.normal(size=(b, n, heads, d)).astype(np.float32)
    return mk(t, h), mk(s, kv), mk(s, kv), mk(t, h)


@pytest.mark.parametrize("causal,t,s,h,kv,q_offset", [
    (True, 200, 200, 4, 2, 0),     # GQA, T not a block multiple
    (False, 130, 77, 4, 4, 0),     # global, T != S, odd lengths
    (True, 120, 333, 4, 2, 213),   # q_offset > 0 with T != S
    (True, 1, 1, 2, 1, 0),         # one query, one key
    (True, 65, 129, 6, 3, 64),     # odd lengths, group 2, q_offset
])
def test_flash_backward_matches_jax_grad(causal, t, s, h, kv, q_offset):
    """``flash_attention_bwd_plain`` and ``FlashAttentionFn`` (its CPU
    path) against ``jax.grad`` of ``_blocked_attn`` in float32."""
    q, k, v, do = _attn_inputs(np.random.default_rng(t + s), 2, t, s, h, kv,
                               32)
    f = lambda q_, k_, v_: jnp.sum(JA._blocked_attn(
        q_, k_, v_, causal, 0, 64, 128, q_offset=q_offset) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                   q_offset=q_offset, return_lse=True)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                      causal=causal, q_offset=q_offset)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = flash_attention(*leaves, causal=causal, q_offset=q_offset)
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    (out * tdo).sum().backward()
    for got in (plain, [x.grad for x in leaves]):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


def test_flash_function_saves_what_its_backward_needs():
    """The Function saves q, k, v, the output and the log-sum-exp; no grad
    means no Function (the inference path builds no graph)."""
    q, k, v, _ = (torch.from_numpy(a) for a in _attn_inputs(
        np.random.default_rng(0), 1, 9, 9, 2, 1, 16))
    q.requires_grad_()
    out = FlashAttentionFn.apply(q, k, v, True, 0)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (1, 2, 9)
    torch.testing.assert_close(
        saved[4], torch.logsumexp(torch.einsum(
            "bthd,bshd->bhts", q, k.repeat_interleave(2, 2)).masked_fill(
                torch.ones(9, 9, dtype=torch.bool).triu(1), -1e30) * 0.25,
            -1))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


# -------------------------------------------- (d) lm_loss and its grads
def _jax_batch(jcfg, tcfg, b, t, step):
    jb = jax_make_batch(jcfg, b, t, step)
    tb = make_batch(tcfg, b, t, step, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(jb["tokens"]))
    return jb, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """The float32 smoke model's loss and every gradient leaf against
    ``jax.value_and_grad(model.loss)``; the gradients pass through
    ``params_to_numpy`` into the reference's tree."""
    jcfg, tcfg, jm, jp, tm, tp = _models(arch)
    jb, tb = _jax_batch(jcfg, tcfg, 2, 150, 0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    loss = tm.loss(tp, tb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = params_to_numpy({n: p.grad for n, p in tp.named_parameters()})
    g, w = _leaves(got), _leaves(jax.tree.map(np.asarray, jgrads))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert _rel_l2(a, b) <= 1e-4, (path, _rel_l2(a, b))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_give_equal_gradients(arch, policy):
    """Activation checkpointing of the blocks and the loss chunks (and the
    "dots" policy, which keeps matmul outputs) changes no gradient; a
    grad-free call runs no checkpoint."""
    grads = []
    for remat in (False, True):
        _, tcfg = _f32(arch)
        tcfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        jcfg = dataclasses.replace(_f32(arch)[0], remat=remat)
        jm = jax_build_model(jcfg)
        tp = params_from_numpy(jax.tree.map(
            np.asarray, jm.init(jax.random.key(1))), tcfg, "cpu")
        tm = build_model(tcfg, device="cpu")
        tb = make_batch(tcfg, 2, 70, 3, device="cpu")
        tm.loss(tp, tb).backward()
        grads.append(params_to_numpy(
            {n: p.grad for n, p in tp.named_parameters()}))
        with torch.no_grad():
            assert tm.loss(tp, tb).grad_fn is None
    _tree_close(grads[1], grads[0], 1e-6, 1e-6)


# ------------------------------------------------ (e) make_train_step
def test_train_step_matches_jax_and_loss_falls():
    """Three steps in each package from the same weights and batches: the
    mesh-free counterpart of tests/test_system.py::
    test_lm_train_step_under_local_mesh and tests/test_substrates.py::
    test_adamw_reduces_loss on a dense smoke config (those use qwen2-moe
    and mamba2, families the port does not have yet)."""
    jcfg, tcfg, jm, jp, tm, tp = _models("qwen1.5-4b", seed=2)
    ocfg = AdamWConfig()
    jstep = jax.jit(jax_make_train_step(jm, ocfg))
    tstep = make_train_step(tm, ocfg)
    jo, to = JO.adamw_init(jp), adamw_init(tp)
    jl, tl = [], []
    batch_j, batch_t = _jax_batch(jcfg, tcfg, 4, 32, 0)
    for _ in range(3):
        jp, jo, jmet = jstep(jp, jo, batch_j)
        tp, to, tmet = tstep(tp, to, batch_t)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0], tl
    assert all(p.grad is None for p in tp.parameters())
    for (path, a), (_, b) in zip(_leaves(params_to_numpy(tp)),
                                 _leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=path)


# --------------------------------------------------- (f) checkpoints
def test_checkpoint_lm_roundtrip_and_gc(tmp_path):
    """The counterpart of tests/test_substrates.py::
    test_checkpoint_roundtrip_and_gc on the port's LM and OptState: keep=2
    garbage-collects, the restore is bit-exact and in place."""
    _, tcfg, _, _, tm, tp = _models("llama3-8b")
    to = adamw_init(tp)
    tstep = make_train_step(tm)
    tp, to, _ = tstep(tp, to, make_batch(tcfg, 2, 16, 0, device="cpu"))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(tp, to, s)
    assert mgr.latest_step() == 3
    assert len(list(tmp_path.glob("step*"))) == 2  # gc kept 2
    fresh = tm.init(9)
    fresh_opt = adamw_init(fresh)
    m_leaf = fresh_opt.m["blocks"]["mlp"]["w1"]
    p2, o2, step = mgr.restore_latest(fresh, fresh_opt)
    assert step == 3 and p2 is fresh and o2.m["blocks"]["mlp"]["w1"] is m_leaf
    for a, b in zip(tp.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    want, got = opt_state_to_numpy(to), opt_state_to_numpy(o2)
    assert got[0] == want[0] == 1
    _tree_close(got[1], want[1], 0.0)
    _tree_close(got[2], want[2], 0.0)


def test_checkpoint_async_save(tmp_path):
    _, _, _, _, tm, tp = _models("qwen1.5-4b", seed=1)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(tp, adamw_init(tp), 7)
    mgr.wait()
    assert mgr.latest_step() == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_restores_across_packages(arch, tmp_path):
    """A step written by either package's train CLI (its LM and
    OptState) restores in the other, bit for bit: leaves are named as the
    reference names them (``blocks/attn/wq``, ``.m/...``, ``.step``)."""
    jcfg, tcfg, jm, jp, tm, tp = _models(arch)
    jb, tb = _jax_batch(jcfg, tcfg, 2, 16, 0)
    jp, jo, _ = jax.jit(jax_make_train_step(jm, JO.AdamWConfig()))(
        jp, JO.adamw_init(jp), jb)
    JManager(str(tmp_path / "j")).save(jp, jo, 1)
    fresh = tm.init(4)
    p, o, step = CheckpointManager(str(tmp_path / "j")).restore_latest(
        fresh, adamw_init(fresh))
    assert step == 1
    _tree_close(params_to_numpy(p), jax.tree.map(np.asarray, jp), 0.0)
    got = opt_state_to_numpy(o)
    assert got[0] == int(jo.step) == 1
    _tree_close(got[1], jax.tree.map(np.asarray, jo.m), 0.0)
    _tree_close(got[2], jax.tree.map(np.asarray, jo.v), 0.0)
    # the other way round
    tp, to, _ = make_train_step(tm)(tp, adamw_init(tp), tb)
    CheckpointManager(str(tmp_path / "t")).save(tp, to, 2)
    jfresh = jm.init(jax.random.key(5))
    jp2, jo2, step = JManager(str(tmp_path / "t")).restore_latest(
        jfresh, JO.adamw_init(jfresh))
    assert step == 2
    _tree_close(jax.tree.map(np.asarray, jp2), params_to_numpy(tp), 0.0)
    want = opt_state_to_numpy(to)
    assert int(jo2.step) == want[0] == 1
    _tree_close(jax.tree.map(np.asarray, jo2.m), want[1], 0.0)
    _tree_close(jax.tree.map(np.asarray, jo2.v), want[2], 0.0)


# ---------------------------------------------------- (g) the train CLI
def test_train_cli_imports_neither_jax_nor_repro(tmp_path):
    """``python -m repro_torch.launch.train --arch qwen1.5-4b --smoke
    --steps 3 --device cpu`` in a fresh interpreter, checkpointing, and a
    second run that restores the last step, without jax or the JAX
    package."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        "args = ['--arch', 'qwen1.5-4b', '--smoke', '--steps', '3',"
        " '--batch', '2', '--seq', '32', '--device', 'cpu',"
        f" '--checkpoint-dir', {str(tmp_path)!r}, '--checkpoint-every', '3']\n"
        "train.main(args)\n"
        "train.main(args)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen1.5-4b device=cpu" in out.stdout
    assert out.stdout.count("done") == 2
    assert "restored checkpoint at step 3" in out.stdout
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 4 and all(np.isfinite(losses))
