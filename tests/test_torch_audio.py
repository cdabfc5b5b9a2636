"""The port's audio family (whisper-tiny: an encoder-decoder with
cross-attention) against the JAX package, on the CPU, at the smoke size.

Inputs are made from a seed with numpy (the batch's frames by each
package's ``make_batch``) and fed to both packages; weights are made by the
JAX package and carried across with
``repro_torch.models.convert.params_from_numpy``.  On CPU tensors the
attention wrapper runs its plain version (and ``flash_attention_bwd_plain``
under autograd); the CUDA kernels are held to it on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those of ``tests/test_torch_vlm.py`` and
``tests/test_torch_train.py`` for the same quantities: 1e-4 in float32, 2e-2
in bfloat16 (of the largest magnitude for hidden states), as atol = rtol;
the loss 1e-5 relative and each gradient leaf 1e-4 relative in L2 (float32);
train steps' parameters 1e-5 absolute; batches, weights and checkpoints
bit-exact.
"""
from __future__ import annotations

import dataclasses
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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.tokens import make_batch as jax_make_batch
from repro.launch.train import make_serve_step as jax_make_serve_step
from repro.launch.train import make_train_step as jax_make_train_step
from repro.models import attention as JA
from repro.models import mlp as JM
from repro.models import whisper as JW
from repro.models.model_zoo import build_model as jax_build_model
from repro.optim import adamw as JO
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs import LATER, get_config, get_smoke_config
from repro_torch.data.tokens import make_batch
from repro_torch.launch.train import make_serve_step, make_train_step
from repro_torch.models import attention as TA
from repro_torch.models import mlp as TM
from repro_torch.models import whisper as TW
from repro_torch.models.convert import (opt_state_to_numpy, params_from_numpy,
                                        params_to_numpy, ref_shapes)
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype: str, scaled: bool = False) -> None:
    """Within TOL[dtype] (atol = rtol); with ``scaled`` the atol is taken
    of max(1, the largest magnitude of ``want``), as hidden states are."""
    w = _np(want)
    atol = TOL[dtype] * (max(1.0, float(np.abs(w).max())) if scaled else 1.0)
    np.testing.assert_allclose(_np(got), w, atol=atol, rtol=TOL[dtype])


def _models(dtype: str = "float32", seed: int = 0):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, jp, build_model(tcfg, device="cpu"), tp


def _x(rng, *shape, scale: float = 1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _row(tree: dict, i: int) -> dict:
    """Layer i of a stacked reference subtree."""
    return jax.tree.map(lambda a: a[i], tree)


# --------------------------------------------------------- (a) layers
def test_layer_norm_and_gelu_mlp_match_jax():
    """``_layer_norm`` (float32 math, cast back) in both dtypes, and
    ``gelu_mlp`` with biases: tanh GeLU, as ``jax.nn.gelu`` (inputs of
    scale 3, where the exact form is 5e-4 away)."""
    jcfg, tcfg, jm, jp, tm, tp = _models()
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, 2, 9, jcfg.d_model, scale=3.0)
    g, b = (rng.normal(size=jcfg.d_model).astype(np.float32)
            for _ in range(2))
    for dtype, jdt, tdt in (("float32", jnp.float32, torch.float32),
                            ("bfloat16", jnp.bfloat16, torch.bfloat16)):
        want = JW._layer_norm(jx.astype(jdt), jnp.asarray(g), jnp.asarray(b),
                              jcfg.norm_eps)
        got = TW._layer_norm(tx.to(tdt), torch.from_numpy(g),
                             torch.from_numpy(b), tcfg.norm_eps)
        assert got.dtype == tdt
        _close(got, want, dtype)
    mlp = jax.tree.map(jnp.asarray, _row(jp["dec"]["mlp"], 1))
    mlp = {**mlp, "b1": jnp.asarray(rng.normal(size=jcfg.d_ff), jnp.float32),
           "b2": jnp.asarray(rng.normal(size=jcfg.d_model), jnp.float32)}
    tmlp = TM.GeLUMLP({k: torch.from_numpy(np.array(v))
                       for k, v in mlp.items()})
    with torch.no_grad():
        got = TM.gelu_mlp(tmlp, tx)
        exact = torch.nn.functional.gelu(tx @ tmlp.w1 + tmlp.b1) @ \
            tmlp.w2 + tmlp.b2
    _close(got, JM.gelu_mlp(mlp, jx), "float32")
    assert float((exact - got).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_without_rope_matches_jax(causal, dtype):
    """``attention(causal=..., use_rope=False)``: the encoder's non-causal
    self-attention and the decoder's causal one, learned positions only."""
    jcfg, tcfg, jm, jp, tm, tp = _models(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, tx = _x(np.random.default_rng(1), 2, 24, jcfg.d_model)
    p = _row(jp["enc"]["attn"], 0)
    want = JA.attention(p, jx.astype(jdt), jcfg, causal=causal,
                        use_rope=False)
    with torch.inference_mode():
        got = TA.attention(tp.enc[0].attn, tx.to(tcfg.cdtype), tcfg,
                           causal=causal, use_rope=False)
        roped = TA.attention(tp.enc[0].attn, tx.to(tcfg.cdtype), tcfg,
                             causal=causal)
    _close(got, want, dtype, scaled=True)
    assert not torch.equal(got, roped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,s", [(10, 32), (1, 32), (40, 7)])
def test_cross_attention_matches_jax(t, s, dtype):
    """``cross_attention``: T decoder positions against S != T encoder
    states, every key visible (T = 1 is the decode step's)."""
    jcfg, tcfg, jm, jp, tm, tp = _models(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(t + s)
    jx, tx = _x(rng, 2, t, jcfg.d_model)
    jkv, tkv = _x(rng, 2, s, jcfg.d_model)
    want = JA.cross_attention(_row(jp["dec"]["cross"], 1), jx.astype(jdt),
                              jkv.astype(jdt), jcfg)
    with torch.inference_mode():
        got = TA.cross_attention(tp.dec[1].cross, tx.to(tcfg.cdtype),
                                 tkv.to(tcfg.cdtype), tcfg)
    assert got.shape == (2, t, jcfg.d_model)
    _close(got, want, dtype, scaled=True)


# ------------------------------------------------------ (b) the model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encode_and_loss_match_jax(dtype):
    """``whisper_encode`` of the batch's frames and ``model.loss``
    (encoder, decoder, chunked cross-entropy against the tied ``tok``) at
    T = 150, past one loss chunk of 128."""
    jcfg, tcfg, jm, jp, tm, tp = _models(dtype)
    jb = jax_make_batch(jcfg, 2, 150, 0)
    tb = make_batch(tcfg, 2, 150, 0, device="cpu")
    with torch.inference_mode():
        enc = TW.whisper_encode(tp, tb["frames"], tcfg)
        loss = float(tm.loss(tp, tb))
    jenc = jax.jit(lambda p, f: JW.whisper_encode(p, f, jcfg))(
        jp, jb["frames"])
    assert enc.shape == (2, jcfg.encdec.n_frames, jcfg.d_model)
    assert enc.dtype == tcfg.cdtype
    _close(enc, jenc, dtype, scaled=True)
    _close(loss, float(jax.jit(jm.loss)(jp, jb)), dtype)


def test_whisper_loss_gradients_match_jax():
    """The float32 loss and every gradient leaf (``enc_pos``, ``dec_pos``,
    ``tok``, both stacks) against ``jax.value_and_grad(model.loss)``, the
    port's gradients through ``params_to_numpy`` into the reference's
    tree; with remat on and off."""
    jcfg, tcfg, jm, jp, tm, tp = _models(seed=3)
    jb = jax_make_batch(jcfg, 2, 40, 1)
    tb = make_batch(tcfg, 2, 40, 1, device="cpu")
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    want = jax.tree.map(np.asarray, jgrads)
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
        loss = build_model(cfg, device="cpu").loss(p, tb)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=1e-5)
        got = params_to_numpy({n: q.grad for n, q in p.named_parameters()})
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for path, a, b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree.leaves(got), jax.tree.leaves(want)):
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-4, (path[0], rel)


def test_whisper_decode_steps_match_jax():
    """``model.decode`` over the KV cache for 6 steps from the encoder
    states of the batch's frames, and ``make_serve_step``'s greedy token,
    against the reference's (float32): logits within 1e-4 of their largest
    magnitude, the stacked cache within 1e-4, the same tokens."""
    jcfg, tcfg, jm, jp, tm, tp = _models(seed=2)
    jb = jax_make_batch(jcfg, 2, 8, 0)
    tb = make_batch(tcfg, 2, 8, 0, device="cpu")
    jenc = JW.whisper_encode(jp, jb["frames"], jcfg)
    with torch.inference_mode():
        enc = TW.whisper_encode(tp, tb["frames"], tcfg)
    _close(enc, jenc, "float32", scaled=True)
    jcache, tcache = jm.init_cache(2, 10), tm.init_cache(2, 10)
    assert tcache["kv"]["k"].shape == (jcfg.n_layers, 2, 10,
                                       jcfg.n_kv_heads, jcfg.hd)
    jserve = jax.jit(jax_make_serve_step(jm))
    tserve = make_serve_step(tm)
    jtok = jb["tokens"][:, :1]
    ttok = tb["tokens"][:, :1]
    for pos in range(6):
        jl, _ = jm.decode(jp, jcache, {"enc": jenc, "tokens": jtok,
                                       "pos": jnp.int32(pos)})
        tl, _ = tm.decode(tp, {k: {n: x.clone() for n, x in v.items()}
                               for k, v in tcache.items()},
                          {"enc": enc, "tokens": ttok, "pos": pos})
        assert tl.shape == (2, 1, jcfg.vocab_size)
        _close(tl, jl, "float32", scaled=True)
        jnxt, jcache = jserve(jp, jcache, {"enc": jenc, "tokens": jtok,
                                           "pos": jnp.int32(pos)})
        tnxt, tcache = tserve(tp, tcache, {"enc": enc, "tokens": ttok,
                                           "pos": pos})
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
        jtok, ttok = jnxt[:, None], tnxt[:, None]
    for name in ("k", "v"):
        _close(tcache["kv"][name], jcache["kv"][name], "float32")


# ------------------------------------------- (c) data, weights, state
def test_make_batch_frames_are_bit_exact():
    """Tokens, labels and the frames drawn after them from one generator
    equal the reference's bit for bit, for several steps and seeds."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    for seed, step in ((0, 0), (0, 3), (5, 1)):
        tb = make_batch(cfg, 3, 21, step, seed, device="cpu")
        jb = jax_make_batch(jcfg, 3, 21, step, seed)
        assert set(tb) == set(jb) == {"tokens", "labels", "frames"}
        assert tb["frames"].dtype == torch.float32
        assert tb["frames"].shape == (3, cfg.encdec.n_frames, cfg.d_model)
        for name in tb:
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))


def test_whisper_params_round_trip_and_configs():
    """The reference's tree -> the port -> the tree bit for bit (``enc``
    and ``dec`` stacked on axis 0), a port-initialised model through the
    tree and back, ``ref_shapes``; the configs equal the reference's and
    none is left to port."""
    jcfg, tcfg, jm, jp, tm, tp = _models()
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.map(np.shape, want) == jax.tree.map(
        tuple, ref_shapes(tp), is_leaf=lambda x: isinstance(x, tuple))
    assert tuple(tp.dec_pos.shape) == (65536, jcfg.d_model)
    fresh = tm.init(1)
    assert [n for n, _ in fresh.named_parameters()][:4] == \
        ["enc_pos", "dec_pos", "tok", "enc.0.ln1.g"]
    again = params_from_numpy(params_to_numpy(fresh), tcfg, "cpu")
    for a, b in zip(again.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_smoke_config)):
        mine, theirs = (dataclasses.asdict(get(ARCH)),
                        dataclasses.asdict(jget(ARCH)))
        assert mine == theirs
    assert LATER == {}


def test_whisper_train_steps_match_jax_and_checkpoint(tmp_path):
    """Two AdamW steps in each package from the same weights and batches:
    losses 1e-5 relative, parameters 1e-5 absolute; then a checkpoint of
    the port's Whisper and OptState restores in place, bit for bit."""
    jcfg, tcfg, jm, jp, tm, tp = _models(seed=4)
    ocfg = AdamWConfig()
    jstep = jax.jit(jax_make_train_step(jm, JO.AdamWConfig()))
    tstep = make_train_step(tm, ocfg)
    jo, to = JO.adamw_init(jp), adamw_init(tp)
    for step in range(2):
        jb = jax_make_batch(jcfg, 2, 24, step)
        tb = make_batch(tcfg, 2, 24, step, device="cpu")
        jp, jo, jmet = jstep(jp, jo, jb)
        tp, to, tmet = tstep(tp, to, tb)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(tp, to, 2)
    fresh = tm.init(9)
    fresh_opt = adamw_init(fresh)
    p2, o2, step = mgr.restore_latest(fresh, fresh_opt)
    assert step == 2 and p2 is fresh
    for a, b in zip(tp.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    want, got = opt_state_to_numpy(to), opt_state_to_numpy(o2)
    assert got[0] == want[0] == 2
    for a, b in zip(jax.tree.leaves(got[1:]), jax.tree.leaves(want[1:])):
        np.testing.assert_array_equal(a, b)


def test_whisper_train_cli_runs_without_jax():
    """``python -m repro_torch.launch.train --arch whisper-tiny --smoke
    --device cpu`` in a fresh interpreter that never imports jax or the
    JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.launch import train\n"
        f"train.main(['--arch', {ARCH!r}, '--smoke', '--steps', '2',"
        " '--batch', '2', '--seq', '24', '--device', 'cpu'])\n"
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
    assert f"arch={ARCH} device=cpu" in out.stdout
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_loop_refuses_the_audio_family():
    """``serve_loop`` has no encoder input, as the reference's has none:
    it names ``make_serve_step`` for the audio decode instead of failing
    inside the decoder."""
    from repro_torch.launch.serve import serve_loop

    tm = build_model(get_smoke_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="make_serve_step"):
        serve_loop(tm, tm.init(0), batch_size=1, max_len=4, steps=1,
                   n_batches=1)
