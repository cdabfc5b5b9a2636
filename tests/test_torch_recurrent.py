"""The port's ssm and hybrid families (mamba2-130m, recurrentgemma-2b)
against the JAX package, on the CPU, at smoke sizes.

Inputs are made from a seed with numpy and fed to both packages; weights
are made by the JAX package and carried across with
``repro_torch.models.convert.params_from_numpy`` (or, for one module, its
parameter dict).  On CPU tensors the attention wrapper runs its plain
version; the CUDA kernels are held to that version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those of ``tests/test_torch_lm.py``: 1e-4 in float32
(summation order), 2e-2 in bfloat16 (bf16 rounds at other places in the
two frameworks), as atol = rtol; a bf16 module's output is held to 2e-2 of
its largest magnitude (one ulp of a large element passes through the next
product into elements of any size).  The attention functions' own limit
in float32 is 2e-5, their backward's 1e-5 (O(1) inputs), as in the dense
family's tests.
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
from repro.launch.train import make_serve_step as jax_make_serve_step
from repro.models import attention as JA
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
from repro_torch.launch.train import make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model_zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, dtype: str) -> None:
    g, w = _np(got), _np(want)
    scale = max(1.0, float(np.abs(w).max())) if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(g, w, atol=TOL[dtype] * scale,
                               rtol=TOL[dtype])


def _cfg(arch: str, dtype: str = "float32", **kw):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype, **kw))


def _torch_params(jp: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in jp.items()}


def _x(rng, shape, dtype: str):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _with_random_gates(jp: dict, rng, names) -> dict:
    """The init's constant leaves (A_log, D, dt_bias, lam, norm_g) given
    random values, so that a wrong use of them shows."""
    out = dict(jp)
    for k in names:
        out[k] = jnp.asarray(np.asarray(jp[k]) +
                             rng.normal(size=jp[k].shape) * 0.5, jnp.float32)
    return out


# ------------------------------------------------------- (a) ssm mixer
@pytest.mark.parametrize("t", [9, 16, 37])  # below, at and past chunk 16
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_mixer_matches_jax(t, dtype):
    jcfg, tcfg = _cfg("mamba2-130m", dtype)
    rng = np.random.default_rng(t)
    jp = _with_random_gates(JS.init_ssm(jax.random.key(t), jcfg), rng,
                            ("A_log", "D", "dt_bias", "norm_g"))
    tp = TS.SSM(tcfg, _torch_params(jp))
    ju, tu = _x(rng, (2, t, jcfg.d_model), dtype)
    want = jax.jit(JS.ssm_mixer, static_argnums=2)(jp, ju, jcfg)
    with torch.inference_mode():
        got = TS.ssm_mixer(tp, tu, tcfg)
    assert got.dtype == tu.dtype and got.shape == tu.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("a_log", [0.0, 4.0])
def test_ssm_mixer_gradient_matches_jax_where_finite(a_log):
    """The input gradient against ``jax.grad``.  At A_log = 4 the
    log-decay above the diagonal passes 88, ``exp`` overflows, and the
    reference's ``where(causal, exp(decay), 0)`` gives 0 * inf = NaN in its
    backward; the port masks the exponent first, so its gradient stays
    finite and its forward equal to the reference's."""
    jcfg, tcfg = _cfg("mamba2-130m")
    rng = np.random.default_rng(11)
    jp = JS.init_ssm(jax.random.key(11), jcfg)
    jp = dict(jp, A_log=jnp.full(jp["A_log"].shape, a_log, jnp.float32))
    tp = TS.SSM(tcfg, _torch_params(jp))
    ju, tu = _x(rng, (1, 37, jcfg.d_model), "float32")
    f = lambda u: jnp.sum(JS.ssm_mixer(jp, u, jcfg) ** 2)
    want = jax.grad(f)(ju)
    tu.requires_grad_()
    out = TS.ssm_mixer(tp, tu, tcfg)
    _close(out, JS.ssm_mixer(jp, ju, jcfg), "float32")
    (out ** 2).sum().backward()
    assert torch.isfinite(tu.grad).all()
    if a_log == 0.0:
        _close(tu.grad, want, "float32")
    else:
        assert np.isnan(np.asarray(want)).any()


def test_ssm_bf16_layers_and_loss_match_jax():
    """The 2-layer bf16 smoke model at T = 150: each layer's mixer output
    given the reference's own layer input, and the loss, within bf16's
    2e-2.  (Its whole-model hidden states are held in float32 only, in
    tests/test_torch_lm.py: in bf16 the reference lies 0.0723 from its
    own float32 result, at the 0.0725 limit, so two bf16 roundings of the
    stack part by more; a 1-ulp difference in the bf16 dt projection moves
    the decay of a whole chunk.)"""
    from repro.data.tokens import make_batch as jax_make_batch
    from repro.models.common import rms_norm as jax_rms_norm
    from repro_torch.models.common import rms_norm

    jcfg, tcfg = _cfg("mamba2-130m", "bfloat16")
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jb = jax_make_batch(jcfg, 2, 150, 0)
    x = JT.emb.embed(jp["embed"], jb["tokens"], jcfg)
    mixer = jax.jit(JS.ssm_mixer, static_argnums=2)
    for i, block in enumerate(tp.blocks):
        bp = jax.tree.map(lambda a: a[i], jp["blocks"])
        jy = mixer(bp["ssm"], jax_rms_norm(x, bp["ln1"], jcfg.norm_eps), jcfg)
        with torch.inference_mode():
            tx = torch.from_numpy(np.asarray(x, np.float32)).to(
                torch.bfloat16)
            ty = TS.ssm_mixer(block.ssm, rms_norm(tx, block.ln1,
                                                  tcfg.norm_eps), tcfg)
        _close(ty, jy, "bfloat16")
        x = x + jy
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    with torch.inference_mode():
        loss = float(build_model(tcfg, device="cpu").loss(tp, tb))
    np.testing.assert_allclose(loss, float(jax.jit(jm.loss)(jp, jb)),
                               atol=TOL["bfloat16"], rtol=TOL["bfloat16"])


def test_ssm_decode_steps_match_jax():
    """20 steps from zero state: each step's output and the conv ring and
    state after it."""
    jcfg, tcfg = _cfg("mamba2-130m")
    rng = np.random.default_rng(12)
    jp = _with_random_gates(JS.init_ssm(jax.random.key(12), jcfg), rng,
                            ("A_log", "D", "dt_bias"))
    tp = TS.SSM(tcfg, _torch_params(jp))
    jstate = JS.init_ssm_state(jcfg, 2)
    tstate = TS.init_ssm_state(tcfg, 2, device="cpu")
    jstep = jax.jit(JS.ssm_decode_step, static_argnums=3)
    for _ in range(20):
        ju, tu = _x(rng, (2, 1, jcfg.d_model), "float32")
        jy, jstate = jstep(jp, ju, jstate, jcfg)
        with torch.inference_mode():
            ty, tstate = TS.ssm_decode_step(tp, tu, tstate, tcfg)
        _close(ty, jy, "float32")
        for name in ("conv", "ssm"):
            assert tstate[name].dtype == TDT[str(jstate[name].dtype)]
            _close(tstate[name], jstate[name], "float32")


def test_ssm_decode_continues_the_chunked_prefill():
    """The recurrent form and the chunked form are one function: decoding
    a sequence token by token gives the mixer's outputs (port only)."""
    _, tcfg = _cfg("mamba2-130m")
    gen = torch.Generator().manual_seed(0)
    p = TS.init_ssm(gen, tcfg)
    u = torch.randn((2, 37, tcfg.d_model), generator=gen)
    with torch.inference_mode():
        full = TS.ssm_mixer(p, u, tcfg)
        state = TS.init_ssm_state(tcfg, 2, device="cpu")
        steps = []
        for i in range(37):
            y, state = TS.ssm_decode_step(p, u[:, i:i + 1], state, tcfg)
            steps.append(y)
    _close(torch.cat(steps, 1), full, "float32")


# ------------------------------------------------------------ (b) RG-LRU
@pytest.mark.parametrize("t", [1, 2, 37, 100])
def test_linear_scan_is_jax_associative_scan(t):
    """The odd/even recursion gives the reference's bits (the same combine
    tree), and the sequential recurrence's values."""
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, size=(2, t, 5)).astype(np.float32)
    b = rng.normal(size=(2, t, 5)).astype(np.float32)
    combine = lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1])
    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                 jnp.asarray(b)), axis=1)
    _, got = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    h, seq = np.zeros((2, 5), np.float32), []
    for i in range(t):
        h = a[:, i] * h + b[:, i]
        seq.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(seq, 1), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("t", [37, 100])  # odd, and not a power of two
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_jax(t, dtype):
    jcfg, tcfg = _cfg("recurrentgemma-2b", dtype)
    rng = np.random.default_rng(t + 1)
    jp = _with_random_gates(JR.init_rglru_block(jax.random.key(t), jcfg),
                            rng, ("lam",))
    tp = TR.RGLRU(tcfg, _torch_params(jp))
    ju, tu = _x(rng, (2, t, jcfg.d_model), dtype)
    want = jax.jit(JR.rglru_block, static_argnums=2)(jp, ju, jcfg)
    with torch.inference_mode():
        got = TR.rglru_block(tp, tu, tcfg)
    _close(got, want, dtype)


def test_rglru_decode_steps_match_jax():
    jcfg, tcfg = _cfg("recurrentgemma-2b")
    rng = np.random.default_rng(13)
    jp = JR.init_rglru_block(jax.random.key(13), jcfg)
    tp = TR.RGLRU(tcfg, _torch_params(jp))
    jstate = JR.init_rglru_state(jcfg, 2)
    tstate = TR.init_rglru_state(tcfg, 2, device="cpu")
    jstep = jax.jit(JR.rglru_decode_step, static_argnums=3)
    for _ in range(12):
        ju, tu = _x(rng, (2, 1, jcfg.d_model), "float32")
        jy, jstate = jstep(jp, ju, jstate, jcfg)
        with torch.inference_mode():
            ty, tstate = TR.rglru_decode_step(tp, tu, tstate, tcfg)
        _close(ty, jy, "float32")
        for name in ("conv", "h"):
            _close(tstate[name], jstate[name], "float32")


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; at x = -3 it lies
    more than 1e-4 from the exact form, and the block's GeLU branch holds
    the reference's."""
    x = np.linspace(-4, 4, 81).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4
    jcfg, tcfg = _cfg("recurrentgemma-2b")
    jp = JR.init_rglru_block(jax.random.key(0), jcfg)
    tp = TR.RGLRU(tcfg, _torch_params(jp))
    rng = np.random.default_rng(0)
    u = (rng.normal(size=(1, 5, jcfg.d_model)) * 3).astype(np.float32)
    jy = jax.nn.gelu(jnp.asarray(u) @ jp["w_y"])
    with torch.inference_mode():
        ty = torch.nn.functional.gelu(torch.from_numpy(u) @ tp.w_y,
                                      approximate="tanh")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    # and the whole block agrees only with the tanh form
    with torch.inference_mode():
        got = TR.rglru_block(tp, torch.from_numpy(u), tcfg)
    _close(got, jax.jit(JR.rglru_block, static_argnums=2)(
        jp, jnp.asarray(u), jcfg), "float32")


# ------------------------------------------------- (c) windowed attention
def _qkv(rng, b, t, h, kv, d, dtype="float32"):
    mk = lambda heads: rng.normal(size=(b, t, heads, d)).astype(np.float32)
    arrs = (mk(h), mk(kv), mk(kv))
    return ([jnp.asarray(a, JDT[dtype]) for a in arrs],
            [torch.from_numpy(a).to(TDT[dtype]) for a in arrs])


@pytest.mark.parametrize("hd", [32, 256])
@pytest.mark.parametrize("window", [1, 16, 47, 48, 100])  # T = 48
def test_windowed_attention_matches_blocked_attn(window, hd):
    """The wrapper with a window (1, 16, T-1, T and past T) against
    ``_blocked_attn``'s local mask; a window of at least T gives the
    unwindowed result."""
    (jq, jk, jv), (q, k, v) = _qkv(np.random.default_rng(window), 2, 48, 4,
                                   1, hd)
    want = JA._blocked_attn(jq, jk, jv, True, window, 16, 32)
    got = flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    if window >= 48:
        assert torch.equal(got, flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("causal,t,s,q_offset,window", [
    (True, 48, 48, 0, 5), (True, 40, 90, 50, 16), (False, 30, 30, 0, 7),
    (True, 48, 48, 0, 1)])
def test_windowed_backward_matches_jax_grad(causal, t, s, q_offset, window):
    """``flash_attention_plain`` and ``flash_attention_bwd_plain`` with a
    window (the CPU path of ``FlashAttentionFn``) against ``jax.grad`` of
    ``_blocked_attn``."""
    rng = np.random.default_rng(window)
    mk = lambda n, heads: rng.normal(size=(2, n, heads, 16)).astype(
        np.float32)
    q, k, v, do = mk(t, 4), mk(s, 2), mk(s, 2), mk(t, 4)
    f = lambda q_, k_, v_: JA._blocked_attn(q_, k_, v_, causal, window, 16,
                                            32, q_offset=q_offset)
    jo = f(*map(jnp.asarray, (q, k, v)))
    want = jax.grad(lambda *a: jnp.sum(f(*a) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                   q_offset=q_offset, window=window,
                                   return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal,
                                      q_offset=q_offset, window=window)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (flash_attention(*leaves, causal=causal, q_offset=q_offset,
                     window=window) * tdo).sum().backward()
    for got in (plain, [x.grad for x in leaves]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("hd,window", [(32, 8), (256, 0), (256, 8)])
def test_backward_with_window_and_hd256_matches_jax_grad(hd, window):
    """The shapes the backward kernels now take (a window, hd 256): the
    plain backward and ``FlashAttentionFn`` on CPU tensors against
    ``jax.grad`` of ``_blocked_attn`` (GQA 2, T = 40 past the window); the
    card's kernels are held to the plain backward at these shapes in
    ``tests/test_torch_cuda.py``."""
    rng = np.random.default_rng(hd + window)
    mk = lambda heads: rng.normal(size=(1, 40, heads, hd)).astype(np.float32)
    q, k, v, do = mk(4), mk(2), mk(2), mk(4)
    f = lambda q_, k_, v_: JA._blocked_attn(q_, k_, v_, True, window, 16, 32)
    want = jax.grad(lambda *a: jnp.sum(f(*a) * do), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, window=window,
                                   return_lse=True)
    plain = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, window=window)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    (flash_attention(*leaves, window=window) * tdo).sum().backward()
    for got in (plain, [x.grad for x in leaves]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("max_len", [10, 40])  # below and above window 16
def test_ring_buffer_decode_matches_jax(max_len):
    """decode_attention with the smoke window (16) through 48 steps, 3x
    the window: the ring of min(window, max_len) slots wraps, and the age
    rule (floor modulo) picks the same slots as the reference's."""
    jcfg, tcfg = _cfg("recurrentgemma-2b")
    w = jcfg.hybrid.window
    jp = JA.init_attention(jax.random.key(7), jcfg)
    tp = TA.Attention(tcfg, _torch_params(jp))
    L = min(w, max_len)
    jcache = JA.init_kv_cache(jcfg, 2, L)
    tcache = TA.init_kv_cache(tcfg, 2, L, device="cpu")
    jdecode = jax.jit(JA.decode_attention, static_argnums=4,
                      static_argnames="window")
    rng = np.random.default_rng(max_len)
    for pos in range(3 * w):
        jx, tx = _x(rng, (2, 1, jcfg.d_model), "float32")
        jo, jcache = jdecode(jp, jx, jcache, jnp.int32(pos), jcfg, window=w)
        with torch.inference_mode():
            to, tcache = TA.decode_attention(tp, tx, tcache, pos, tcfg,
                                             window=w)
        np.testing.assert_allclose(_np(to), _np(jo), atol=2e-5, rtol=2e-5,
                                   err_msg=f"pos {pos}")
    for name in ("k", "v"):
        _close(tcache[name], jcache[name], "float32")


# ----------------------------------------------------- (d) whole models
def _models(arch: str, seed: int = 0, **kw):
    jcfg, tcfg = _cfg(arch, **kw)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, jp, build_model(tcfg, device="cpu"), tp


def _tree_leaves(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{path: array} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: _np(tree)}
    out = {}
    for k, v in items:
        out.update(_tree_leaves(v, f"{prefix}/{k}"))
    return out


def _caches_close(tcache, jcache) -> None:
    got, want = _tree_leaves(tcache), _tree_leaves(jcache)
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=TOL["float32"],
                                   rtol=TOL["float32"], err_msg=path)


def test_hybrid_decode_crosses_the_ring_wrap_with_a_tail():
    """A 5-layer hybrid (one group and a tail of 2 recurrent layers),
    greedy decode over 40 steps with max_len 64: the ring of 16 slots
    wraps twice; tokens equal, every cache leaf close (float32)."""
    jcfg, tcfg, jm, jp, tm, tp = _models("recurrentgemma-2b", seed=3,
                                         n_layers=5)
    assert len(tp.tail) == 2 and len(jp["tail"]) == 2
    jstep = jax.jit(jax_make_serve_step(jm))
    tstep = make_serve_step(tm)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 1))
    jtok, ttok = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jcache, tcache = jm.init_cache(2, 64), tm.init_cache(2, 64)
    assert tcache["attn"]["k"].shape[2] == jcfg.hybrid.window
    for pos in range(40):
        jn, jcache = jstep(jp, jcache, {"tokens": jtok,
                                        "pos": jnp.int32(pos)})
        tn, tcache = tstep(tp, tcache, {"tokens": ttok, "pos": pos})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jtok, ttok = jn[:, None], tn[:, None]
    _caches_close(tcache, jcache)


@pytest.mark.parametrize("arch,n_layers", [("mamba2-130m", 2),
                                           ("recurrentgemma-2b", 3),
                                           ("recurrentgemma-2b", 4)])
def test_params_round_trip_bit_for_bit(arch, n_layers):
    """The reference's tree -> the port's LM -> the reference's tree gives
    the same leaves, and the port's LM -> tree -> LM the same
    parameters."""
    jcfg, tcfg, jm, jp, tm, tp = _models(arch, n_layers=n_layers)
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    fresh = tm.init(4)
    again = params_from_numpy(params_to_numpy(fresh), tcfg, "cpu")
    assert [n for n, _ in again.named_parameters()] == \
        [n for n, _ in fresh.named_parameters()]
    for a, b in zip(again.parameters(), fresh.parameters()):
        assert torch.equal(a, b)


def test_configs_and_param_counts_match_jax():
    for arch in ("mamba2-130m", "recurrentgemma-2b"):
        for get, jget in ((get_config, jax_get_config),
                          (get_smoke_config, jax_smoke_config)):
            mine, theirs = (dataclasses.asdict(get(arch)),
                            dataclasses.asdict(jget(arch)))
            assert all(theirs[k] is None for k in set(theirs) - set(mine))
            assert mine == {k: theirs[k] for k in mine}, arch
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count()
    # recurrentgemma-2b at full size: 26 layers, 8 groups and a tail of 2
    assert TT.hybrid_counts(get_config("recurrentgemma-2b")) == (8, 2)


def test_hybrid_remat_covers_the_group(monkeypatch):
    """With remat and grad, a hybrid group runs under one checkpoint (the
    reference checkpoints the group), and the tail does not."""
    _, tcfg = _cfg("recurrentgemma-2b", n_layers=4, remat=True)
    tp = build_model(tcfg, device="cpu").init(0)
    calls = []
    real = TT._remat

    def spy(fn, cfg, policy=None):
        calls.append((type(fn).__name__, policy))
        return real(fn, cfg, policy)

    monkeypatch.setattr(TT, "_remat", spy)
    TT.lm_forward(tp, torch.zeros((1, 5), dtype=torch.long), tcfg)
    assert calls == [("HybridGroup", "full")]


# ------------------------------------------------------------ (e) CLIs
def test_cli_defaults_to_mamba2_and_runs_the_families_without_jax():
    """``python -m repro_torch.launch.train --smoke --device cpu`` trains
    mamba2-130m, the reference's default; the serve CLI runs the hybrid;
    neither pulls in jax or the JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve, train\n"
        "train.main(['--smoke', '--steps', '2', '--batch', '2', '--seq',"
        " '40', '--device', 'cpu'])\n"
        "serve.main(['--arch', 'recurrentgemma-2b', '--smoke', '--device',"
        " 'cpu', '--steps', '20', '--batches', '2', '--max-len', '32'])\n"
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
    assert "arch=mamba2-130m device=cpu" in out.stdout
    assert "arch=recurrentgemma-2b device=cpu" in out.stdout
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
