"""The port's LM serving path (dense, moe, ssm, hybrid and vlm) against the
JAX package, on the CPU.

Inputs are made from a seed with numpy and fed to both packages; weights
are made by the JAX package and carried across with
``repro_torch.models.convert.params_from_numpy``.  The JAX side runs
without a mesh.  On a CPU tensor the port's attention wrapper runs its
plain version; the CUDA kernel is held to that version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: 2e-5 for float32 attention (summation order), 1e-4 for float32
models (two layers of it), 2e-2 for bfloat16 (bf16 rounds at other places
in the two frameworks), as atol = rtol.  A bf16 model's hidden states are
held to 2e-2 of their largest magnitude instead: one ulp of a residual
element of magnitude ~4 (0.016 to 0.03) passes through the next rms_norm
into elements of any size.

bf16 moe models: the router's gates of a token can tie or lie one bf16
rounding apart, so the two packages may route a token to different
experts.  The forward test records each layer's gates in both packages;
each token routed differently whose layer input no earlier rerouting
reached must be a near-tie (the reference's k-th and (k+1)-th gates less
than one bf16 ulp apart), and the hidden states are compared on the tokens
no rerouting reached (a reroute reaches its own token and, through causal
attention at later layers, the later tokens of its row).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
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
from repro.core.adaptive import AdaptiveShardingController as JaxController
from repro.kernels.flash_attention.ops import flash_attention as pallas_attn
from repro.kernels.flash_attention.ref import attention_ref
from repro.launch.serve import serve_loop as jax_serve_loop
from repro.launch.train import make_serve_step as jax_make_serve_step
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.adaptive import AdaptiveShardingController
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain,
                                                     flash_engine)
from repro_torch.launch.serve import serve_loop
from repro_torch.launch.train import make_serve_step
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol: float) -> None:
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _close_hidden(got, want, dtype: str, keep=None) -> None:
    """Hidden states (B, T, D) within the dtype's limits, on the (B, T)
    tokens ``keep`` selects (default all)."""
    g, w = _np(got), _np(want)
    if keep is not None:
        g, w = g[keep], w[keep]
    scale = max(1.0, float(np.abs(w).max())) if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(g, w, atol=TOL[dtype] * scale,
                               rtol=TOL[dtype])


def _spy_router_gates(monkeypatch) -> dict[str, list[np.ndarray]]:
    """Record every moe layer's router gates (B, T, E), in call order, in
    each package, each from its own input to ``moe_ffn`` (the reference's
    through ``jax.debug.callback`` inside its jitted scan)."""
    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    seen: dict[str, list[np.ndarray]] = {"jax": [], "torch": []}
    jax_ffn, torch_ffn = JM.moe_ffn, TM.moe_ffn

    def jax_spy(p, x, cfg, slot_map=None):
        g = jax.nn.softmax((x @ p["router"].astype(x.dtype))
                           .astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda v: seen["jax"].append(np.asarray(v)), g)
        return jax_ffn(p, x, cfg, slot_map)

    def torch_spy(p, x, cfg, slot_map=None):
        with torch.no_grad():
            seen["torch"].append(torch.softmax(
                (x @ p.router.to(x.dtype)).float(), dim=-1).numpy())
        return torch_ffn(p, x, cfg, slot_map)

    monkeypatch.setattr(JM, "moe_ffn", jax_spy)
    monkeypatch.setattr(TM, "moe_ffn", torch_spy)
    return seen


def _tokens_no_reroute_reached(seen, k: int, dtype: str) -> np.ndarray:
    """(B, T) mask of the tokens whose hidden state no rerouting reached;
    asserts the near-tie of every reroute whose input was clear."""
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    reached = np.zeros(seen["jax"][0].shape[:2], bool)
    for layer, (jg, tg) in enumerate(zip(seen["jax"], seen["torch"])):
        top = lambda g: np.sort(np.argsort(-g, -1, kind="stable")[..., :k],
                                -1)
        rerouted = (top(jg) != top(tg)).any(-1)
        # causal attention carries what reached a token to the later ones
        reached = np.logical_or.accumulate(reached, axis=1)
        for b, t in zip(*np.nonzero(rerouted & ~reached)):
            assert dtype == "bfloat16", (layer, b, t)  # float32 routes alike
            g = np.sort(jg[b, t])[::-1]
            ulp = 2.0 ** (np.floor(np.log2(g[k - 1])) - 7)
            assert g[k - 1] - g[k] < ulp, (layer, b, t, g)
        reached |= rerouted
    return ~reached


def _qkv(rng, b, t, s, h, kv, d, dtype):
    mk = lambda n, heads: rng.normal(size=(b, n, heads, d)).astype(np.float32)
    q, k, v = mk(t, h), mk(s, kv), mk(s, kv)
    jx = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    return jx, tx


def _cfg(arch: str, dtype: str):
    """The JAX and port smoke configs of ``arch`` in ``dtype``."""
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _models(arch: str, dtype: str, seed: int = 0):
    jcfg, tcfg = _cfg(arch, dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, jp, build_model(tcfg, device="cpu"), tp


# ------------------------------------------------- (a) the Pallas kernel
@pytest.mark.parametrize("t,s", [(128, 128), (256, 256), (128, 384)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_wrapper_matches_pallas_kernel(t, s, dtype, causal):
    """The shapes of tests/test_kernels.py, causal T != S included."""
    (jq, jk, jv), (q, k, v) = _qkv(np.random.default_rng(0), 2, t, s, 3, 3,
                                   64, dtype)
    want = pallas_attn(jq, jk, jv, causal=causal, interpret=True)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.parametrize("block_q,block_kv", [(64, 64), (128, 64), (64, 128)])
def test_attention_wrapper_matches_pallas_block_sweep(block_q, block_kv):
    (jq, jk, jv), (q, k, v) = _qkv(np.random.default_rng(1), 1, 256, 256, 2,
                                   2, 32, "float32")
    want = pallas_attn(jq, jk, jv, causal=True, block_q=block_q,
                       block_kv=block_kv, interpret=True)
    _close(flash_attention(q, k, v, causal=True), want, ATTN_TOL["float32"])


# --------------------------------------------------- (b) _blocked_attn
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset,s", [(True, 0, 200),
                                               (True, 37, 300),
                                               (True, 128, 328),
                                               (False, 0, 333)])
def test_attention_wrapper_matches_blocked_attn(dtype, causal, q_offset, s):
    """GQA (H=4, KV=2), T = 200 (no block multiple), q_offset > 0."""
    (jq, jk, jv), (q, k, v) = _qkv(np.random.default_rng(2), 2, 200, s, 4, 2,
                                   32, dtype)
    want = JA._blocked_attn(jq, jk, jv, causal, 0, 64, 128,
                            q_offset=q_offset)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    _close(got, want, ATTN_TOL[dtype])


# -------------------------------------------------- (g) causal alignment
def test_causal_alignment_is_top_left_like_the_kernel():
    """When T != S the port equals the Pallas kernel (top-left causal), not
    ``attention_ref`` (bottom-right), which the JAX package's own tests
    skip."""
    b, t, s, h, d = 1, 128, 384, 2, 64
    (jq, jk, jv), (q, k, v) = _qkv(np.random.default_rng(3), b, t, s, h, h,
                                   d, "float32")
    got = _np(flash_attention(q, k, v, causal=True))
    kernel = _np(pallas_attn(jq, jk, jv, causal=True, interpret=True))
    flat = lambda x: jnp.moveaxis(x, 2, 1).reshape(b * h, -1, d)
    ref = _np(jnp.moveaxis(attention_ref(flat(jq), flat(jk), flat(jv),
                                         causal=True)
                           .reshape(b, h, t, d), 1, 2))
    np.testing.assert_allclose(got, kernel, atol=2e-5, rtol=2e-5)
    assert np.abs(got - ref).max() > 0.5  # the oracle aligns differently
    # bottom-right alignment is the top-left mask shifted by S - T
    shifted = _np(flash_attention(q, k, v, causal=True, q_offset=s - t))
    np.testing.assert_allclose(shifted, ref, atol=2e-5, rtol=2e-5)


# ------------------------------------- (c) attention and decode_attention
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-4b",
                                  "qwen2-moe-a2.7b",
                                  "moonshot-v1-16b-a3b",
                                  "recurrentgemma-2b", "internvl2-2b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_and_decode_attention_match_jax(arch, dtype):
    jcfg, tcfg = _cfg(arch, dtype)
    jp = JA.init_attention(jax.random.key(4), jcfg)
    rng = np.random.default_rng(4)
    if jcfg.qkv_bias:  # the init sets biases to zero: give them values
        jp = {k: (jnp.asarray(rng.normal(size=v.shape), v.dtype)
                  if k.startswith("b") else v) for k, v in jp.items()}
    tp = TA.Attention(tcfg, {k: torch.from_numpy(np.array(v))
                             for k, v in jp.items()})
    x = rng.normal(size=(2, 70, jcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])
    with torch.inference_mode():
        _close(TA.attention(tp, tx, tcfg),
               jax.jit(JA.attention, static_argnums=2)(jp, jx, jcfg),
               TOL[dtype])
        jcache = JA.init_kv_cache(jcfg, 2, 16)
        tcache = TA.init_kv_cache(tcfg, 2, 16, device="cpu")
        jdecode = jax.jit(JA.decode_attention, static_argnums=4)
        for pos in range(5):
            xs = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
            jo, jcache = jdecode(
                jp, jnp.asarray(xs, JDT[dtype]), jcache, jnp.int32(pos), jcfg)
            to, tcache = TA.decode_attention(
                tp, torch.from_numpy(xs).to(TDT[dtype]), tcache, pos, tcfg)
            _close(to, jo, TOL[dtype])
        _close(tcache["k"], jcache["k"], TOL[dtype])
        _close(tcache["v"], jcache["v"], TOL[dtype])


# ------------------------------------------ (d) lm_forward and model.loss
# mamba2-130m runs here in float32 only: in bf16 the reference's own
# 2-layer smoke model lies 0.0723 from its float32 result at T = 150 (the
# limit is 0.0725), so two independent bf16 roundings of it part by more;
# tests/test_torch_recurrent.py holds its bf16 layers to the reference
# given the same input, and its bf16 loss, at this limit.
_FORWARD_CASES = [(dtype, arch) for dtype in ("float32", "bfloat16")
                  for arch in ("llama3-8b", "qwen1.5-4b", "qwen2-moe-a2.7b",
                               "moonshot-v1-16b-a3b", "mamba2-130m",
                               "recurrentgemma-2b", "internvl2-2b")
                  if (arch, dtype) != ("mamba2-130m", "bfloat16")]


@pytest.mark.parametrize("dtype,arch", _FORWARD_CASES)
def test_lm_forward_and_loss_match_jax(arch, dtype, monkeypatch):
    from repro.data.tokens import make_batch as jax_make_batch
    from repro_torch.data.tokens import make_batch

    jcfg, tcfg, jm, jp, tm, tp = _models(arch, dtype)
    jb = jax_make_batch(jcfg, 2, 150, 0)
    tb = make_batch(tcfg, 2, 150, 0, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(), np.asarray(jb["tokens"]))
    seen = _spy_router_gates(monkeypatch) if jcfg.moe is not None else None
    with torch.inference_mode():
        h = TT.lm_forward(tp, tb["tokens"], tcfg)
    # a fresh function, so that the trace holds the spy
    jh = jax.jit(lambda p, t: JT.lm_forward(p, t, jcfg))(jp, jb["tokens"])
    keep = None
    if seen is not None:
        jax.effects_barrier()
        assert len(seen["jax"]) == jcfg.n_layers
        keep = _tokens_no_reroute_reached(seen, jcfg.moe.top_k, dtype)
        assert keep.any()
        monkeypatch.undo()
    _close_hidden(h, jh, dtype, keep)
    loss = tm.loss(tp, tb)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    np.testing.assert_allclose(float(loss), float(jax.jit(jm.loss)(jp, jb)),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------- (e) lm_decode_step
def _cache_leaves(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """{path: array} of a decode cache (nested dicts and lists)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_cache_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: _np(tree)}


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-4b",
                                  "qwen2-moe-a2.7b",
                                  "moonshot-v1-16b-a3b", "mamba2-130m",
                                  "recurrentgemma-2b", "internvl2-2b"])
def test_decode_steps_match_jax(arch):
    """Greedy tokens equal and every cache leaf close over a few steps
    (float32, so that no near-tie of bf16 logits can flip an argmax)."""
    jcfg, tcfg, jm, jp, tm, tp = _models(arch, "float32", seed=5)
    jstep = jax.jit(jax_make_serve_step(jm))
    tstep = make_serve_step(tm)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (3, 1))
    jtok, ttok = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jcache, tcache = jm.init_cache(3, 12), tm.init_cache(3, 12)
    for pos in range(6):
        jn, jcache = jstep(jp, jcache, {"tokens": jtok, "pos": jnp.int32(pos)})
        tn, tcache = tstep(tp, tcache, {"tokens": ttok, "pos": pos})
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        jtok, ttok = jn[:, None], tn[:, None]
    got, want = _cache_leaves(tcache), _cache_leaves(jcache)
    assert got.keys() == want.keys()
    for path in want:
        _close(got[path], want[path], TOL["float32"])


# -------------------------------------------------------- (f) serve_loop
def test_serve_loop_matches_jax():
    """The same tokens reach the controller (its decayed heat counts are an
    order-sensitive record of every observed token) and the same
    ReplicationPlan comes out."""
    jcfg, tcfg, jm, jp, tm, tp = _models("llama3-8b", "float32")
    kw = dict(batch_size=2, max_len=16, steps=6, n_batches=3)
    jctrl = JaxController(jcfg.vocab_size, budget=16)
    tctrl = AdaptiveShardingController(tcfg.vocab_size, budget=16)
    jtimes, jplan = jax_serve_loop(jm, jp, controller=jctrl,
                                   rng=np.random.default_rng(6), **kw)
    ttimes, tplan = serve_loop(tm, tp, controller=tctrl,
                               rng=np.random.default_rng(6), **kw)
    assert len(ttimes) == len(jtimes) == 3
    np.testing.assert_array_equal(tctrl.heat.counts, jctrl.heat.counts)
    assert tplan.hot_ids == jplan.hot_ids and tplan.n_hot > 0
    assert tplan.coverage == jplan.coverage
    assert tplan.version == jplan.version


def test_controller_matches_jax():
    rng = np.random.default_rng(7)
    j, t = JaxController(300, budget=12), AdaptiveShardingController(300, 12)
    for _ in range(5):
        ids = rng.integers(0, 300, 64)
        j.observe(ids)
        t.observe(ids)
        tp, jp = t.replan(), j.replan()
        assert (tp.hot_ids, tp.coverage, tp.version) == \
            (jp.hot_ids, jp.coverage, jp.version)
        assert t.cold_capacity(64) == j.cold_capacity(64)


def test_tokens_and_configs_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jax_get_config
    from repro.data.tokens import synthetic_batches as jax_batches
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.data.tokens import synthetic_batches

    assert set(ARCH_IDS) == {"llama3-8b", "qwen1.5-4b", "yi-9b",
                             "codeqwen1.5-7b", "qwen2-moe-a2.7b",
                             "moonshot-v1-16b-a3b", "mamba2-130m",
                             "recurrentgemma-2b", "internvl2-2b",
                             "whisper-tiny"}
    for arch in ARCH_IDS:
        for get, jget in ((get_config, jax_get_config),
                          (get_smoke_config, jax_smoke_config)):
            mine, theirs = (dataclasses.asdict(get(arch)),
                            dataclasses.asdict(jget(arch)))
            # the other families' sub-configs are not ported: unset here
            assert all(theirs[k] is None for k in set(theirs) - set(mine))
            assert mine == {k: theirs[k] for k in mine}, arch
        assert get_config(arch).param_count() == \
            jax_get_config(arch).param_count()
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    cfg = get_smoke_config("qwen1.5-4b")
    for tb, jb in zip(synthetic_batches(cfg, 3, 17, 3, seed=2, device="cpu"),
                      jax_batches(jax_smoke_config("qwen1.5-4b"), 3, 17, 3,
                                  seed=2)):
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))


# ------------------------------------------------ (h) unported options
def test_unported_options_raise(capsys):
    from repro_torch.launch import serve
    from repro_torch.models import embedding as TE

    from repro.configs import ARCH_IDS as JAX_ARCH_IDS
    from repro_torch.configs import ARCH_IDS, LATER

    # every family is ported, the audio family last (12c)
    assert set(ARCH_IDS) == set(JAX_ARCH_IDS)
    assert LATER == {}
    audio = get_smoke_config("whisper-tiny")
    assert get_config("whisper-tiny").family == audio.family == "audio"
    assert build_model(audio, device="cpu").cfg is audio
    with pytest.raises(ValueError, match="unknown model family"):
        build_model(dataclasses.replace(audio, family="speech"),
                    device="cpu")
    cfg = get_smoke_config("llama3-8b")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    x = torch.zeros((1, 4, cfg.d_model))
    # windowed attention is ported: it runs, and a window past T changes
    # nothing
    with torch.inference_mode():
        assert torch.equal(TA.attention(params.blocks[0].attn, x, cfg,
                                        window=4),
                           TA.attention(params.blocks[0].attn, x, cfg))
    # cross-attention is ported: decoder states against encoder states of
    # another length, every key visible
    with torch.inference_mode():
        enc = torch.randn((1, 7, cfg.d_model))
        assert TA.cross_attention(params.blocks[0].attn, x, enc,
                                  cfg).shape == x.shape
    # the options of item 12d.1 run: the int8 cache builds, the bf16-math
    # decode runs, adaptive_embed without a mesh names the mesh, and the
    # serving CLI takes --int8-kv
    cache = TA.init_kv_cache(cfg, 1, 4, int8=True, device="cpu")
    assert cache["k"].dtype == cache["v"].dtype == torch.int8
    assert cache["k_scale"].shape == (1, 4, cfg.n_kv_heads)
    with torch.inference_mode():
        y, _ = TA.decode_attention(params.blocks[0].attn, x[:, :1], cache, 0,
                                   cfg)
        assert torch.isfinite(y).all() and cache["k_scale"][0, 0].gt(0).all()
        cache = TA.init_kv_cache(cfg, 1, 4, device="cpu")
        y, _ = TA.decode_attention(params.blocks[0].attn, x[:, :1], cache, 0,
                                   cfg, f32_cache_math=False)
        assert torch.isfinite(y).all()
    with pytest.raises(ValueError, match="mesh"):
        TE.adaptive_embed(params.embed, torch.zeros((1, 4), dtype=torch.long),
                          cfg, (), 8, None)
    import torch.distributed as dist

    assert not dist.is_initialized()
    serve.main(["--arch", "llama3-8b", "--smoke", "--int8-kv", "--device",
                "cpu", "--steps", "3", "--batches", "2"])
    assert "int8_kv=True" in capsys.readouterr().out
    assert not dist.is_initialized()  # main ends the group it started


def test_cuda_entry_points_without_a_card_raise(monkeypatch):
    from repro_torch.data.tokens import make_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)  # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        make_batch(cfg, 1, 4, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_lm_cache(cfg, 1, 4)


def test_flash_wrapper_checks_its_operands():
    q = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros((1, 4, 2, 16)), torch.zeros((1, 4, 2, 16)))
    with pytest.raises(ValueError, match="S == 0"):
        flash_attention(q, torch.zeros((1, 0, 3, 16)), torch.zeros((1, 0, 3, 16)))
    # on the CPU the wrapper is the plain version, differentiable
    q.requires_grad_(True)
    k = torch.randn((1, 5, 1, 16))
    flash_attention_plain(q, k, k).sum().backward()
    assert q.grad is not None


def _defining_sources(symbol: str) -> list[Path]:
    """The files of ``csrc/`` that define the ``extern "C"`` function
    ``symbol``."""
    from repro_torch.kernels import build

    pat = re.compile(r'extern "C"\s+\w+\s+' + symbol + r"\s*\(")
    return [p for p in sorted(build.CSRC.iterdir())
            if pat.search(p.read_text())]


def test_flash_engine_is_chosen_by_dtype():
    """A CUDA tensor's dtype names its kernel, with no fallback: bf16 the
    tensor-core kernel, float32 the CUDA-core one, anything else raises.
    The backward runs on its forward's engine: the bf16 forward and
    backward are defined in sources built on the Hopper header (wgmma,
    TMA), the float32 ones in sources without it."""
    from repro_torch.kernels.flash_attention import ops as FA

    assert flash_engine(torch.bfloat16) == "wgmma"
    assert flash_engine(torch.float32) == "cuda-core"
    for dtype in (torch.float16, torch.float64, torch.int32):
        with pytest.raises(TypeError, match="no kernel"):
            flash_engine(dtype)
    assert set(FA._BWD) == set(FA._ENGINES)
    assert len(set(FA._BWD.values())) == len(FA._BWD)
    for dtype, (engine, fwd) in FA._ENGINES.items():
        for symbol in (fwd, FA._BWD[dtype]):
            (src,) = _defining_sources(symbol)
            hopper = '#include "sm90.cuh"' in src.read_text()
            assert hopper == (engine == "wgmma"), (dtype, symbol, src.name)


def test_bound_kernel_symbols_are_defined_once_in_the_build():
    """Each ``extern "C"`` symbol a wrapper binds (the flash_attention
    forward and backward by dtype, the four DSJ kernels) is defined in
    exactly one source that ``build.SOURCES`` compiles, and every file of
    ``csrc/`` is a source or a header the build hashes, so an edited
    header gives a new library, not a stale cached one."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.relalg_ops import bucket, compact, expand
    from repro_torch.kernels.semijoin import probe

    bound = set()
    for mod in (FA, probe, expand, bucket, compact):
        bound |= set(re.findall(r"adhash_[a-z0-9_]+",
                                Path(mod.__file__).read_text()))
    flash = {sym for _, sym in FA._ENGINES.values()} | set(FA._BWD.values())
    assert flash <= bound
    for name in ("range_search", "expand", "bucket_by_dest",
                 "unique_compact"):
        assert any(name in sym for sym in bound), name
    for symbol in sorted(bound):
        srcs = _defining_sources(symbol)
        assert len(srcs) == 1 and srcs[0].name in build.SOURCES, \
            (symbol, [p.name for p in srcs])
    files = {p.name for p in build.CSRC.iterdir()
             if p.suffix in (".cu", ".cuh")}
    assert files == set(build.SOURCES) | set(build._HEADERS)
    assert len(build.SOURCES) == len(set(build.SOURCES))


# -------------------------------------------- (i) the port imports no jax
def test_lm_serving_imports_neither_jax_nor_repro():
    """The serving CLI runs end to end on the CPU in a fresh interpreter
    without pulling in jax or the JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--arch', 'qwen1.5-4b', '--smoke', '--device', 'cpu',"
        " '--steps', '3', '--batches', '2'])\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "arch=qwen1.5-4b device=cpu" in out.stdout
    assert "controller: hot=" in out.stdout
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert all(n.split(".")[0] not in ("jax", "jaxlib", "repro")
                           for n in names), (path, names)


# ------------------------------- (j) the cache options (ROADMAP 12d.1)
def test_runtime_options_default_is_baseline():
    """The reference's test on the port: no options, ``opts=None`` and
    the default ``RuntimeOptions()`` give the same loss bit for bit; the
    fields and defaults are the reference's; and the loss is the
    reference's within the bf16 limit."""
    fields = lambda cls: [(f.name, f.default) for f in
                          dataclasses.fields(cls)]
    assert fields(TT.RuntimeOptions) == fields(JT.RuntimeOptions)
    jcfg, tcfg, jm, jp, tm, tp = _models("yi-9b", "bfloat16")
    zeros = np.zeros((2, 8), np.int32)
    batch = {"tokens": torch.from_numpy(zeros), "labels":
             torch.from_numpy(zeros)}
    with torch.inference_mode():
        losses = [float(m.loss(tp, batch)) for m in (
            tm, build_model(tcfg, opts=None, device="cpu"),
            build_model(tcfg, opts=TT.RuntimeOptions(), device="cpu"))]
    assert losses[0] == losses[1] == losses[2]
    want = float(jax.jit(jm.loss)(jp, {"tokens": jnp.asarray(zeros),
                                       "labels": jnp.asarray(zeros)}))
    np.testing.assert_allclose(losses[0], want, rtol=TOL["bfloat16"])


def test_int8_kv_cache_decode_close_to_bf16():
    """The reference's test on the port: 5 decode steps with the int8
    cache and bf16 cache math against the default cache, fed the default
    path's greedy tokens: logits within 5% of the largest, greedy tokens
    agreeing on at least half the rows."""
    cfg = get_smoke_config("llama3-8b")
    base = build_model(cfg, device="cpu")
    opt = build_model(cfg, opts=TT.RuntimeOptions(kv_cache_int8=True,
                                                  bf16_cache_math=True),
                      device="cpu")
    params = base.init(0)
    b = 2
    c0, c1 = base.init_cache(b, 32), opt.init_cache(b, 32)
    assert c1["kv"]["k"].dtype == torch.int8 and "k_scale" in c1["kv"]
    tok = torch.zeros((b, 1), dtype=torch.long)
    for pos in range(5):
        batch = {"tokens": tok, "pos": pos}
        l0, c0 = base.decode(params, c0, batch)
        l1, c1 = opt.decode(params, c1, batch)
        tok = torch.argmax(l0[:, -1], -1)[:, None]
    l0, l1 = l0.float(), l1.float()
    rel = float((l0 - l1).abs().max() / l0.abs().max())
    assert rel < 0.05, rel
    agree = (torch.argmax(l0[:, -1], -1) == torch.argmax(l1[:, -1], -1))
    assert float(agree.float().mean()) >= 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax(dtype):
    """Payload and scales bit for bit, over seeded rows of magnitudes
    1e-2 to 1e2, all-zero rows (scale 1e-8) and rows of exact multiples
    of a scale up to +-127 (and halves between them: round half to
    even)."""
    rng = np.random.default_rng(11)
    quant = jax.jit(JA._quantize_kv)
    for _ in range(10):
        x = (rng.normal(size=(6, 1, 4, 16)) *
             rng.uniform(1e-2, 1e2, size=(6, 1, 4, 1))).astype(np.float32)
        x[0, 0, 1] = 0.0
        s = np.float32(rng.uniform(0.01, 1.0))
        x[1, 0] = rng.integers(-127, 128, (4, 16)).astype(np.float32) * s
        x[1, 0, :, 0] = 127 * s
        x[2, 0, 2] = (np.arange(16) - 7.5).astype(np.float32) * 16
        x[2, 0, 3] = -x[2, 0, 2]
        jq, js = quant(jnp.asarray(x, JDT[dtype]))
        tq, ts = TA._quantize_kv(torch.from_numpy(x).to(TDT[dtype]))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


_MODES = {"int8": dict(kv_cache_int8=True),
          "bf16_math": dict(bf16_cache_math=True),
          "int8_bf16_math": dict(kv_cache_int8=True, bf16_cache_math=True)}


def _seeded_cache(rng, cache: dict, filled: int) -> dict:
    """A numpy decode cache of the same leaves, its first ``filled``
    positions seeded (int8 payloads, positive scales, normal K/V)."""
    out = {}
    for name, t in cache["kv"].items():
        a = np.zeros(t.shape, np.int8 if t.dtype == torch.int8
                     else np.float32)
        part = a[:, :, :filled]
        if name.endswith("_scale"):
            part[...] = rng.uniform(1e-3, 5e-2, part.shape)
        elif a.dtype == np.int8:
            part[...] = rng.integers(-127, 128, part.shape)
        else:
            part[...] = rng.normal(size=part.shape)
        out[name] = a
    return {"kv": out}


@pytest.mark.parametrize("arch,mode,dtype", [
    ("llama3-8b", "int8", "float32"),
    ("llama3-8b", "int8_bf16_math", "bfloat16"),
    ("llama3-8b", "bf16_math", "bfloat16"),
    ("llama3-8b", "bf16_math", "float32"),
    ("qwen2-moe-a2.7b", "int8", "float32"),
    ("qwen2-moe-a2.7b", "bf16_math", "bfloat16"),
])
def test_cache_mode_decode_steps_match_jax(arch, mode, dtype):
    """4 decode steps from the same seeded cache (6 positions filled, 16
    slots) in both packages, on converted weights, fed the same seeded
    tokens: logits each step within the dtype's limit of their largest
    magnitude, then every cache leaf: float leaves and the dequantized
    int8 K/V (payload x scale) within it; in float32 the payloads also
    within one step where the K/V quantized differ by rounding, bit for
    bit in at least 99% of entries (in bf16 one ulp of a K/V element moves
    its payload by up to 127 / 256 per unit of its row's largest)."""
    from repro_torch.models.convert import cache_from_numpy, cache_to_numpy

    jcfg, tcfg = _cfg(arch, dtype)
    jm = jax_build_model(jcfg, opts=JT.RuntimeOptions(**_MODES[mode]))
    jp = jax_build_model(jcfg).init(jax.random.key(12))
    tm = build_model(tcfg, opts=TT.RuntimeOptions(**_MODES[mode]),
                     device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(12)
    seeded = _seeded_cache(rng, tm.init_cache(2, 16), 6)
    tcache = cache_from_numpy(seeded, "cpu")
    if dtype == "bfloat16" and "int8" not in mode:
        tcache = {"kv": {k: v.bfloat16() for k, v in tcache["kv"].items()}}
    want_dtypes = {k: v.dtype for k, v in jm.init_cache(2, 16)["kv"].items()}
    jcache = {"kv": {k: jnp.asarray(v, want_dtypes[k])
                     for k, v in seeded["kv"].items()}}
    jstep = jax.jit(jm.decode)
    for pos in range(6, 10):
        toks = rng.integers(0, jcfg.vocab_size, (2, 1))
        jl, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(toks, jnp.int32),
                                        "pos": jnp.int32(pos)})
        tl, tcache = tm.decode(tp, tcache, {"tokens": torch.from_numpy(toks),
                                            "pos": pos})
        _close_hidden(tl, jl, dtype)
    got = cache_to_numpy(tcache)["kv"]
    want = jax.tree.map(np.asarray, jcache)["kv"]
    for name in want:
        if want[name].dtype == np.int8:
            assert got[name].dtype == np.int8
            # dequantized, each by its own scales
            deq = lambda c: c[name] * c[name + "_scale"][..., None]
            _close_hidden(deq(got), deq(want), dtype)
            if dtype == "float32":
                diff = np.abs(got[name].astype(int) - want[name].astype(int))
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.99, name
        else:
            _close_hidden(got[name], want[name].astype(np.float32), dtype)
