"""The port's vlm family (internvl2-2b: a projector before a GQA decoder)
against the JAX package, on the CPU, at the smoke size.

Inputs are made from a seed with numpy (the batch's patches by each
package's ``make_batch``) and fed to both packages; weights are made by the
JAX package and carried across with
``repro_torch.models.convert.params_from_numpy``.  On CPU tensors the
attention wrapper runs its plain version; the CUDA kernels are held to it
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are those of ``tests/test_torch_lm.py``: 1e-4 in float32, 2e-2
in bfloat16 (of the largest magnitude for hidden states), as atol = rtol;
batches and weights bit-exact.
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
from repro.models import transformer as JT
from repro.models import vlm as JV
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import make_batch
from repro_torch.models import transformer as TT
from repro_torch.models import vlm as TV
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model_zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internvl2-2b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _models(dtype: str = "float32", seed: int = 0):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jm, jp, build_model(tcfg, device="cpu"), tp


def test_make_batch_patches_are_bit_exact():
    """Tokens, labels and the patches drawn after them from one generator
    equal the reference's bit for bit, for several steps and seeds."""
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    for seed, step in ((0, 0), (0, 3), (5, 1)):
        tb = make_batch(cfg, 3, 21, step, seed, device="cpu")
        jb = jax_make_batch(jcfg, 3, 21, step, seed)
        assert set(tb) == set(jb) == {"tokens", "labels", "patches"}
        assert tb["patches"].dtype == torch.float32
        assert tb["patches"].shape == (3, cfg.vlm.n_patches,
                                       cfg.vlm.d_vision)
        for name in tb:
            np.testing.assert_array_equal(tb[name].numpy(),
                                          np.asarray(jb[name]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_forward_and_loss_match_jax(dtype):
    """The projected patches, the hidden states over patches and text
    (``inputs_embeds``), and ``vlm_loss`` over the text positions only."""
    jcfg, tcfg, jm, jp, tm, tp = _models(dtype)
    jb = jax_make_batch(jcfg, 2, 30, 0)
    tb = make_batch(tcfg, 2, 30, 0, device="cpu")
    with torch.inference_mode():
        vis = TV._project(tp, tb["patches"], tcfg)
        h = TT.lm_forward(tp, tb["tokens"], tcfg, inputs_embeds=vis)
        loss = tm.loss(tp, tb)
    jvis = JV._project(jp, jb["patches"], jcfg)
    jh = jax.jit(lambda p, t, e: JT.lm_forward(p, t, jcfg, inputs_embeds=e))(
        jp, jb["tokens"], jvis)
    assert h.shape == (2, jcfg.vlm.n_patches + 30, jcfg.d_model)
    np.testing.assert_allclose(_np(vis), _np(jvis), atol=TOL[dtype],
                               rtol=TOL[dtype])
    scale = max(1.0, float(np.abs(_np(jh)).max())) if dtype == "bfloat16" \
        else 1.0
    np.testing.assert_allclose(_np(h), _np(jh), atol=TOL[dtype] * scale,
                               rtol=TOL[dtype])
    jloss = float(jax.jit(jm.loss)(jp, jb))
    np.testing.assert_allclose(float(loss), jloss, atol=TOL[dtype],
                               rtol=TOL[dtype])
    # the patches count only as context: labels on them would change it
    with torch.inference_mode():
        text_only = TT.lm_loss(tp, tb["tokens"], tb["labels"], tcfg,
                               inputs_embeds=vis)
    assert float(text_only) == float(loss)


def test_vlm_decode_is_text_only_and_matches_jax():
    """``vlm_decode_step`` over a KV cache, greedy tokens equal and the
    cache close (float32)."""
    jcfg, tcfg, jm, jp, tm, tp = _models(seed=2)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 1))
    jtok, ttok = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    jcache = JV.init_vlm_cache(jcfg, 2, 10)
    tcache = TV.init_vlm_cache(tcfg, 2, 10, device="cpu")
    jstep = jax.jit(JV.vlm_decode_step, static_argnums=4)
    for pos in range(5):
        jl, jcache = jstep(jp, jcache, jtok, jnp.int32(pos), jcfg)
        with torch.inference_mode():
            tl, tcache = TV.vlm_decode_step(tp, tcache, ttok, pos, tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL["float32"],
                                   rtol=TOL["float32"])
        ttok = torch.argmax(tl[:, -1], -1)[:, None]
        jtok = jnp.asarray(ttok.numpy(), jnp.int32)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["kv"][name]),
                                   _np(jcache["kv"][name]),
                                   atol=TOL["float32"], rtol=TOL["float32"])


def test_vlm_params_round_trip_and_configs():
    """The reference's tree (projector included) -> the port -> the tree,
    bit for bit; the configs and param counts equal."""
    jcfg, tcfg, jm, jp, tm, tp = _models()
    want = jax.tree.map(np.asarray, jp)
    got = params_to_numpy(tp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert tuple(tp.projector.w.shape) == (jcfg.vlm.d_vision, jcfg.d_model)
    fresh = tm.init(1)
    assert [n for n, _ in fresh.named_parameters()][-2:] == \
        ["projector.w", "projector.b"]
    again = params_from_numpy(params_to_numpy(fresh), tcfg, "cpu")
    for a, b in zip(again.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    for get, jget in ((get_config, jax_get_config),
                      (get_smoke_config, jax_smoke_config)):
        mine, theirs = (dataclasses.asdict(get(ARCH)),
                        dataclasses.asdict(jget(ARCH)))
        assert all(theirs[k] is None for k in set(theirs) - set(mine))
        assert mine == {k: theirs[k] for k in mine}
    assert get_config(ARCH).param_count() == \
        jax_get_config(ARCH).param_count()


def test_vlm_clis_run_without_jax():
    """``python -m repro_torch.launch.train --arch internvl2-2b --smoke
    --device cpu`` and the serve CLI, in a fresh interpreter that never
    imports jax or the JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve, train\n"
        f"train.main(['--arch', {ARCH!r}, '--smoke', '--steps', '2',"
        " '--batch', '2', '--seq', '24', '--device', 'cpu'])\n"
        f"serve.main(['--arch', {ARCH!r}, '--smoke', '--device', 'cpu',"
        " '--steps', '3', '--batches', '2'])\n"
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
    assert out.stdout.count(f"arch={ARCH} device=cpu") == 2
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
