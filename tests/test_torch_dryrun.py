"""The port's dry-run (``repro_torch.launch.dryrun``), ``ModelAPI.
input_specs`` and ``configs.applicable_shapes`` against the JAX package's.

The dry-run's cells run in one subprocess (it joins torch's fake process
group as rank 0 of 256 and then 512 ranks; the test process keeps no
group): qwen2-moe-a2.7b ``train_4k`` and llama3-8b ``decode_32k`` at the
reference's ``_override_depth(cfg, 2)`` on each production mesh, and the
CLI on whisper-tiny's ``decode_32k`` cell (resumed on a second run).
Their records carry the reference's keys, and ``memory.argument_bytes``
equals a per-rank sum worked out here from the reference's own
``param_specs`` over ``jax.eval_shape(model.init)``, the mesh sizes, the
batch specs and, for train, the AdamW moments and step: a leaf the spec
cuts counts 1/16 (the model axis) except the leaves the port keeps whole
(``launch.shardings``' docstring: llama3-8b's ``wk`` and ``wv``, whose 8
KV heads do not split over 16; the LM head ``embed/out`` is cut, its
logits vocab-parallel), exact to the byte.  ``input_specs`` and ``applicable_shapes`` equal the reference's for
every arch (no compile).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in production)
import jax

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as jax_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.launch.dryrun import _override_depth as jax_override_depth
from repro.launch.mesh import batch_axes as jax_batch_axes
from repro.launch.shardings import param_specs as jax_param_specs
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro_torch.launch.dryrun import collective_bytes
from repro_torch.models.model_zoo import build_model

ROOT = Path(__file__).resolve().parents[1]
CELLS = (("qwen2-moe-a2.7b", "train_4k"), ("llama3-8b", "decode_32k"))
#: leaves the port keeps whole although the spec cuts them, per cell
WHOLE = {"qwen2-moe-a2.7b": set(),
         "llama3-8b": {"blocks/attn/wk", "blocks/attn/wv"}}
REF_KEYS = {"arch", "shape", "mesh", "multi_pod", "kind", "adaptive",
            "optimized", "model_params", "model_params_active", "lower_s",
            "compile_s", "memory", "cost", "collectives", "hlo_lines", "ok",
            "total_s"}

_CHILD = textwrap.dedent(
    r'''
    import sys
    from pathlib import Path

    import torch.distributed as dist

    from repro_torch.launch import dryrun as D

    assert "jax" not in sys.modules and "repro" not in sys.modules
    out = Path(sys.argv[1])
    for multi_pod in (False, True):
        mesh = D.init_fake_world(multi_pod)
        for arch, shape in (("qwen2-moe-a2.7b", "train_4k"),
                            ("llama3-8b", "decode_32k")):
            rec = D.run_cell(arch, shape, mesh, multi_pod, out / "cells",
                             depth_override=2)
            assert rec["ok"], rec.get("traceback")
    dist.destroy_process_group()
    for _ in range(2):  # the second run resumes from the record
        assert D.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                       "--out", str(out / "cli")]) == 0
    assert not sys.modules["torch"].cuda.is_initialized()
    print("OK")
    '''
)


@pytest.fixture(scope="module")
def records(tmp_path_factory) -> tuple[Path, subprocess.CompletedProcess]:
    out = tmp_path_factory.mktemp("dryrun")
    env = {**os.environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": str(ROOT / "src") + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    run = subprocess.run([sys.executable, "-c", _CHILD, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert "OK" in run.stdout, run.stderr[-3000:]
    return out, run


def _stand_in(shape: dict) -> types.SimpleNamespace:
    """A mesh with the reference's ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _argument_bytes(arch: str, shape_name: str, multi_pod: bool) -> int:
    """The rank's argument bytes from the reference's specs."""
    cfg = jax_override_depth(jax_get_config(arch), 2)
    shape = JSHAPES[shape_name]
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod else
             {"data": 16, "model": 16})
    mesh = _stand_in(sizes)
    model = jax_build_model(cfg)
    pshapes = jax.eval_shape(model.init, jax.random.key(0))
    specs = dict(_leaves(jax_param_specs(pshapes, mesh)))
    total = 0
    for path, leaf in _leaves(pshapes):
        n = int(np.prod(leaf.shape))
        if any(a == "model" for a in specs[path]) and \
                path not in WHOLE[arch]:
            n //= sizes["model"]
        total += n * leaf.dtype.itemsize
        if shape.kind == "train":  # its two float32 moments
            total += 2 * n * 4
    if shape.kind == "train":
        total += 4  # the step counter
    blocks = int(np.prod([sizes[a] for a in
                          jax_batch_axes(mesh, shape.global_batch)]))
    for name, sds in model.input_specs(shape).items():
        n = int(np.prod(sds.shape)) * sds.dtype.itemsize
        total += n // blocks if sds.shape else n
    return total


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_cell_record(records, arch, shape, multi_pod):
    """A depth-2 cell on the 256 (512) rank fake mesh writes the
    reference's record keys, ok, with FLOPs and collectives counted, and
    argument_bytes equal to the spec-derived per-rank sum, exactly."""
    out, _ = records
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}__D2"
    rec = json.loads((out / "cells" / f"{tag}.json").read_text())
    assert set(rec) == REF_KEYS, set(rec) ^ REF_KEYS
    assert rec["ok"] and rec["kind"] == JSHAPES[shape].kind
    assert rec["mesh"] == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                           else {"data": 16, "model": 16})
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes_accessed", "transcendentals"}
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"bytes_by_kind", "ops_by_kind", "total_bytes"}
    assert coll["ops_by_kind"]["all-reduce"] > 0
    assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())
    cfg = jax_override_depth(jax_get_config(arch), 2)
    assert rec["model_params"] == cfg.param_count()
    assert rec["model_params_active"] == cfg.active_param_count()
    assert rec["memory"]["argument_bytes"] == _argument_bytes(arch, shape,
                                                              multi_pod)


def test_dryrun_cli_writes_and_resumes(records):
    """The CLI's cell record has the reference's keys and tag, and a
    second run reads it back instead of running the cell."""
    out, run = records
    rec = json.loads((out / "cli" / "whisper-tiny__decode_32k__pod1.json")
                     .read_text())
    assert set(rec) == REF_KEYS and rec["ok"]
    assert run.stdout.count("[ok] whisper-tiny__decode_32k__pod1") == 1
    assert run.stdout.count("dry-run complete; failures: 0") == 2


def test_collective_bytes_of_a_trace():
    """Bytes and ops summed by kind, as the reference's parse of HLO."""
    trace = [("all-reduce", 1024), ("all-gather", 4096), ("all-reduce", 8),
             ("reduce-scatter", 256)]
    assert collective_bytes(trace) == {
        "bytes_by_kind": {"all-reduce": 1032, "all-gather": 4096,
                          "reduce-scatter": 256},
        "ops_by_kind": {"all-reduce": 2, "all-gather": 1,
                        "reduce-scatter": 1},
        "total_bytes": 5384}
    assert collective_bytes([]) == {"bytes_by_kind": {}, "ops_by_kind": {},
                                    "total_bytes": 0}


def test_applicable_shapes_match_jax():
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        assert applicable_shapes(arch) == jax_applicable_shapes(arch), arch


_JAX_DTYPES = {"int32": torch.int32, "float32": torch.float32,
               "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every applicable shape's input names, shapes and dtypes equal the
    reference's ``ShapeDtypeStruct``s."""
    jm = jax_build_model(jax_get_config(arch))
    tm = build_model(get_config(arch), device="cpu")
    for name in applicable_shapes(arch):
        want = jm.input_specs(JSHAPES[name])
        got = tm.input_specs(SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for k, sds in want.items():
            shape, dtype = got[k]
            assert tuple(shape) == tuple(sds.shape), (arch, name, k)
            assert dtype == _JAX_DTYPES[np.dtype(sds.dtype).name], \
                (arch, name, k, dtype, sds.dtype)


def test_param_specs_build_no_storage():
    """``ModelAPI.param_specs`` builds the parameters as fake tensors (no
    storage) with the shapes ``init`` gives."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config("qwen2-moe-a2.7b")
    model = build_model(cfg, device="cpu")
    fake = model.param_specs()
    real = model.init(0)
    got = dict(fake.named_parameters())
    for name, p in real.named_parameters():
        assert isinstance(got[name], FakeTensor), name
        assert got[name].shape == p.shape and got[name].dtype == p.dtype
