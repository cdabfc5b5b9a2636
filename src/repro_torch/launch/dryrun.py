"""Multi-pod dry-run: the per-rank cost of every (architecture x input
shape x mesh) cell, without a device.

The port's counterpart of ``repro.launch.dryrun``.  The reference lowers
and compiles each cell's jitted step on 256 (512) forced host devices and
reads XLA's analyses.  The port has no compiler to ask, so it runs one
rank's step for real, on nothing: one process joins torch's fake process
group (``torch.testing._internal.distributed.fake_pg.FakeStore``, backend
``"fake"``: collectives return at once and move no data; an internal API
of torch's own tests, which may change between releases) as rank 0 of a
world of 256 (512 with ``--multi-pod``), builds the production mesh
(``make_production_mesh``: (16, 16) as (data, model), (2, 16, 16) as
(pod, data, model)), and runs the step under ``FakeTensorMode`` (every
tensor a shape and a dtype, no storage) and ``FlopCounterMode``.  For
each cell it

  1. builds the model's parameters as fake tensors
     (``ModelAPI.param_specs``) and places them
     (``launch.shardings.place``: this rank's slices of the cut leaves);
  2. runs the cell's step on this rank's block of the batch
     (``batch_specs``): train is ``make_train_step`` over the mesh (the
     loss, its backward, the gradients' all-reduce over the data axes,
     AdamW), prefill the loss without a backward, decode one
     ``make_serve_step`` from a zero cache of this rank's batch;
  3. records the bytes of the rank's arguments and outputs, the FLOPs, and
     every collective the rank issued (``models.collectives.
     trace_collectives``, summed by ``collective_bytes``: the counterpart
     of the reference's parse of the optimized HLO);
  4. writes one JSON record per cell under ``--out``, with the
     reference's keys, and skips a cell whose record exists (resume).

The record's fields without a counterpart here are null: ``compile_s``
and ``hlo_lines`` (nothing is compiled), ``memory.temp_bytes`` and
``memory.generated_code_bytes`` (an eager step has no compiled buffer
plan or code), ``cost.bytes_accessed`` and ``cost.transcendentals``
(``FlopCounterMode`` counts only the products' FLOPs).  ``lower_s`` is the
seconds of the fake step.  ``memory.argument_bytes`` is the rank's placed
parameters, optimizer state (train: the moments and the step) and batch
block; ``output_bytes`` the tensors the step returns (train: the
parameters and optimizer state it updates in place; decode: the next
tokens and the cache).  It runs on the CPU only and never touches a GPU.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
          [--shape S] [--multi-pod] [--both-meshes] [--optimized]
          [--out artifacts/dryrun]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config

__all__ = ["collective_bytes", "init_fake_world", "run_cell", "main"]


def collective_bytes(events) -> dict:
    """Sum the result bytes of a trace's collectives, by kind:
    (kind, bytes) pairs as ``trace_collectives`` records them."""
    per_kind: dict[str, int] = {}
    n_ops: dict[str, int] = {}
    for kind, nbytes in events:
        per_kind[kind] = per_kind.get(kind, 0) + int(nbytes)
        n_ops[kind] = n_ops.get(kind, 0) + 1
    return {"bytes_by_kind": per_kind, "ops_by_kind": n_ops,
            "total_bytes": sum(per_kind.values())}


def _override_depth(cfg, n: int):
    """Reduced-depth variants, as the reference's: the hybrid family counts
    groups of 3 (+2 tail), audio shrinks its encoder too."""
    if cfg.family == "hybrid":
        return replace(cfg, n_layers=3 * n + 2, scan_unroll=True)
    if cfg.family == "audio":
        return replace(cfg, n_layers=n, scan_unroll=True,
                       encdec=replace(cfg.encdec, n_enc_layers=n))
    return replace(cfg, n_layers=n, scan_unroll=True)


def _make_opts(cfg, mesh):
    """The optimized configuration for this arch, as the reference's."""
    from repro_torch.models.moe import slot_map_for_plan
    from repro_torch.models.transformer import RuntimeOptions

    ac = cfg.adaptive
    hot = tuple(range(ac.embedding_hot_budget)) if ac else ()
    slot_map = None
    if cfg.moe is not None and ac and ac.expert_replication:
        slot_map = slot_map_for_plan(cfg.moe.n_experts,
                                     tuple(range(ac.expert_replication)))
    return RuntimeOptions(
        mesh=mesh, sharded_moe=cfg.moe is not None,
        adaptive_embedding=bool(ac and ac.embedding_hot_budget),
        hot_ids=hot, cold_frac=ac.embedding_cold_frac if ac else 1.0,
        bf16_cache_math=True, kv_cache_int8=True, slot_map=slot_map)


def init_fake_world(multi_pod: bool):
    """Rank 0 of a fake world of 256 (512) ranks and its production mesh;
    a group this process already holds is left first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from .mesh import make_production_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    return make_production_mesh(multi_pod=multi_pod, device="cpu")


def _nbytes(tensors) -> int:
    """Bytes of distinct tensors (each storage once)."""
    seen, total = set(), 0
    for t in tensors:
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _run_step(model, cfg, shape, mesh, params, record: dict) -> None:
    """Run the cell's step on this rank and fill the record's memory,
    cost and collectives."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models.collectives import (data_parallel,
                                                trace_collectives)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    from .shardings import batch_specs
    from .train import local_batch, make_serve_step, make_train_step

    whole = {name: torch.zeros(s, dtype=dt)
             for name, (s, dt) in model.input_specs(shape).items()}
    inputs = {k: v for k, v in whole.items() if k != "pos"}
    batch, axes = local_batch(model, inputs, mesh)
    if "pos" in whole:
        assert batch_specs(cfg, mesh, shape, "decode")["pos"] == ()
    args = list(params.parameters()) + _tensors(batch)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, \
            trace_collectives() as events:
        if shape.kind == "train":
            opt = adamw_init(params)
            args += _tensors(opt)
            step = make_train_step(model, AdamWConfig(), mesh)
            params, opt, metrics = step(params, opt, whole)
            outputs = (list(params.parameters()) + _tensors(opt) +
                       _tensors(metrics))
        elif shape.kind == "prefill":
            with torch.no_grad(), data_parallel(mesh, axes):
                outputs = [model.loss(params, batch)]
        else:
            cache = model.init_cache(batch["tokens"].shape[0], shape.seq_len,
                                     params)
            batch["pos"] = shape.seq_len - 1  # a Python int: no fake read
            with data_parallel(mesh, axes):
                nxt, cache = make_serve_step(model)(params, cache, batch)
            outputs = [nxt] + _tensors(cache)
            args += [torch.zeros((), dtype=torch.int32)]  # pos
    record["lower_s"] = time.perf_counter() - t0
    record["compile_s"] = None
    record["memory"] = {"argument_bytes": _nbytes(args),
                        "output_bytes": _nbytes(outputs),
                        "temp_bytes": None, "generated_code_bytes": None}
    record["cost"] = {"flops": float(flops.get_total_flops()),
                      "bytes_accessed": None, "transcendentals": None}
    record["collectives"] = collective_bytes(events)
    record["hlo_lines"] = None


def run_cell(arch: str, shape_name: str, mesh, multi_pod: bool,
             out_dir: Path, adaptive: bool = False,
             depth_override: int | None = None,
             optimized: bool = False) -> dict:
    from repro_torch.models.model_zoo import build_model

    from .shardings import param_specs, place

    cfg = get_config(arch)
    if depth_override is not None:
        cfg = _override_depth(cfg, depth_override)
    shape = SHAPES[shape_name]
    if optimized:
        cfg = replace(cfg, remat_policy="dots")
    opts = _make_opts(cfg, mesh) if optimized else None
    model = build_model(cfg, opts=opts, device="cpu")
    tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    if adaptive:
        tag += "__adaptive"
    if depth_override is not None:
        tag += f"__D{depth_override}"
    if optimized:
        tag += "__opt"
    out_path = out_dir / f"{tag}.json"
    if out_path.exists():
        return json.loads(out_path.read_text())

    t0 = time.perf_counter()
    record: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "multi_pod": multi_pod, "kind": shape.kind, "adaptive": adaptive,
        "optimized": optimized, "model_params": cfg.param_count(),
        "model_params_active": cfg.active_param_count(),
    }
    try:
        params = model.param_specs()
        with params.fake_mode:
            place(params, mesh, param_specs(params, mesh))
            _run_step(model, cfg, shape, mesh, params, record)
        record["ok"] = True
    except Exception as e:  # record failures: they are bugs to fix
        record["ok"] = False
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["total_s"] = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    status = "ok" if record.get("ok") else "FAIL"
    print(f"[{status}] {tag}  ({record['total_s']:.1f}s)", flush=True)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    out_dir = Path(args.out)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    try:
        for multi_pod in meshes:
            mesh = init_fake_world(multi_pod)
            for arch in archs:
                shapes = ([args.shape] if args.shape else
                          applicable_shapes(arch))
                for shape_name in shapes:
                    rec = run_cell(arch, shape_name, mesh, multi_pod,
                                   out_dir, optimized=args.optimized)
                    n_fail += 0 if rec.get("ok") else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"dry-run complete; failures: {n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
