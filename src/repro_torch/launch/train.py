"""Step builders of the LM side and the training CLI.

The port's counterpart of ``repro.launch.train``.  ``make_train_step``
returns a (params, opt, batch) -> (params, opt, metrics) function: the loss,
its backward (through the hand-written attention backward on the card),
then ``adamw_update``, which updates the parameters and moments in place;
the gradients are dropped before it returns.  ``make_serve_step`` is the
decode step that ``serve_loop`` drives.

With a mesh (``launch.mesh``; the params placed by ``launch.shardings.
place``) the step is the reference's sharded step: each rank takes its
block of the global batch by ``batch_specs`` (split over the data axes
that divide it, ``pod`` and ``data``), runs its forward and backward in a
data-parallel region (``models.collectives.data_parallel``: the loss's
count and the MoE dispatch are the global batch's, the layers cut over
``model`` run tensor-parallel), and sums the gradients over those axes
with one flattened all-reduce per dtype bucket (an axis of one rank
issues none).  The ranks' losses sum to the global batch's mean, which
``metrics["loss"]`` reports on every rank.

The CLI runs real steps with the synthetic data pipeline and optional
checkpointing on the local mesh (``make_local_mesh``: every rank of the
process group, a world-size-1 group when none is configured), params
placed by ``param_specs``, a checkpoint restored through the mesh; a
group it started ends with it:

  python -m repro_torch.launch.train [--arch mamba2-130m] [--device cuda]
  python -m repro_torch.launch.train --arch qwen1.5-4b --smoke --device cpu
  python -m repro_torch.launch --nprocs 4 --device cpu -m \
      repro_torch.launch.train --arch qwen2-moe-a2.7b --smoke --steps 3 \
      --batch 4 --seq 32

The default arch is the reference's, ``mamba2-130m``.  Weights come from
seed 0 of the port's generator (the reference draws its own).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ShapeSpec, get_config, get_smoke_config
from repro_torch.models.collectives import (axis_group, axis_size,
                                            data_parallel, data_sum,
                                            shard_batch)
from repro_torch.models.model_zoo import ModelAPI, build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

from . import multihost
from .mesh import make_local_mesh
from .shardings import batch_specs, param_specs, place

__all__ = ["make_train_step", "make_serve_step", "loss_and_grads",
           "local_batch", "main"]


def local_batch(model: ModelAPI, batch: dict, mesh
                ) -> tuple[dict, tuple[str, ...]]:
    """(this rank's block of each batch input, the axes it is split over),
    by ``batch_specs`` of the global batch."""
    shape = ShapeSpec("batch", batch["tokens"].shape[1],
                      batch["tokens"].shape[0], "train")
    specs = batch_specs(model.cfg, mesh, shape, "train")
    entry = specs["tokens"][0]
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    return {k: shard_batch(mesh, axes, v) for k, v in batch.items()}, axes


def _sum_grads(grads: dict, mesh, axes: tuple[str, ...]) -> None:
    """Sum ``grads`` over ``axes`` in place: one flattened all-reduce per
    dtype bucket and axis of more than one rank."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if not axes:
        return
    buckets: dict[torch.dtype, list[str]] = {}
    for name, g in grads.items():
        buckets.setdefault(g.dtype, []).append(name)
    for names in buckets.values():
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        for a in axes:
            dist.all_reduce(flat, group=axis_group(mesh, a))
        off = 0
        for n in names:
            g = grads[n]
            grads[n] = flat[off:off + g.numel()].view_as(g)
            off += g.numel()


def loss_and_grads(model: ModelAPI, params, batch: dict, mesh=None
                   ) -> tuple[torch.Tensor, dict]:
    """(the loss, detached; {parameter name: gradient}) of one batch; on a
    mesh, the global batch's loss and the gradients summed over the data
    axes (module docstring)."""
    for p in params.parameters():
        p.grad = None
    if mesh is None:
        loss = model.loss(params, batch)
        loss.backward()
    else:
        local, axes = local_batch(model, batch, mesh)
        with data_parallel(mesh, axes):
            loss = model.loss(params, local)
            loss.backward()
            loss = data_sum(loss)
    # the dict holds the only references, so each gradient is freed when
    # the caller drops it
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    if mesh is not None:
        _sum_grads(grads, mesh, axes)
    return loss.detach(), grads


def make_train_step(model: ModelAPI, opt_cfg: AdamWConfig | None = None,
                    mesh=None):
    """The train step; with ``mesh``, over it (module docstring)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(model, params, batch, mesh)
        params, opt_state, info = adamw_update(opt_cfg, params, grads,
                                               opt_state)
        return params, opt_state, {"loss": loss, **info}

    return train_step


def make_serve_step(model: ModelAPI):
    def serve_step(params, cache, batch):
        logits, new_cache = model.decode(params, cache, batch)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, new_cache

    return serve_step


# ------------------------------------------------------------------------ CLI
def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the launcher's "
                         "ADHASH_DEVICE, else cuda)")
    args = ap.parse_args(argv)
    args.device = args.device or multihost.env_device()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    started = not dist.is_initialized()
    mesh = make_local_mesh(args.device)
    try:
        _train(cfg, args, mesh)
    finally:
        if started:  # a group this call started ends with it
            multihost.shutdown()


def _train(cfg, args, mesh) -> None:
    from repro_torch.data.tokens import synthetic_batches

    model = build_model(cfg, device=args.device)
    params = model.init(0)
    pspecs = param_specs(params, mesh)
    params = place(params, mesh, pspecs)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=args.lr), mesh)

    ckpt = None
    if args.checkpoint_dir:
        from repro_torch.checkpoint.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        restored = ckpt.restore_latest(params, opt, mesh=mesh, specs=pspecs)
        if restored is not None:
            params, opt, start = restored
            print(f"restored checkpoint at step {start}")

    print(f"arch={cfg.name} device={model.device} layers={cfg.n_layers} "
          f"batch={args.batch} seq={args.seq} mesh={tuple(mesh.shape)}")
    t0 = time.perf_counter()
    for step, batch in enumerate(synthetic_batches(
            cfg, args.batch, args.seq, args.steps, device=model.device)):
        params, opt, metrics = step_fn(params, opt, batch)
        if step % 5 == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({time.perf_counter() - t0:.1f}s)")
        if ckpt and args.checkpoint_every and \
                (step + 1) % args.checkpoint_every == 0:
            ckpt.save(params, opt, step + 1)
    print("done")


if __name__ == "__main__":
    main()
