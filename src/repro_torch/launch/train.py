"""Step builders of the LM side and the training CLI.

The port's counterpart of ``repro.launch.train``.  ``make_train_step``
returns a (params, opt, batch) -> (params, opt, metrics) function: the loss,
its backward (through the hand-written attention backward on the card),
then ``adamw_update``, which updates the parameters and moments in place;
the gradients are dropped before it returns.  ``make_serve_step`` is the
decode step that ``serve_loop`` drives.

The CLI runs real steps with the synthetic data pipeline and optional
checkpointing, on one device (data-parallel training over a mesh is
ROADMAP §1 item 12d.2):

  python -m repro_torch.launch.train [--arch mamba2-130m] [--device cuda]
  python -m repro_torch.launch.train --arch qwen1.5-4b --smoke --device cpu

The default arch is the reference's, ``mamba2-130m``.  Weights come from
seed 0 of the port's generator (the reference draws its own).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model_zoo import ModelAPI, build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_train_step", "make_serve_step", "main"]


def make_train_step(model: ModelAPI, opt_cfg: AdamWConfig | None = None):
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        for p in params.parameters():
            p.grad = None
        loss = model.loss(params, batch)
        loss.backward()
        # the dict holds the only references, so each gradient is freed
        # when the step returns
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        params, opt_state, info = adamw_update(opt_cfg, params, grads,
                                               opt_state)
        return params, opt_state, {"loss": loss.detach(), **info}

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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)

    from repro_torch.data.tokens import synthetic_batches

    params = model.init(0)
    opt = adamw_init(params)
    step_fn = make_train_step(model, AdamWConfig(lr=args.lr))

    ckpt = None
    if args.checkpoint_dir:
        from repro_torch.checkpoint.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.checkpoint_dir)
        restored = ckpt.restore_latest(params, opt)
        if restored is not None:
            params, opt, start = restored
            print(f"restored checkpoint at step {start}")

    print(f"arch={cfg.name} device={model.device} layers={cfg.n_layers} "
          f"batch={args.batch} seq={args.seq}")
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
