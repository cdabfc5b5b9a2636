"""LM-side batched decode driver: continuous decode with the adaptive
controller in the loop.

The port's counterpart of ``repro.launch.serve``: a fixed decode budget per
request batch, with the AdHash-style controller replanning hot embedding
rows from the observed tokens between batches.  ``main`` serves on the
local mesh (``launch.mesh.make_local_mesh``: every rank of the process
group, a world-size-1 group when none is configured), with the params
placed by ``launch.shardings.param_specs``; ``--int8-kv`` turns on the
int8 KV cache and bf16 cache math, as the reference's flag does.

Run:  python -m repro_torch.launch.serve --arch llama3-8b [--device cuda]
      python -m repro_torch.launch.serve --arch qwen1.5-4b --smoke --device cpu
      python -m repro_torch.launch.serve --arch llama3-8b --int8-kv
(any decoder-only arch of ``repro_torch.configs``: dense, moe, ssm, hybrid
or vlm; a vlm decodes text only, as the reference's does).  The audio
family's decode needs encoder states, which the reference's loop does not
make either: drive it through ``launch.train.make_serve_step`` with
``batch["enc"]`` from ``models.whisper.whisper_encode``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.adaptive import AdaptiveShardingController
from repro_torch.data.tokens import zipf_tokens
from repro_torch.launch import multihost
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.shardings import param_specs, place
from repro_torch.launch.train import make_serve_step
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import RuntimeOptions

__all__ = ["serve_loop", "main"]


def serve_loop(model, params, *, batch_size: int, max_len: int,
               steps: int, n_batches: int, controller=None, rng=None):
    """Decode ``steps`` tokens for ``n_batches`` request batches, each from
    a zero cache made for ``params`` (a placed hybrid's holds its RG-LRU
    channels).

    Returns per-batch decode times (ended by a device synchronize) and the
    final replication plan."""
    if model.cfg.family == "audio":
        raise ValueError("serve_loop decodes decoder-only archs; the audio "
                         "family's decode takes batch['enc'] (drive it "
                         "through launch.train.make_serve_step)")
    serve = make_serve_step(model)
    rng = rng or np.random.default_rng(0)
    dev = model.device
    times = []
    plan = None
    for _ in range(n_batches):
        cache = model.init_cache(batch_size, max_len, params)
        tok = torch.from_numpy(
            zipf_tokens(rng, model.cfg.vocab_size, (batch_size, 1))
            .astype(np.int64)).to(dev)
        t0 = time.perf_counter()
        for pos in range(steps):
            if controller is not None:
                controller.observe(tok.cpu().numpy())
            nxt, cache = serve(params, cache, {"tokens": tok, "pos": pos})
            tok = nxt[:, None]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        if controller is not None:
            plan = controller.replan()
    return times, plan


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    started = not dist.is_initialized()
    mesh = make_local_mesh(args.device)
    try:
        _serve(cfg, args, mesh)
    finally:
        if started:  # a group this call started ends with it
            multihost.shutdown()


def _serve(cfg, args, mesh) -> None:
    opts = RuntimeOptions(mesh=mesh, kv_cache_int8=args.int8_kv,
                          bf16_cache_math=args.int8_kv)
    model = build_model(cfg, opts=opts, device=args.device)
    # serving weights are stored in the compute dtype once, at load
    params = model.init(0, dtype=cfg.cdtype)
    params = place(params, mesh, param_specs(params, mesh))
    ctrl = AdaptiveShardingController(
        cfg.vocab_size,
        budget=(cfg.adaptive.embedding_hot_budget if cfg.adaptive else 1024),
    )
    times, plan = serve_loop(
        model, params, batch_size=args.batch, max_len=args.max_len,
        steps=args.steps, n_batches=args.batches, controller=ctrl,
    )
    tps = args.batch * args.steps / np.mean(times[1:]) if len(times) > 1 else 0
    print(f"arch={cfg.name} device={model.device} "
          f"mesh={tuple(mesh.shape)} int8_kv={args.int8_kv} "
          f"batches={len(times)} steady tok/s={tps:.1f}")
    if plan:
        print(f"controller: hot={plan.n_hot} coverage={plan.coverage:.2f}")


if __name__ == "__main__":
    main()
