#!/usr/bin/env python3
"""Kernel times of two checkouts of the port, in turns, on one GPU.

    python3 chip_ab.py OLD_ROOT NEW_ROOT

Each root is a checkout holding ``src/repro_torch`` (for instance the parent
commit unpacked with ``git archive`` beside the change).  The script runs
one process per tree in the order old, new, new, old, so that both versions
are timed on the same card in the same call; each process builds its
tree's kernels and prints one JSON line of medians over CUDA events (20
launches after 3 warm-ups) at the shapes of ``chip_smoke.py``'s phase 1:
the bf16 flash_attention rows below 32k and the unique_compact rows, with
``F.scaled_dot_product_attention`` and ``torch.unique`` beside them.  The
last line holds each key's times per tree.  Without a card it exits 1.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

# (name, B, T, H, KV, hd, causal): chip_smoke.py phase 1's bf16 rows
FLASH = [("main B=4", 4, 4096, 32, 8, 128, True),
         ("B=1", 1, 4096, 32, 8, 128, True),
         ("non-causal", 1, 4096, 32, 8, 128, False),
         ("T=S=1000", 1, 1000, 32, 8, 128, True),
         ("MHA H=KV=20", 1, 4096, 20, 20, 128, True),
         ("hd=64", 1, 4096, 32, 8, 64, True),
         ("hd=16", 1, 4096, 32, 8, 16, True)]
# (n, value range, out_cap, dtype) per worker row, W = 8
UNIQUE = [(1 << 10, 800, 256, "int32"), (1 << 18, 1 << 17, 1 << 16, "int32"),
          (1 << 18, 1 << 17, 1 << 16, "int64")]


def measure(root: str) -> dict:
    """Times of one tree's kernels (runs in a process of its own)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(root).resolve() / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.relalg_ops.compact import unique_compact_cuda

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict[str, float] = {}
    with torch.inference_mode():
        for name, b, t, h, kv, hd, causal in FLASH:
            q, k, v = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((b, t, h, hd), (b, t, kv, hd),
                                     (b, t, kv, hd)))
            out[f"flash_attention {name}"] = time_ms(
                lambda: flash_attention_cuda(q, k, v, causal=causal))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out[f"sdpa {name}"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True))
    rng = np.random.default_rng(0)
    for n, hi, cap, dt in UNIQUE:
        vals = torch.from_numpy(rng.integers(0, hi, (8, n)).astype(dt)).to(dev)
        valid = torch.from_numpy(rng.random((8, n)) < 0.9).to(dev)
        pad = int(np.iinfo(dt).max)
        tag = f"{dt} n=2^{n.bit_length() - 1}"
        out[f"unique_compact {tag}"] = time_ms(
            lambda: unique_compact_cuda(vals, valid, cap, pad))
        offs = torch.arange(8, device=dev, dtype=torch.int64)[:, None] << 32
        keyed = torch.where(valid, vals, pad).to(torch.int64) + offs
        out[f"torch.unique {tag}"] = time_ms(
            lambda: torch.unique(keyed.view(-1), sorted=True))
    return out


def main(argv: list[str]) -> int:
    import torch

    if len(argv) == 3 and argv[1] == "--measure":
        print(json.dumps(measure(argv[2])), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    old, new = argv[1:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    runs: dict[str, list[dict]] = {"old": [], "new": []}
    for tag, root in (("old", old), ("new", new), ("new", new), ("old", old)):
        res = subprocess.run([sys.executable, __file__, "--measure", root],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            print(res.stderr, file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, "root": root, **row}), flush=True)
        runs[tag].append(row)
    print(json.dumps({key: {tag: [r[key] for r in rows]
                            for tag, rows in runs.items()}
                      for key in runs["new"][0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
