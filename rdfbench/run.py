"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 rdfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks``: each
number compared with its limit, also the last lines of standard error).
Progress goes to standard error.  Exits non-zero, printing no result, when
no CUDA card is there or fewer than the cell asks for, and when the
process has loaded JAX or the JAX package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the benchmark's process must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` unless given) whose top-level name,
    before the first dot, is one of ``FORBIDDEN``, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout (the port
    # builds its kernels into src/repro_torch/_build by itself)
    cache = ROOT / ".rdfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from rdfbench.bench import load_cell

    cell = load_cell(args.workload)
    # the allocator's settings are the deployment's: read before the first
    # CUDA allocation of the process
    if "torch_cuda_alloc_conf" in cell.config:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = \
            cell.config["torch_cuda_alloc_conf"]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"rdfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this process sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from rdfbench.harness import execute

    out = execute(cell, args.seed, args.seconds, bool(args.trace), T_START)
    found = forbidden_modules()
    if found:
        print(f"rdfbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        limit = f" (limit {c['limit']})" if "limit" in c else ""
        print(f"check {name}: {c['value']}{limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
