"""``python -m repro_torch.launch`` -- localhost multi-process launcher CLI.

Parent mode (default): spawn N workers on localhost, each running the given
target after joining a ``torch.distributed`` group, then relay their output
line by line, prefixed ``[pN]``::

    python -m repro_torch.launch --nprocs 2 --device cpu script.py --flag

Worker mode (``--worker``, used by the parent): join the group from the env
protocol *before* the target runs, run it as ``__main__`` via runpy, then
leave the group.
"""
from __future__ import annotations

import argparse
import sys

_VALUE_FLAGS = {"--nprocs", "--device", "--timeout", "--retries"}


def _split_target(argv: list[str]) -> tuple[list[str], list[str]]:
    """Split launcher flags from the target argv at ``-m`` or the first
    non-flag token (a script path).  Launcher flags taking a value consume
    their following token, so ``--nprocs 2 script.py`` splits correctly."""
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-m" or not a.startswith("-"):
            return argv[:i], argv[i:]
        i += 2 if a in _VALUE_FLAGS and "=" not in a else 1
    return argv, []


def _run_worker(target: list[str]) -> int:
    from repro_torch.launch.multihost import init_from_env, shutdown

    init_from_env()
    import runpy

    try:
        if target and target[0] == "-m":
            if len(target) < 2:
                print("launch: -m requires a module name", file=sys.stderr)
                return 2
            mod, args = target[1], target[2:]
            sys.argv = [mod] + args
            runpy.run_module(mod, run_name="__main__", alter_sys=True)
        elif target:
            script, args = target[0], target[1:]
            sys.argv = [script] + args
            runpy.run_path(script, run_name="__main__")
        else:
            print("launch: no target given", file=sys.stderr)
            return 2
    finally:
        shutdown()
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--worker":
        return _run_worker(argv[1:])

    own, target = _split_target(argv)
    parser = argparse.ArgumentParser(prog="repro_torch.launch",
                                     description=__doc__)
    parser.add_argument("--nprocs", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                        help="where each process keeps its worker block "
                             "(cuda: NCCL, one card a process; cpu: gloo)")
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--retries", type=int, default=0,
                        help="relaunches on transport failures")
    args = parser.parse_args(own)
    if not target:
        parser.error("no target given (script path or -m module)")

    from repro_torch.launch.multihost import launch_localhost

    results = launch_localhost(
        args.nprocs,
        target,
        device=args.device,
        timeout=args.timeout,
        retries=args.retries,
    )
    rc = 0
    for r in results:
        for line in r.stdout.splitlines():
            print(f"[p{r.process_id}] {line}")
        for line in r.stderr.splitlines():
            print(f"[p{r.process_id}] {line}", file=sys.stderr)
        if not r.ok:
            rc = rc or (r.returncode if r.returncode > 0 else 1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
