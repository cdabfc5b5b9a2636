"""Multi-process bring-up for the mesh substrates, and a localhost launcher.

PyTorch port of ``repro.launch.multihost``.  Two halves:

``init_from_env`` / ``ensure_initialized``
    Idempotent ``torch.distributed`` initialization from the coordinator /
    process-count / process-id triple, read from explicit arguments or the
    ``ADHASH_COORDINATOR`` / ``ADHASH_NUM_PROCESSES`` / ``ADHASH_PROCESS_ID``
    environment protocol: ``init_process_group(backend, init_method=
    "tcp://<coordinator>", world_size, rank, timeout)``.  The backend
    follows the device: NCCL for CUDA tensors, gloo for the CPU;
    ``ADHASH_BACKEND`` (``launch_localhost(backend=...)`` sets it)
    overrides it, so ranks that share one card can run gloo on it.  With
    no coordinator configured ``init_from_env`` does nothing and
    ``ensure_initialized`` starts a world-size-1 group on a free localhost
    port, which keeps a ``DistributedSubstrate`` on the collective code
    path.

    A torch rank owns one device, so the reference's ``devices_per_process``
    (and its XLA flag faking CPU devices) has no counterpart here: the
    worker axis is split over processes, and ``device="cpu"|"cuda"`` (or
    ``ADHASH_DEVICE``) says where each process keeps its block.

    Every group gets the ``PG_TIMEOUT`` timeout (120 s): a rank that
    leaves lockstep makes its peers' next collective fail instead of
    hanging the run.

``launch_localhost`` / ``python -m repro_torch.launch``
    Spawns N worker processes on localhost, wires the env protocol (one free
    coordinator port, dense process ids, the device and backend) and
    collects each process's exit code and output.  Workers re-enter through
    ``python -m repro_torch.launch --worker <target>``, which joins the
    group *before* running the target, as a cluster launcher would.  Every
    launch has a timeout: on expiry the workers are killed.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "init_from_env",
    "ensure_initialized",
    "shutdown",
    "launch_localhost",
    "ProcResult",
    "ENV_COORDINATOR",
    "ENV_NUM_PROCESSES",
    "ENV_PROCESS_ID",
    "ENV_DEVICE",
    "ENV_BACKEND",
]

ENV_COORDINATOR = "ADHASH_COORDINATOR"
ENV_NUM_PROCESSES = "ADHASH_NUM_PROCESSES"
ENV_PROCESS_ID = "ADHASH_PROCESS_ID"
ENV_DEVICE = "ADHASH_DEVICE"
ENV_BACKEND = "ADHASH_BACKEND"

PG_TIMEOUT = datetime.timedelta(seconds=120)


def env_device() -> str:
    """The device a launched process keeps its worker block on."""
    return os.environ.get(ENV_DEVICE) or "cuda"


def _backend_for(device: str) -> str:
    return (os.environ.get(ENV_BACKEND)
            or ("nccl" if str(device).startswith("cuda") else "gloo"))


def _set_cuda_device(device: str) -> None:
    import torch

    if str(device).startswith("cuda"):
        # one card a rank: index from the device string, else the first
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None else 0)


def init_from_env(
    *,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | None = None,
) -> bool:
    """Join the process group from args or the env protocol.

    Returns True when the process is in (or was already in) a
    multi-process group, False when no coordinator is configured (single
    process).  Idempotent: an existing default group is kept, so
    ``DistributedSubstrate`` can call this even when the launcher did."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        raw = os.environ.get(ENV_NUM_PROCESSES)
        num_processes = int(raw) if raw else None
    if process_id is None:
        raw = os.environ.get(ENV_PROCESS_ID)
        process_id = int(raw) if raw is not None and raw != "" else None
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError(
            f"{ENV_PROCESS_ID} / process_id required when a coordinator is "
            f"configured ({coordinator!r}, {num_processes} processes)"
        )
    device = device or env_device()
    _set_cuda_device(device)
    dist.init_process_group(
        _backend_for(device), init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, timeout=PG_TIMEOUT)
    return True


def ensure_initialized(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: str | None = None,
) -> bool:
    """``init_from_env``; with no coordinator and no default group, a
    world-size-1 group over a TCPStore on a free localhost port.  Returns
    whether the group spans several processes."""
    import torch.distributed as dist

    if init_from_env(coordinator=coordinator, num_processes=num_processes,
                     process_id=process_id, device=device):
        return True
    if not dist.is_initialized():
        device = device or env_device()
        _set_cuda_device(device)
        # port 0: the store binds a free port itself (no race)
        store = dist.TCPStore("127.0.0.1", 0, 1, True, timeout=PG_TIMEOUT)
        dist.init_process_group(_backend_for(device), store=store,
                                world_size=1, rank=0, timeout=PG_TIMEOUT)
    return False


def shutdown() -> None:
    """Leave the default process group, if any."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Localhost process launcher (tests, chip_smoke.py's two-rank phase)
# ---------------------------------------------------------------------------
@dataclass
class ProcResult:
    """Outcome of one launched worker process."""

    process_id: int
    returncode: int
    stdout: str
    stderr: str

    @property
    def ok(self) -> bool:
        return self.returncode == 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Transport failures that say nothing about the program under test: gloo
# and c10d aborting in C++ (no Python traceback), or a worker killed by a
# signal.  ``launch_localhost(retries=...)`` relaunches the whole group on
# them.  A failure whose output holds an AssertionError or a Python
# traceback is the target's own and is never retried.
_INFRA_SIGNATURES = (
    "gloo::EnforceNotMet",
    "gloo::IoException",
    "terminate called after throwing an instance of 'c10::DistBackendError'",
    "terminate called after throwing an instance of 'c10::DistNetworkError'",
    "Connection closed by peer",
    "Connection reset by peer",
)


def _is_infra_failure(results: list["ProcResult"]) -> bool:
    failed = [r for r in results if not r.ok]
    if not failed:
        return False
    if any("AssertionError" in r.stderr
           or "Traceback (most recent call last)" in r.stderr
           for r in results):
        return False
    return all(
        r.returncode < 0
        or any(sig in r.stderr for sig in _INFRA_SIGNATURES)
        for r in failed
    )


def _src_root() -> str:
    # .../src/repro_torch/launch/multihost.py -> .../src
    return str(Path(__file__).resolve().parents[2])


def launch_localhost(
    n_processes: int,
    target_argv: list[str],
    *,
    device: str = "cuda",
    backend: str | None = None,
    timeout: float = 600.0,
    env: dict[str, str] | None = None,
    retries: int = 0,
) -> list[ProcResult]:
    """Spawn ``n_processes`` workers on localhost running ``target_argv``.

    ``target_argv`` is what each worker runs after joining the group:
    ``["-m", "module", ...args]`` or ``["script.py", ...args]``.  Each
    worker gets the env protocol above (``device`` and ``backend`` too)
    and ``src/`` on its PYTHONPATH.  Blocks until every worker exits or
    ``timeout`` seconds pass; then all workers are killed and the partial
    results carry returncode -9.  ``retries`` relaunches the whole group
    (fresh coordinator port) when the failure matches a transport
    signature -- never when the target itself raised."""
    if n_processes < 1:
        raise ValueError("n_processes must be >= 1")
    for _attempt in range(retries):
        results = _launch_once(n_processes, target_argv, device, backend,
                               timeout, env)
        if not _is_infra_failure(results):
            return results
    return _launch_once(n_processes, target_argv, device, backend, timeout,
                        env)


def _launch_once(
    n_processes: int,
    target_argv: list[str],
    device: str,
    backend: str | None,
    timeout: float,
    env: dict[str, str] | None,
) -> list[ProcResult]:
    port = _free_port()
    procs: list[subprocess.Popen] = []
    for pid in range(n_processes):
        penv = dict(os.environ)
        if env:
            penv.update(env)
        penv[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        penv[ENV_NUM_PROCESSES] = str(n_processes)
        penv[ENV_PROCESS_ID] = str(pid)
        penv[ENV_DEVICE] = device
        if backend:
            penv[ENV_BACKEND] = backend
        src = _src_root()
        pp = penv.get("PYTHONPATH", "")
        if src not in pp.split(os.pathsep):
            penv["PYTHONPATH"] = f"{src}{os.pathsep}{pp}" if pp else src
        cmd = [sys.executable, "-m", "repro_torch.launch", "--worker"] + list(
            target_argv
        )
        procs.append(
            subprocess.Popen(
                cmd,
                env=penv,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
        )
    results: list[ProcResult] = []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            results.append(ProcResult(pid, p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for pid, p in enumerate(procs[len(results):], start=len(results)):
            out, err = p.communicate()
            results.append(ProcResult(pid, -9, out, err))
    return results
