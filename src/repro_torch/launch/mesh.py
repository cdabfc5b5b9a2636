"""Device meshes over ``torch.distributed``.

PyTorch port of ``repro.launch.mesh``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names: ``("data", "model")``, or ``("pod", "data", "model")`` for the
multi-pod production mesh, model innermost.  Building one needs an
initialised default process group: ``make_local_mesh`` joins one through
``launch.multihost.ensure_initialized`` (the env protocol of
``launch_localhost``, else a world-size-1 group: NCCL on the card, gloo on
the CPU).  The reference's rule for the local mesh's shape is a pure
function of the world size (``local_mesh_shape``), so that tests can hold
it to the reference's without ranks.
"""
from __future__ import annotations

from repro_torch.models.collectives import axis_size

__all__ = [
    "AXES",
    "POD_AXES",
    "local_mesh_shape",
    "make_local_mesh",
    "make_production_mesh",
    "batch_axes",
]

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def local_mesh_shape(n: int) -> tuple[int, int]:
    """(data, model) of the local mesh over ``n`` ranks: model is the
    largest of 16, 8, 4, 2 that divides n (else 1), as the reference's
    ``make_local_mesh`` chooses."""
    model = 1
    for m in (16, 8, 4, 2):
        if n % m == 0 and n >= m:
            model = m
            break
    return n // model, model


def _device_type(device: str | None) -> str:
    from .multihost import env_device

    return "cuda" if str(device or env_device()).startswith("cuda") else "cpu"


def make_local_mesh(device: str | None = None):
    """Every rank of the default group as a (data, model) mesh, model
    innermost.  Joins (or starts) the group first; ``device`` ("cuda" or
    "cpu", default ``ADHASH_DEVICE`` or "cuda") picks the backend."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .multihost import ensure_initialized

    ensure_initialized(device=device)
    return init_device_mesh(_device_type(device),
                            local_mesh_shape(dist.get_world_size()),
                            mesh_dim_names=AXES)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | None = None):
    """16 x 16 = 256 ranks as (data, model); with ``multi_pod`` 2 x 16 x 16
    = 512 as (pod, data, model).  Raises ValueError on a smaller (or any
    other) world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    need = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the {'multi-pod ' if multi_pod else ''}production mesh needs "
            f"{need} ranks; this world has {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=POD_AXES if multi_pod else AXES)


def batch_axes(mesh, global_batch: int) -> tuple[str, ...]:
    """The data-parallel axes usable for a given batch (divisibility)."""
    out: list[str] = []
    prod = 1
    for a in ("pod", "data"):
        if a not in (mesh.mesh_dim_names or ()):
            continue
        if global_batch % (prod * axis_size(mesh, a)) == 0:
            out.append(a)
            prod *= axis_size(mesh, a)
    return tuple(out)
