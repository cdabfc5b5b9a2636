"""The collectives of the per-shard bodies that run on a mesh (a
``torch.distributed.device_mesh.DeviceMesh`` with the axis names of
``launch.mesh``), and the axis queries they need: the port's counterpart of
the reference's ``shard_map`` shim in ``repro.models.common``.

The port keeps activations replicated over ``model`` (ROADMAP §1 item
12d.2 brings tensor-parallel dense layers), so the collectives of the
per-shard bodies (``models.embedding.adaptive_embed``,
``models.moe_sharded.moe_ffn_sharded``) are the two of a replicated region:
``all_gather_replicated`` (its backward keeps this rank's slice of the
gradient) and ``all_reduce_replicated`` (its backward passes the gradient
through).  Every rank computes the same loss from their outputs, so these
backwards give each rank the gradient of that one loss;
``torch.distributed.nn.functional``'s (a reduce-scatter, an all-reduce)
would sum the ranks' equal gradients, m times too large.
"""
from __future__ import annotations

import torch

__all__ = [
    "axis_size",
    "axis_rank",
    "axis_group",
    "all_gather_replicated",
    "all_reduce_replicated",
    "data_shard",
    "data_gather",
    "all_reduce_mesh",
]


def axis_size(mesh, axis: str) -> int:
    """The mesh's extent along ``axis`` (1 for an axis it lacks, as the
    reference's ``mesh.shape.get(axis, 1)``)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (the reference's
    ``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.new_empty((dist.get_world_size(group), *x.shape))
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        return grad[dist.get_rank(ctx.group)], None


class _ReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """(G, *x.shape): every rank's ``x`` in group-rank order (the
    reference's ``jax.lax.all_gather``).  Backward: this rank's slice."""
    return _GatherReplicated.apply(x, group)


def all_reduce_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (the reference's ``jax.lax.psum``).
    Backward: the gradient as it is."""
    return _ReduceReplicated.apply(x, group)


def _data_axes(mesh, axis: str) -> list[str]:
    return [a for a in mesh.mesh_dim_names if a != axis]


def data_shard(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's block of ``x``'s leading (batch) axis, split over the
    mesh's axes other than ``axis`` (outermost first), as a shard_map
    in_spec of ``P(data_axes, ...)`` hands it to a shard."""
    n, i = 1, 0
    for a in _data_axes(mesh, axis):
        n, i = n * axis_size(mesh, a), i * axis_size(mesh, a) + \
            axis_rank(mesh, a)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over the "
                         f"data axes' {n} shards")
    bl = x.shape[0] // n
    return x[i * bl:(i + 1) * bl]


def data_gather(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The whole batch from every rank's ``data_shard`` block (activations
    stay replicated in the port); no collective where the data axes have
    one shard."""
    for a in reversed(_data_axes(mesh, axis)):
        if axis_size(mesh, a) > 1:
            x = all_gather_replicated(x, axis_group(mesh, a)).flatten(0, 1)
    return x


def all_reduce_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of the mesh (the reference's psum
    over all its axes), in place; not differentiable."""
    import torch.distributed as dist

    for a in mesh.mesh_dim_names:
        dist.all_reduce(x, group=axis_group(mesh, a))
    return x
