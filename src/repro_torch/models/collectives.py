"""The collectives of the per-shard bodies that run on a mesh (a
``torch.distributed.device_mesh.DeviceMesh`` with the axis names of
``launch.mesh``), and the axis queries they need: the port's counterpart of
the reference's ``shard_map`` shim in ``repro.models.common``.

Activations are replicated over ``model``: every rank of a ``model``
line computes the same loss.  The collectives of that replicated region
are ``all_gather_replicated`` (its backward keeps this rank's slice of the
gradient) and ``all_reduce_replicated`` (its backward passes the gradient
through): these backwards give each rank the gradient of that one loss,
where ``torch.distributed.nn.functional``'s (a reduce-scatter, an
all-reduce) would sum the ranks' equal gradients, m times too large.

The tensor-parallel layers (Megatron style, ``launch.shardings.place``
cuts their leaves) add the pair's other half: ``copy_to_parallel`` is the
identity into a column-parallel product and all-reduces the gradient in
its backward (each rank's product sees only its columns, so each holds a
part of the input's gradient); the row-parallel product's partial output
is summed by ``all_reduce_replicated``.  ``all_reduce_sum`` (all-reduce
both ways) carries a weight from the rank that owns it to the ranks that
use it (``moe_sharded``'s hot-expert replicas).

``data_parallel(mesh, axes)`` marks a data-parallel region: the train
step (``launch.train.make_train_step`` with a mesh) runs its forward and
backward on this rank's block of the batch, split over ``axes``.  Inside
it, ``data_shard`` / ``data_gather`` (the per-shard bodies' own split of a
replicated batch) are the identity, ``gather_batch`` / ``shard_batch``
join the blocks for a computation over the global batch (the plain MoE
dispatch, whose capacity is the global batch's), and ``data_sum`` sums a
count over the blocks (the loss's denominator).  An axis of one rank
issues no collective, so a world of one rank runs the program without a
mesh bit for bit.

``trace_collectives`` records every collective this process issues
through ``torch.distributed`` (kind and result bytes), for the dry-run's
collective counts.
"""
from __future__ import annotations

from contextlib import contextmanager

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
    "copy_to_parallel",
    "all_reduce_sum",
    "all_gather_parallel",
    "all_reduce_max",
    "data_parallel",
    "dp_axes",
    "dp_blocks",
    "gather_batch",
    "shard_batch",
    "data_sum",
    "trace_collectives",
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


class _CopyToParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        m = dist.get_world_size(group)
        parts = x.new_empty((m, *x.shape))
        dist.all_gather(list(parts.unbind(0)), x.contiguous(), group=group)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        m = dist.get_world_size(ctx.group)
        parts = [g.contiguous() for g in grad.chunk(m, dim=ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out, None, None


def _single(group) -> bool:
    import torch.distributed as dist

    return dist.get_world_size(group) == 1


def copy_to_parallel(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is, into a column-parallel product; backward: the
    gradient summed over ``group``."""
    return x if _single(group) else _CopyToParallel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x``; backward: the gradient summed over
    ``group`` too (each rank uses the result in its own way)."""
    return x if _single(group) else _ReduceSum.apply(x, group)


def all_gather_parallel(x: torch.Tensor, group, dim: int = -1
                        ) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in group-rank order: the
    whole of an activation cut along ``dim``.  Backward: a reduce-scatter
    (this rank's slice of the gradient summed over ``group``)."""
    return x if _single(group) else _GatherParallel.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every rank's ``x``, detached (a new
    tensor)."""
    import torch.distributed as dist

    x = x.detach().clone()
    if not _single(group):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


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


#: the data-parallel region's (mesh, batch axes), or None outside one
_DP: tuple | None = None


@contextmanager
def data_parallel(mesh, axes: tuple[str, ...]):
    """Inside the block, activations are this rank's block of the batch,
    split over ``axes`` of ``mesh`` (outermost first)."""
    global _DP
    prev, _DP = _DP, (mesh, tuple(axes))
    try:
        yield
    finally:
        _DP = prev


def dp_axes() -> tuple | None:
    """(mesh, the batch axes of more than one rank) inside a
    data-parallel region that splits the batch, else None."""
    if _DP is None:
        return None
    mesh, axes = _DP
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return (mesh, axes) if axes else None


def dp_blocks() -> int:
    """The blocks a data-parallel region splits the batch into (1 outside
    one)."""
    dp = dp_axes()
    return 1 if dp is None else _block(*dp)[0]


def _block(mesh, axes) -> tuple[int, int]:
    """(blocks, this rank's block) of a split over ``axes``."""
    n, i = 1, 0
    for a in axes:
        n, i = n * axis_size(mesh, a), i * axis_size(mesh, a) + \
            axis_rank(mesh, a)
    return n, i


def shard_batch(mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``x``'s leading (batch) axis, split over
    ``axes`` (outermost first), as a ``PartitionSpec`` entry of those axes
    hands it to a shard."""
    n, i = _block(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not split over the "
                         f"data axes' {n} shards")
    bl = x.shape[0] // n
    return x[i * bl:(i + 1) * bl]


def gather_batch(mesh, axes, x: torch.Tensor) -> torch.Tensor:
    """The whole batch from every rank's ``shard_batch`` block; backward:
    this rank's block of the gradient (a block's outputs reach the loss
    only through this rank's share of it)."""
    for a in reversed(axes):
        if axis_size(mesh, a) > 1:
            x = all_gather_replicated(x, axis_group(mesh, a)).flatten(0, 1)
    return x


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel region's blocks (a count: not
    differentiable); ``x`` itself outside one."""
    dp = dp_axes()
    if dp is None:
        return x
    import torch.distributed as dist

    mesh, axes = dp
    x = x.detach().clone()
    for a in axes:
        dist.all_reduce(x, group=axis_group(mesh, a))
    return x


def data_shard(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's block of ``x``'s leading (batch) axis, split over the
    mesh's axes other than ``axis`` (outermost first), as a shard_map
    in_spec of ``P(data_axes, ...)`` hands it to a shard.  Inside a
    data-parallel region ``x`` already is that block."""
    if _DP is not None:
        return x
    return shard_batch(mesh, _data_axes(mesh, axis), x)


def data_gather(mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The whole batch from every rank's ``data_shard`` block (activations
    stay replicated over the data axes outside a data-parallel region, and
    stay this rank's block inside one); no collective where the data axes
    have one shard."""
    if _DP is not None:
        return x
    return gather_batch(mesh, _data_axes(mesh, axis), x)


def all_reduce_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of the mesh (the reference's psum
    over all its axes), in place; not differentiable."""
    import torch.distributed as dist

    for a in mesh.mesh_dim_names:
        dist.all_reduce(x, group=axis_group(mesh, a))
    return x


# ------------------------------------------------------------------- tracing
_KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "all_gather_into_tensor": "all-gather",
          "reduce_scatter": "reduce-scatter",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast"}


def _result_bytes(name: str, args) -> int:
    """Bytes of a collective's result (its first argument: the tensor it
    reduces in place or writes; all_gather's list of outputs)."""
    out = args[0]
    if name == "all_gather":
        return sum(t.numel() * t.element_size() for t in out)
    return out.numel() * out.element_size()


@contextmanager
def trace_collectives():
    """Record every collective this process issues through
    ``torch.distributed`` inside the block: yields a list that gathers
    (kind, result bytes) pairs in issue order (the kinds are the
    reference's HLO names: "all-reduce", "all-gather", "reduce-scatter",
    "all-to-all"; "broadcast" has none)."""
    import torch.distributed as dist

    events: list[tuple[str, int]] = []
    saved = {name: getattr(dist, name) for name in _KINDS}

    def wrap(name, fn):
        def traced(*args, **kwargs):
            events.append((_KINDS[name], _result_bytes(name, args)))
            return fn(*args, **kwargs)
        return traced

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield events
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
