"""Gradient compression for a data-parallel all-reduce.

PyTorch port of ``repro.optim.compression``: int8 linear quantization
with **error feedback** (the residual of each step is added back before
the next quantization), one float32 scale per tensor.  The reference runs
``pod_allreduce_compressed`` inside ``shard_map`` over a mesh axis; here
the axis is a ``torch.distributed`` process group: the int8 payload is
summed as int32 with ``all_reduce(SUM)``, the scales are reduced with
``all_reduce(MAX)``, and the sum is divided by the group's size.  Both
packages round half to even (``jnp.round``, ``torch.round``), so ``q`` is
bit-exact with the reference's.

Trees are ``torch.utils._pytree`` trees (dicts, lists, tuples) of tensors,
as the reference's pytrees; a gradient mapping keyed by the port's
parameter names works as it is.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["EFState", "ef_init", "compress_tree", "decompress_tree",
           "pod_allreduce_compressed"]


class EFState(NamedTuple):
    residual: Any  # error-feedback memory, same structure as grads


def ef_init(grads: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _quantize(g: torch.Tensor, r: torch.Tensor):
    x = g.float() + r
    # 127 as a tensor on x's device: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal, one rounding away from the CPU's
    # (and the reference's) quotient
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / \
        torch.full((), 127.0, device=x.device)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_r = x - q.float() * scale
    return q, scale, new_r


def compress_tree(grads: Any, state: EFState):
    """(int8 tree, float32 scale tree, EFState with the new residuals)."""
    leaves, spec = tree_flatten(grads)
    out = [_quantize(g, r) for g, r in zip(leaves,
                                           tree_leaves(state.residual))]
    part = lambda i: tree_unflatten([o[i] for o in out], spec)
    return part(0), part(1), EFState(residual=part(2))


def decompress_tree(qtree: Any, scales: Any) -> Any:
    return tree_map(lambda q, s: q.float() * s, qtree, scales)


def pod_allreduce_compressed(grads: Any, state: EFState,
                             group: dist.ProcessGroup | None = None):
    """int8-compressed all-reduce with error feedback over ``group`` (the
    default group when None): the mean of the ranks' dequantized
    gradients, every rank dequantizing with the largest scale.  Returns
    (mean tree, new EFState)."""
    q, s, new_state = compress_tree(grads, state)
    n = dist.get_world_size(group)

    def reduce(qq, ss):
        acc = qq.to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        smax = ss.clone()
        dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        return acc.float() * smax / n

    return tree_map(reduce, q, s), new_state
