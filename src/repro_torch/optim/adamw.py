"""AdamW with global-norm clipping.

PyTorch port of ``repro.optim.adamw``.  The state keeps the reference's
shape: ``OptState(step, m, v)`` with ``step`` an int32 scalar and ``m`` and
``v`` float32 trees in the reference's structure (blocks stacked on axis
0), so checkpoints and the parity tests name them as the JAX package does.
A parameter of the port's ``LM`` finds its moments through the weight
converter (``models.convert.tree_leaf``): block i's leaf is row i of the
stacked moment, a view, so the update writes the tree in place.

``grads`` maps the port's parameter names to gradients
(``{n: p.grad for n, p in params.named_parameters()}``).  The update is
plain torch elementwise math under ``torch.no_grad()`` (the reference's is
plain jnp outside any kernel), in the reference's order: the clip scale
from the global norm, bias corrections from the float32 step, decoupled
weight decay on the float32 parameter, then a cast back to the parameter's
dtype.  Unlike the reference, which returns new arrays, it updates the
parameters and moments in place (and returns them), so a step holds no
second copy of either.

On a mesh (a module ``launch.shardings.place`` placed), a parameter cut
over ``model`` holds this rank's slice and its moments the same slice
(``adamw_init`` takes the placed shapes).  The clip scale's global norm
then sums a cut leaf's squares over ``model`` and counts a replicated
leaf's once, as the norm of the whole gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping, NamedTuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.models.convert import ref_shapes, tree_leaf

__all__ = ["AdamWConfig", "OptState", "adamw_init", "global_norm",
           "adamw_update"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any
    v: Any


def adamw_init(params: torch.nn.Module) -> OptState:
    """Zero float32 moments in the reference's tree structure, on the
    parameters' device."""
    dev = next(params.parameters()).device
    zeros = lambda: tree_map(
        lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev),
        ref_shapes(params), is_leaf=lambda x: isinstance(x, tuple))
    return OptState(torch.zeros((), dtype=torch.int32, device=dev), zeros(),
                    zeros())


def _sum_sq(leaves: Iterable[torch.Tensor]) -> torch.Tensor | None:
    """The sum of every leaf's float32 squares (a 0-d tensor), leaf by
    leaf in order; None for no leaves."""
    total = None
    for x in leaves:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return total


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 squares (a 0-d tensor)."""
    return torch.sqrt(_sum_sq(leaves))


def _mesh_norm(grads: Mapping[str, torch.Tensor], names: list[str],
               placement) -> torch.Tensor:
    """The whole gradient's norm from this rank's: the replicated leaves'
    squares, plus the cut leaves' summed over ``model``."""
    import torch.distributed as dist

    from repro_torch.models.collectives import axis_group

    sq = _sum_sq(grads[n] for n in names if n in placement.cut)
    dist.all_reduce(sq, group=axis_group(placement.mesh, "model"))
    rep = _sum_sq(grads[n] for n in names if n not in placement.cut)
    return torch.sqrt(sq if rep is None else rep + sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: torch.nn.Module,
                 grads: Mapping[str, torch.Tensor], state: OptState
                 ) -> tuple[torch.nn.Module, OptState, dict]:
    """One AdamW step on ``params`` from ``grads`` (parameter name ->
    gradient); returns (params, state, {"grad_norm"}), all updated in
    place but the step counter."""
    named = list(params.named_parameters())
    placement = getattr(params, "placement", None)
    if placement is not None and placement.cut:
        gnorm = _mesh_norm(grads, [n for n, _ in named], placement)
    else:
        gnorm = global_norm(grads[n] for n, _ in named)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)
    for name, p in named:
        m, v = tree_leaf(state.m, name), tree_leaf(state.v, name)
        g32 = grads[name].float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        del g32
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        p32 = p.float()
        upd.add_(cfg.weight_decay * p32)
        p.copy_(p32 - cfg.lr * upd)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm}
