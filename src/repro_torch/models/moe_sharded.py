"""Expert-parallel MoE dispatch over a mesh's ``model`` axis.

PyTorch port of ``repro.models.moe_sharded``.  Every rank routes its
tokens (the batch is split over the data axes; the port keeps activations
replicated over ``model``), keeps the assignments that target ITS slots,
computes them at the local capacity, and the per-token combine is one
all-reduce over ``model`` -- the collective a tensor-parallel dense FFN
pays.  The hot-expert plan composes: the slot map gives each hot expert a
replica slot, which takes the expert's tokens of odd index, and the slots
are padded (with copies of the first) to a multiple of the axis.  The
shared experts run tensor-parallel over ``model``: each rank takes its
block of their hidden width, and the same all-reduce sums them.

Expert stacks whole on every rank (as the serving path kept them before
the stacks were cut): each rank gathers only its own slots' weights, a
contiguous run of primary slots as a view.  Stacks that
``launch.shardings.place`` cut by experts (``MoE.tp``): each rank computes
the primary slots of its own experts, and each replica slot where the
reference's layout puts it; the R hot experts' weights come from their
owners in one all-reduce a weight per call (``all_reduce_sum``, so a
replica's gradient reaches its owner), the stacks are never gathered.
Stacks cut within each expert's hidden width: every rank computes every
slot over its share of the width.  Each rank's products see only its
slots (or its share of the width), so the experts' input and the routing
weights enter through ``copy_to_parallel``.  Routing, capacity, the
stable dispatch sort and the combine order are ``models.moe``'s, so at
one rank this is ``moe_ffn`` with the same plan, plus an all-reduce.
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from .collectives import (all_reduce_replicated, all_reduce_sum,
                          axis_group, axis_rank, axis_size, copy_to_parallel,
                          data_gather, data_shard)
from .common import ModelConfig
from .mlp import swiglu
from .moe import MoE, _local_table, _plan_tables, _slot_index, combine, route

__all__ = ["moe_ffn_sharded"]


def _local_stacks(p: MoE, slots: tuple[int, ...], dev: torch.device):
    """(w1, w3, w2) of the logical experts ``slots`` from whole stacks (or
    stacks cut within the hidden width): a view for a contiguous run of
    experts, else a gather of those only."""
    lo = slots[0]
    if slots == tuple(range(lo, lo + len(slots))):
        return (p.w1[lo:lo + len(slots)], p.w3[lo:lo + len(slots)],
                p.w2[lo:lo + len(slots)])
    idx = _slot_index(slots, dev)
    return p.w1[idx], p.w3[idx], p.w2[idx]


def _owned_layout(p: MoE, slots_padded: tuple[int, ...], s: int, e: int,
                  m: int, rank: int, dev: torch.device):
    """Stacks cut by experts: (this rank's slots, their (w1, w3, w2)).  The
    primary slots of its own experts, then the replica slots the
    reference's layout gives it (``rank * s_loc`` on), whose experts come
    from their owners: one ``all_reduce_sum`` a weight, of the R hot
    experts only."""
    e_loc, s_loc = e // m, len(slots_padded) // m
    first = rank * e_loc
    mine = tuple(range(first, first + e_loc)) + tuple(
        si for si in range(e, s) if si // s_loc == rank)
    hot = tuple(slots_padded[e:s])
    stacks = [p.w1, p.w3, p.w2]
    if hot:
        own = torch.tensor([ex // e_loc == rank for ex in hot], device=dev)
        rows = _slot_index(tuple(ex % e_loc for ex in hot), dev)
        fetched = [all_reduce_sum(w[rows] * own.view(-1, 1, 1).to(w.dtype),
                                  p.tp.group) for w in stacks]
        pick = lambda si: (si - first if si < e else
                           e_loc + hot.index(slots_padded[si]))
        idx = _slot_index(tuple(pick(si) for si in mine), dev)
        stacks = [torch.cat([w, f])[idx] for w, f in zip(stacks, fetched)]
    return mine, stacks


def moe_ffn_sharded(
    p: MoE,
    x: torch.Tensor,  # (B, T, D), the same on every rank
    cfg: ModelConfig,
    mesh,
    slot_map: tuple[int, ...] | None = None,
    axis: str = "model",
) -> torch.Tensor:
    """(B, T, D): the MoE FFN with the slots split over ``axis``."""
    mc = cfg.moe
    assert mc is not None
    m, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    e, k = mc.n_experts, mc.top_k
    slots = tuple(slot_map) if slot_map is not None else tuple(range(e))
    s = len(slots)
    s_pad = -(-s // m) * m  # slots padded to a multiple of the axis
    slots_padded = slots + (slots[0],) * (s_pad - s)
    s_loc = s_pad // m
    lo = rank * s_loc
    group = axis_group(mesh, axis)

    xl = data_shard(mesh, x, axis)
    bl, t, d = xl.shape
    n = bl * t
    dev = x.device
    xf = xl.reshape(n, d)
    top_w, top_e = route(p, xf, k)
    top_w = copy_to_parallel(top_w, group)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    if s > e:  # replica slots (hot experts) split load by token parity
        rep = _plan_tables(slots, e, dev)[0][flat_e].long()
        flat_slot = torch.where((rep >= 0) & (flat_t % 2 == 1), rep, flat_e)
    else:
        flat_slot = flat_e

    # keep only the assignments of this rank's slots (their count = drop)
    if p.tp is not None and p.tp.by_experts:
        mine, (w1, w3, w2) = _owned_layout(p, slots_padded, s, e, m, rank,
                                           dev)
    else:
        mine = (tuple(range(s)) if p.tp is not None else
                tuple(range(lo, lo + s_loc)))
        w1, w3, w2 = _local_stacks(p, tuple(slots_padded[si] for si in mine),
                                   dev)
    s_loc = len(mine)
    local_slot = _local_table(mine, s_pad, dev)[flat_slot.long()]
    cap = int(np.ceil(n * k / s * mc.capacity_factor / 8.0) * 8)
    cap = max(cap, 8)
    order = torch.argsort(local_slot, stable=True)
    se = local_slot[order]
    st_ = flat_t[order]
    sw = flat_w[order]
    starts = torch.searchsorted(se, torch.arange(s_loc, device=dev))
    ends = torch.searchsorted(se, torch.arange(1, s_loc + 1, device=dev))
    idx = starts[:, None] + torch.arange(cap, device=dev)[None, :]
    valid = idx < ends[:, None]  # (S_loc, cap)
    idx_c = torch.clamp(idx, max=n * k - 1)
    tok = st_[idx_c]
    wgt = torch.where(valid, sw[idx_c], 0.0)

    xe = copy_to_parallel(xf, group)[tok] * valid[..., None].to(x.dtype)
    h = F.silu(torch.bmm(xe, w1.to(x.dtype))) * torch.bmm(xe, w3.to(x.dtype))
    ye = torch.bmm(h, w2.to(x.dtype))
    out = combine(ye, wgt, local_slot, order, starts, cap, n, k)

    if p.shared is not None and p.shared.tp is None:
        # shared experts: tensor-parallel over `model`, summed by the same
        # all-reduce (a placed cut already holds this rank's columns)
        f, rest = divmod(p.shared.w1.shape[1], m)
        if rest:
            raise ValueError(f"shared width {p.shared.w1.shape[1]} does not "
                             f"split over {axis}'s {m} ranks")
        cols = slice(rank * f, (rank + 1) * f)
        xs = copy_to_parallel(xf, group)
        g = F.silu(xs @ p.shared.w1[:, cols].to(x.dtype))
        u = xs @ p.shared.w3[:, cols].to(x.dtype)
        out = out + (g * u) @ p.shared.w2[cols].to(x.dtype)

    out = all_reduce_replicated(out, group)
    if p.shared is not None and p.shared.tp is not None:
        out = out + swiglu(p.shared, xf)
    return data_gather(mesh, out.reshape(bl, t, d), axis)
