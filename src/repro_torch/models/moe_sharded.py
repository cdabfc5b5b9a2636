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

Each rank gathers only its own slots' weights from the expert stacks
(``launch.shardings``: the stacks stay whole on every rank, since a
replica slot may read an expert another rank would own); a contiguous run
of primary slots is a view, no copy.  Routing, capacity, the stable
dispatch sort and the combine order are ``models.moe``'s, so at one rank
this is ``moe_ffn`` with the same plan, plus an all-reduce.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .collectives import (all_reduce_replicated, axis_group, axis_rank,
                          axis_size, data_gather, data_shard)
from .common import ModelConfig
from .moe import MoE, _plan_tables, combine, route

__all__ = ["moe_ffn_sharded"]


@functools.lru_cache(maxsize=None)
def _slot_index(slots: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """A rank's slots' logical experts on ``dev``, made once per plan."""
    with torch.inference_mode(False):
        return torch.tensor(slots, dtype=torch.long, device=dev)


def _local_stacks(p: MoE, slots: tuple[int, ...], dev: torch.device):
    """(w1, w3, w2) of this rank's slots: a view for a contiguous run of
    experts, else a gather of those slots only."""
    lo = slots[0]
    if slots == tuple(range(lo, lo + len(slots))):
        return (p.w1[lo:lo + len(slots)], p.w3[lo:lo + len(slots)],
                p.w2[lo:lo + len(slots)])
    idx = _slot_index(slots, dev)
    return p.w1[idx], p.w3[idx], p.w2[idx]


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

    xl = data_shard(mesh, x, axis)
    bl, t, d = xl.shape
    n = bl * t
    dev = x.device
    xf = xl.reshape(n, d)
    top_w, top_e = route(p, xf, k)
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    if s > e:  # replica slots (hot experts) split load by token parity
        rep = _plan_tables(slots, e, dev)[0][flat_e].long()
        flat_slot = torch.where((rep >= 0) & (flat_t % 2 == 1), rep, flat_e)
    else:
        flat_slot = flat_e

    # keep only the assignments of this rank's slot range (s_loc = drop)
    local = (flat_slot >= lo) & (flat_slot < lo + s_loc)
    local_slot = torch.where(local, flat_slot - lo, s_loc)
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

    w1, w3, w2 = _local_stacks(p, slots_padded[lo:lo + s_loc], dev)
    xe = xf[tok] * valid[..., None].to(x.dtype)  # (S_loc, cap, D)
    h = F.silu(torch.bmm(xe, w1.to(x.dtype))) * torch.bmm(xe, w3.to(x.dtype))
    ye = torch.bmm(h, w2.to(x.dtype))
    out = combine(ye, wgt, local_slot, order, starts, cap, n, k)

    if p.shared is not None:
        # shared experts: tensor-parallel over `model`, summed by the same
        # all-reduce
        f, rest = divmod(p.shared.w1.shape[1], m)
        if rest:
            raise ValueError(f"shared width {p.shared.w1.shape[1]} does not "
                             f"split over {axis}'s {m} ranks")
        cols = slice(rank * f, (rank + 1) * f)
        g = F.silu(xf @ p.shared.w1[:, cols].to(x.dtype))
        u = xf @ p.shared.w3[:, cols].to(x.dtype)
        out = out + (g * u) @ p.shared.w2[cols].to(x.dtype)

    out = all_reduce_replicated(out, axis_group(mesh, axis))
    return data_gather(mesh, out.reshape(bl, t, d), axis)
