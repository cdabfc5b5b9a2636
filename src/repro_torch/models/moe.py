"""Mixture-of-Experts FFN: shared + routed top-k experts, capacity-based
sort dispatch, and AdHash-style hot-expert replication (DESIGN §2b).

PyTorch port of ``repro.models.moe`` (its expert-parallel dispatch over a
mesh is ``moe_sharded.py``).  Dispatch is the
static-shape sort/compaction pattern: assignments are sorted by expert slot
(a stable sort), each slot takes a contiguous chunk up to its capacity, and
surplus tokens are dropped and counted.  The hot-expert plan maps E logical
experts onto E + R slots; a replica of a hot expert takes the expert's
tokens of odd index, so the peak slot load drops.

Where the two packages would otherwise part:

* the top k come from a stable descending sort of the gates, so equal
  gates keep the lower expert first, as ``jax.lax.top_k`` does
  (``torch.topk`` promises no order);
* the capacity is the reference's own Python float expression;
* the expert weights are gathered by slot only under a plan (with none the
  gather is the identity, and copying the (S, D, F) stacks would cost a
  read and write of every expert's weights in every layer and step); under
  autograd a replica slot's gradient adds into its logical expert;
* the combine sums each token's (at most k) weighted expert outputs in the
  reference's order -- ascending slot position, in ``x.dtype``, from a
  per-token table -- so the result is deterministic on the card, where an
  ``index_add_`` would add bf16 rows by atomics in any order;
* the expert products are ``torch.bmm`` (batched over slots), so the
  "dots" remat policy (``transformer._DOTS``: ``mm``, ``addmm``) recomputes
  them and keeps the router and shared-expert products, as the reference's
  ``dots_with_no_batch_dims_saveable`` does.

No Pallas kernel is on this path: the products run on cuBLAS, the rest is
sort, searchsorted, gathers and adds.

On a mesh, ``moe_ffn`` computes what the reference's plain ``moe_ffn``
computes on the global batch under GSPMD:

* inside a data-parallel region (``collectives.data_parallel``) the
  routed part runs on the global batch (``gather_batch`` /
  ``shard_batch``), so capacity and drops are the global batch's;
* expert stacks that ``launch.shardings.place`` cut over ``model``
  (``MoE.tp``, a ``MoETP``) by experts make each rank compute its experts'
  slot rows (a replica slot with its expert's owner) of the one global
  dispatch; cut within each expert's hidden width, every rank computes
  every slot row over its share of the width.  Either way the experts'
  input enters through ``copy_to_parallel``, the routing weights too
  (each rank's combine uses only its part of them), and the combine's
  partial sums are all-reduced over ``model``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dataclasses import dataclass

from .collectives import (all_reduce_replicated, copy_to_parallel, dp_axes,
                          gather_batch, shard_batch)
from .common import ModelConfig, dense_init
from .mlp import SwiGLU, init_swiglu, swiglu

__all__ = ["MoE", "MoETP", "init_moe", "moe_ffn", "route", "combine",
           "slot_map_for_plan"]


@dataclass(frozen=True)
class MoETP:
    """How ``place`` cut a layer's expert stacks over ``model``: its group,
    its size and this rank's place on it, and ``by_experts`` (this rank's
    E / m experts, from ``rank * E / m``) or else each expert's hidden
    width (its F / m share)."""

    group: object
    m: int
    rank: int
    by_experts: bool


class MoE(nn.Module):
    """router (D, E), w1 and w3 (E, D, F), w2 (E, F, D), and with shared
    experts ``shared``, one SwiGLU of width n_shared * F.  ``moe_ffn``
    applies it.  ``tp`` a ``MoETP`` once placed cut."""

    tp = None

    def __init__(self, params: dict, shared: SwiGLU | None = None):
        super().__init__()
        for name in ("router", "w1", "w3", "w2"):
            setattr(self, name, nn.Parameter(params[name]))
        self.shared = shared


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype | None = None) -> MoE:
    mc = cfg.moe
    assert mc is not None
    d = cfg.d_model
    de = mc.d_expert or cfg.d_ff
    dt = dtype or cfg.pdtype
    p = {
        "router": dense_init(gen, (d, mc.n_experts), dt),
        "w1": dense_init(gen, (mc.n_experts, d, de), dt),
        "w3": dense_init(gen, (mc.n_experts, d, de), dt),
        "w2": dense_init(gen, (mc.n_experts, de, d), dt),
    }
    # shared experts fused into one dense SwiGLU of width n_shared * de
    shared = (init_swiglu(gen, cfg, d_ff=mc.n_shared * de, dtype=dt)
              if mc.n_shared else None)
    return MoE(p, shared)


def slot_map_for_plan(n_experts: int, hot_experts: tuple[int, ...]
                      ) -> tuple[int, ...]:
    """Static slot -> logical-expert map: E primary slots + one replica slot
    per hot expert (the LM 'replica index')."""
    return tuple(range(n_experts)) + tuple(hot_experts)


@functools.lru_cache(maxsize=None)
def _plan_tables(slots: tuple[int, ...], e: int, dev: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A plan's static lookup tables on ``dev``, made once per plan and
    device: each logical expert's replica slot (-1 where it has none) and
    each slot's logical expert.  Made outside inference mode, so autograd
    may save them in a later training step."""
    rep_slot = np.full(e, -1, np.int32)
    for si in range(e, len(slots)):
        rep_slot[slots[si]] = si
    with torch.inference_mode(False):
        return (torch.from_numpy(rep_slot).to(dev),
                torch.tensor(slots, dtype=torch.long, device=dev))


def route(p: MoE, xf: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, experts) (N, k) of each token's top k gates, renormalised;
    the lower expert first among equal gates (``jax.lax.top_k``)."""
    logits = (xf @ p.router.to(xf.dtype)).float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    return top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9), top_e


def _route_counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """float32 (n,) count of each value in ``ids`` (``torch.bincount``'s
    counts with minlength n, at a static shape)."""
    return torch.zeros(n, dtype=torch.float32, device=ids.device).index_add_(
        0, ids.reshape(-1).long(), torch.ones(ids.numel(), device=ids.device))


def combine(ye: torch.Tensor, wgt: torch.Tensor, flat_slot: torch.Tensor,
            order: torch.Tensor, starts: torch.Tensor, cap: int, n: int,
            k: int) -> torch.Tensor:
    """(N, D): each token's weighted expert outputs added in ascending slot
    position (the reference's scatter-add order), in ye's dtype.  ye (S,
    cap, D) and wgt (S, cap) by slot row; ``flat_slot`` (N * k) each
    assignment's slot, S for one this call does not compute; ``order`` the
    stable sort of ``flat_slot``, ``starts`` each slot's first place in it.
    An assignment in sorted place j of slot sl sits at position sl * cap +
    (j - starts[sl]) when that is below the slot's capacity."""
    s, _, d = ye.shape
    contrib = (ye * wgt[..., None].to(ye.dtype)).reshape(s * cap, d)
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])  # row s*cap: 0
    place = torch.empty_like(order)
    place[order] = torch.arange(n * k, device=ye.device)
    sl = flat_slot.long()
    in_slot = place - torch.cat([starts.long(), starts.new_zeros(1)])[sl]
    pos = torch.where((sl < s) & (in_slot < cap), sl * cap + in_slot,
                      s * cap)
    pos, _ = torch.sort(pos.reshape(n, k), dim=1)
    out = torch.zeros((n, d), dtype=ye.dtype, device=ye.device)
    for r in range(k):
        out = out + contrib[pos[:, r]]
    return out


def moe_ffn(
    p: MoE,
    x: torch.Tensor,  # (B, T, D)
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,  # replication plan (static)
) -> tuple[torch.Tensor, dict]:
    """Returns (out (B, T, D), diagnostics {dropped, expert_load,
    route_counts}); on a mesh, of the global batch (module docstring)."""
    dp = dp_axes()
    if dp is None:
        return _moe_ffn(p, x, cfg, slot_map)
    out, diag = _moe_ffn(p, gather_batch(*dp, x), cfg, slot_map)
    return shard_batch(*dp, out), diag


def _owned_slots(tp: MoETP | None, slots: tuple[int, ...], e: int
                 ) -> tuple[int, ...] | None:
    """The slots this rank computes (None: all of them)."""
    if tp is None or not tp.by_experts:
        return None
    e_loc = e // tp.m
    return tuple(si for si, ex in enumerate(slots) if ex // e_loc == tp.rank)


def _moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig,
             slot_map: tuple[int, ...] | None) -> tuple[torch.Tensor, dict]:
    mc = cfg.moe
    assert mc is not None
    b, t, d = x.shape
    n = b * t
    e = mc.n_experts
    k = mc.top_k
    dev = x.device
    slots = tuple(slot_map) if slot_map is not None else tuple(range(e))
    s = len(slots)
    tp = p.tp

    xf = x.reshape(n, d)
    top_w, top_e = route(p, xf, k)  # (N, k)
    if tp is not None:  # each rank's combine uses its part of the weights
        top_w = copy_to_parallel(top_w, tp.group)

    # ------- map logical experts to slots; replicas split load by parity
    flat_e = top_e.reshape(-1).to(torch.int32)  # (N*k,)
    flat_t = torch.arange(n, dtype=torch.int32,
                          device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    if slot_map is not None:
        rep_slot, slot_idx = _plan_tables(slots, e, dev)
    if s > e:
        # replica slot of each hot expert (static lookup table)
        rep = rep_slot[flat_e.long()]
        use_rep = (rep >= 0) & (flat_t % 2 == 1)
        flat_slot = torch.where(use_rep, rep, flat_e)
    else:
        flat_slot = flat_e

    # ------- capacity-based compaction (sorted dispatch)
    cap = int(np.ceil(n * k / s * mc.capacity_factor / 8.0) * 8)
    cap = max(cap, 8)
    order = torch.argsort(flat_slot, stable=True)
    se = flat_slot[order]
    st_ = flat_t[order].long()
    sw = flat_w[order]
    starts = torch.searchsorted(
        se, torch.arange(s, dtype=torch.int32, device=dev), out_int32=True)
    ends = torch.searchsorted(
        se, torch.arange(1, s + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    counts = ends - starts
    w1, w3, w2 = p.w1, p.w3, p.w2
    owned = _owned_slots(tp, slots, e)
    if owned is not None:  # this rank's slot rows of the global dispatch
        own = _slot_index(owned, dev)
        starts, ends = starts[own], ends[own]
        flat_slot = _local_table(owned, s, dev)[flat_slot.long()]
        first = tp.rank * (e // tp.m)
        ex = _slot_index(tuple(slots[si] - first for si in owned), dev)
        w1, w3, w2 = w1[ex], w3[ex], w2[ex]
    elif slot_map is not None:
        w1, w3, w2 = w1[slot_idx], w3[slot_idx], w2[slot_idx]
    idx = starts[:, None].long() + torch.arange(cap, device=dev)[None, :]
    valid = idx < ends[:, None]  # (S, cap)
    idx_c = torch.clamp(idx, max=n * k - 1)
    tok = st_[idx_c]  # (S, cap) token index per slot row
    wgt = torch.where(valid, sw[idx_c], 0.0)

    # ------- expert computation (batched products over stacked weights)
    xin = xf if tp is None else copy_to_parallel(xf, tp.group)
    xe = xin[tok] * valid[..., None].to(x.dtype)  # (S, cap, D)
    h = F.silu(torch.bmm(xe, w1.to(x.dtype))) * torch.bmm(xe, w3.to(x.dtype))
    ye = torch.bmm(h, w2.to(x.dtype))  # (S, cap, D)

    out = combine(ye, wgt, flat_slot, order, starts, cap, n, k)
    if tp is not None:
        out = all_reduce_replicated(out, tp.group)

    if p.shared is not None:
        out = out + swiglu(p.shared, xf)

    diag = {
        "dropped": torch.clamp(counts - cap, min=0).sum(),
        "expert_load": torch.clamp(counts, max=cap),
        # router aux statistics for the adaptive controller's heat map
        "route_counts": _route_counts(top_e, e),
    }
    return out.reshape(b, t, d), diag


@functools.lru_cache(maxsize=None)
def _local_table(owned: tuple[int, ...], s: int, dev: torch.device
                 ) -> torch.Tensor:
    """(S,) each slot's row among ``owned``, len(owned) for a slot this
    rank does not compute."""
    table = np.full(s, len(owned), np.int64)
    table[list(owned)] = np.arange(len(owned))
    with torch.inference_mode(False):
        return torch.from_numpy(table).to(dev)


@functools.lru_cache(maxsize=None)
def _slot_index(slots: tuple[int, ...], dev: torch.device) -> torch.Tensor:
    """A static index on ``dev``, made once (outside inference mode, so
    autograd may save it in a later training step)."""
    with torch.inference_mode(False):
        return torch.tensor(slots, dtype=torch.long, device=dev)
