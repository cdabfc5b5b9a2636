"""Token embedding, LM head, and AdHash-style adaptive hot-row replication
over a mesh.

PyTorch port of ``repro.models.embedding``.  The table is whole on one
device.  On a mesh, ``launch.shardings.place`` cuts it to this rank's rows
of the ``model`` axis (``Embedding.mesh`` then names the mesh), and the
plain lookup runs the lowering GSPMD gives the reference's row-sharded
table (masked local gathers and an all-reduce of the rows).  The LM head
is vocab-parallel there (``Embedding.head``, the ``model`` group, set by
``place`` where the head is cut): ``out`` holds this rank's columns, a
tied head this rank's rows of the table, each rank's logits are its
slice of the vocabulary, and ``lm_head`` gathers them over ``model``
only at its end (decode); the loss takes its log-sum-exp from the
per-rank logits (``transformer.chunked_nll``).

``adaptive_embed`` is the paper's IRD applied to embeddings: the hot rows
the controller chose are replicated on every rank (gathered from their
owners once a call), so hot tokens resolve locally; each rank serves the
cold tokens whose rows it owns, compacted to a static capacity
``cold_cap``, and the rows are all-gathered over ``model`` and
scatter-added.  Tokens past the capacity are reported as ``overflow``
(summed over the mesh), as the reference reports them.  The port keeps
activations replicated, so under a ``data`` axis above 1 each rank embeds
its batch shard and the batch is gathered back.  The collectives are
``models.collectives``' replicated-region ones, so the gradient of a loss every
rank computes reaches the table through both paths once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import (all_gather_replicated, all_reduce_mesh,
                          all_reduce_replicated, axis_group, axis_rank,
                          axis_size, copy_to_parallel, data_gather,
                          data_shard)
from .common import ModelConfig, dense_init

__all__ = ["Embedding", "init_embedding", "embed", "vocab_lookup", "lm_head",
           "head_weight", "gather_logits", "adaptive_embed"]


class Embedding(nn.Module):
    """table (V, D), or this rank's (V / m, D) rows once placed on a mesh
    (``mesh`` set); out (D, V) unless the config ties the head to the
    table, this rank's (D, V / m) columns once cut; ``head`` the ``model``
    group where the head is cut (vocab-parallel logits)."""

    head = None

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.table = nn.Parameter(params["table"])
        out = params.get("out")
        self.register_parameter("out", None if out is None else
                                nn.Parameter(out))
        self.mesh = None  # the mesh whose `model` axis shards the rows


def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None) -> Embedding:
    dt = dtype or cfg.pdtype
    p = {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                             scale=1.0)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return Embedding(p)


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, group
                 ) -> torch.Tensor:
    """(B, T) ids -> (B, T, D) rows of a table cut by rows over ``group``
    (this rank's block of rows): the masked local gather, all-reduced."""
    import torch.distributed as dist

    rows = table.shape[0]
    local = ids.long() - dist.get_rank(group) * rows
    own = (local >= 0) & (local < rows)
    got = F.embedding(local.clamp(0, rows - 1), table) * own[..., None]
    return all_reduce_replicated(got, group)


def embed(p: Embedding, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T) ids -> (B, T, D) rows in the compute dtype."""
    if p.mesh is None:
        return F.embedding(ids.long(), p.table).to(cfg.cdtype)
    return vocab_lookup(p.table, ids, axis_group(p.mesh, "model")
                        ).to(cfg.cdtype)


def head_weight(p: Embedding, cfg: ModelConfig) -> torch.Tensor:
    """The LM head's (D, V) weight: ``out``, or the tied table's transpose;
    where the head is cut (``p.head``), this rank's (D, V / m) columns."""
    return p.table.t() if cfg.tie_embeddings else p.out


def gather_logits(logits: torch.Tensor, group) -> torch.Tensor:
    """The whole vocabulary's logits from every rank's slice (the last
    dimension), in group-rank order."""
    if group is None:
        return logits
    g = all_gather_replicated(logits, group)  # (m, ..., V / m)
    return torch.cat(g.unbind(0), dim=-1)


def lm_head(p: Embedding, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T, D) -> (B, T, V) logits in h's dtype; a cut head's
    vocab-parallel logits are gathered over ``model``."""
    if p.head is not None:
        h = copy_to_parallel(h, p.head)
    return gather_logits(h @ head_weight(p, cfg).to(h.dtype), p.head)


def adaptive_embed(
    p: Embedding,
    ids: torch.Tensor,  # (B, T) ids, the same on every rank
    cfg: ModelConfig,
    hot_ids: tuple[int, ...],  # the replication plan (sorted)
    cold_cap: int,  # per-shard cold-exchange capacity
    mesh,
    axis: str = "model",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hot-replicated + cold-exchanged lookup.  Returns (emb (B, T, D) in
    the compute dtype, overflow: an int64 scalar, the cold tokens past
    ``cold_cap`` summed over the mesh).  ``p``'s table is whole or placed
    on ``mesh``; a world of one rank runs the same collectives."""
    if mesh is None:
        raise ValueError("adaptive_embed needs a mesh (launch.mesh."
                         "make_local_mesh); the plain lookup is embed")
    d = cfg.d_model
    m, rank = axis_size(mesh, axis), axis_rank(mesh, axis)
    group = axis_group(mesh, axis)
    if cfg.vocab_size % m:
        raise ValueError(f"vocab {cfg.vocab_size} does not split over "
                         f"{axis}'s {m} ranks")
    v_local = cfg.vocab_size // m
    dt = cfg.cdtype
    placed = p.mesh is not None
    tbl_l = (p.table if placed else
             p.table[rank * v_local:(rank + 1) * v_local])
    n_hot = len(hot_ids)
    dev = p.table.device

    # replica index: the hot rows, gathered from their owners once a call
    # (kept in the table's dtype and cast where looked up, which gives the
    # reference's values and sums a hot row's gradient in that dtype)
    if n_hot:
        hot_arr = torch.tensor(hot_ids, dtype=torch.long, device=dev)
        if placed:
            own = (hot_arr // v_local) == rank
            got = tbl_l[(hot_arr - rank * v_local).clamp(0, v_local - 1)]
            hot_tbl = all_reduce_replicated(got * own[:, None], group)
        else:
            hot_tbl = p.table[hot_arr]

    ids_l = data_shard(mesh, ids, axis)
    bl, tl = ids_l.shape
    flat = ids_l.reshape(-1).to(dev, torch.long)
    nl = flat.numel()

    # ---- hot path: local lookup in the replica table
    if n_hot:
        pos = torch.searchsorted(hot_arr, flat).clamp(0, n_hot - 1)
        is_hot = hot_arr[pos] == flat
        hot_out = hot_tbl[pos].to(dt) * is_hot[:, None].to(dt)
    else:
        is_hot = torch.zeros((nl,), dtype=torch.bool, device=dev)
        hot_out = torch.zeros((nl, d), dtype=dt, device=dev)

    # ---- cold path: each rank serves the cold rows it owns, compacted to
    # the capacity by a stable order of their positions (nl = no token)
    ar = torch.arange(nl, device=dev)
    mine = ((flat // v_local) == rank) & ~is_hot
    tokpos = torch.sort(torch.where(mine, ar, nl)).values[:cold_cap]
    valid = tokpos < nl
    local_row = (flat[tokpos.clamp(max=nl - 1)] - rank * v_local
                 ).clamp(0, v_local - 1)
    rows = tbl_l[local_row].to(dt) * valid[:, None].to(dt)
    over = torch.clamp(mine.sum() - cold_cap, min=0)

    # exchange: every rank needs every cold row (activations replicated)
    all_rows = all_gather_replicated(rows, group).reshape(-1, d)
    all_pos = all_gather_replicated(tokpos, group).reshape(-1)
    dest = torch.where(all_pos < nl, all_pos, nl)
    cold_out = torch.zeros((nl + 1, d), dtype=dt, device=dev).index_add(
        0, dest, all_rows)[:nl]
    out = data_gather(mesh, (hot_out + cold_out).reshape(bl, tl, d), axis)
    return out, all_reduce_mesh(over, mesh)
