"""Token embedding and LM head.

PyTorch port of the single-device half of ``repro.models.embedding``: the
plain lookup and the head.  The adaptive hot-row replication
(``adaptive_embed``) needs a device mesh and waits for ROADMAP §1 item 12d.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init, unported

__all__ = ["Embedding", "init_embedding", "embed", "lm_head",
           "adaptive_embed"]


class Embedding(nn.Module):
    """table (V, D); out (D, V) unless the config ties the head to the
    table."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.table = nn.Parameter(params["table"])
        out = params.get("out")
        self.register_parameter("out", None if out is None else
                                nn.Parameter(out))


def init_embedding(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None) -> Embedding:
    dt = dtype or cfg.pdtype
    p = {"table": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                             scale=1.0)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return Embedding(p)


def embed(p: Embedding, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T) ids -> (B, T, D) rows in the compute dtype."""
    return F.embedding(ids.long(), p.table).to(cfg.cdtype)


def lm_head(p: Embedding, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(B, T, D) -> (B, T, V) logits in h's dtype."""
    if cfg.tie_embeddings:
        return h @ p.table.t().to(h.dtype)
    return h @ p.out.to(h.dtype)


def adaptive_embed(*args, **kwargs):
    raise unported("adaptive_embed (hot-row replication over a mesh)", "12d")
