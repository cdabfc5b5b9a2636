"""Gated MLP (SwiGLU), the dense family's feed-forward layer.

PyTorch port of ``repro.models.mlp`` (the whisper GeLU MLP waits for the
audio family, ROADMAP §1 item 12c).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, dense_init

__all__ = ["SwiGLU", "init_swiglu", "swiglu"]


class SwiGLU(nn.Module):
    """w1 (D, F) gate, w3 (D, F) up, w2 (F, D) down."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.w1 = nn.Parameter(params["w1"])
        self.w3 = nn.Parameter(params["w3"])
        self.w2 = nn.Parameter(params["w2"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(self, x)


def init_swiglu(gen: torch.Generator, cfg: ModelConfig,
                d_ff: int | None = None,
                dtype: torch.dtype | None = None) -> SwiGLU:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype or cfg.pdtype
    return SwiGLU({"w1": dense_init(gen, (d, f), dt),
                   "w3": dense_init(gen, (d, f), dt),
                   "w2": dense_init(gen, (f, d), dt)})


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = F.silu(x @ p.w1.to(x.dtype))
    u = x @ p.w3.to(x.dtype)
    return (g * u) @ p.w2.to(x.dtype)
