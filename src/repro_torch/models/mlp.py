"""Gated MLP (SwiGLU), the dense family's feed-forward layer, and the
plain GeLU MLP of the audio family (whisper).

PyTorch port of ``repro.models.mlp``.  The GeLU is the tanh approximation,
``jax.nn.gelu``'s default (``F.gelu``'s default is the exact form).

A SwiGLU that ``launch.shardings.place`` cut over a mesh's ``model`` axis
(``SwiGLU.tp``, the axis's group: w1 and w3 by columns, w2 by rows) runs
tensor-parallel: the input enters through ``copy_to_parallel`` and the
row-parallel product's partial output is summed by
``all_reduce_replicated``.  A cut GeLU MLP (``GeLUMLP.tp``: w1 by
columns, w2 by rows) runs the same way, with the biases the reference's
spec keeps whole: each rank adds its slice of the whole b1, taken through
``copy_to_parallel`` so that b1's gradient (zero outside the slice on
each rank) is summed over the axis, and b2 is added once, after the sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .collectives import all_reduce_replicated, copy_to_parallel
from .common import ModelConfig, dense_init

__all__ = ["SwiGLU", "init_swiglu", "swiglu", "GeLUMLP", "init_gelu_mlp",
           "gelu_mlp"]


class SwiGLU(nn.Module):
    """w1 (D, F) gate, w3 (D, F) up, w2 (F, D) down; ``tp`` the ``model``
    group once placed cut (F then this rank's share)."""

    tp = None

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
    if p.tp is not None:
        x = copy_to_parallel(x, p.tp)
    g = F.silu(x @ p.w1.to(x.dtype))
    u = x @ p.w3.to(x.dtype)
    y = (g * u) @ p.w2.to(x.dtype)
    return y if p.tp is None else all_reduce_replicated(y, p.tp)


class GeLUMLP(nn.Module):
    """w1 (D, F), b1 (F,), w2 (F, D), b2 (D,); ``tp`` the ``model`` group
    once placed cut (w1's columns and w2's rows this rank's share, the
    biases whole)."""

    tp = None

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        for name in ("w1", "b1", "w2", "b2"):
            setattr(self, name, nn.Parameter(params[name]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu_mlp(self, x)


def init_gelu_mlp(gen: torch.Generator, cfg: ModelConfig,
                  d_ff: int | None = None,
                  dtype: torch.dtype | None = None) -> GeLUMLP:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    dt = dtype or cfg.pdtype
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=gen.device)
    return GeLUMLP({"w1": dense_init(gen, (d, f), dt), "b1": zeros(f),
                    "w2": dense_init(gen, (f, d), dt), "b2": zeros(d)})


def gelu_mlp(p: GeLUMLP, x: torch.Tensor) -> torch.Tensor:
    b1 = p.b1
    if p.tp is not None:
        import torch.distributed as dist

        x = copy_to_parallel(x, p.tp)
        f = p.w1.shape[1]
        b1 = copy_to_parallel(b1, p.tp).narrow(
            0, dist.get_rank(p.tp) * f, f)
    h = F.gelu(x @ p.w1.to(x.dtype) + b1.to(x.dtype), approximate="tanh")
    y = h @ p.w2.to(x.dtype)
    if p.tp is not None:
        y = all_reduce_replicated(y, p.tp)
    return y + p.b2.to(x.dtype)
