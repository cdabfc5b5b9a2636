"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

PyTorch port of ``repro.models.rglru``.  The block is

  x -> [gelu branch | conv1d -> RG-LRU branch] -> elementwise * -> out proj

with  a_t = exp(-c * softplus(Lambda) * r_t), r_t and i_t input-sigmoid
gates, h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t).

The linear recurrence over T is the reference's ``jax.lax.associative_scan``
written out in plain torch (``linear_scan``): the same odd/even recursion,
so the same tree of combines and the same roundings, in log2(T) levels of
whole-tensor ops (a Python loop over T = 4096 steps would cost a launch a
step on the card).  The GeLU is the tanh approximation, ``jax.nn.gelu``'s
default (``F.gelu``'s default is the exact form, 5e-4 away at x = -3).
Decode is one gated-recurrence step.  No Pallas kernel is on this path.

A block that ``launch.shardings.place`` cut over a mesh's ``model`` axis
(``RGLRU.tp``, the axis's group; the reference's spec) runs on this
rank's W / m channels: w_y, w_x, conv, w_i and w_r hold their columns,
lam its entries and w_o its rows.  The input enters through
``copy_to_parallel``; each rank computes its channels of the GeLU branch
and of the conv branch; the gate products read the whole conv output,
joined by ``all_gather_parallel`` (whose backward reduce-scatters the
gate products' partial gradients); the recurrence runs per channel, so
``linear_scan`` over a rank's channels gives the same bits as the whole
scan on them; and (h * y) @ w_o is summed over ``model``.  A cut block's
decode state holds this rank's channels of ``h`` and of the conv ring
(``init_rglru_state``'s ``width``); no rank reads another's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.backend import resolve_device

from .collectives import (all_gather_parallel, all_reduce_replicated,
                          copy_to_parallel)
from .common import ModelConfig, dense_init
from .ssm import causal_conv, softplus

__all__ = ["RGLRU", "init_rglru_block", "rglru_block", "init_rglru_state",
           "rglru_decode_step", "linear_scan"]

_C = 8.0
_PARAMS = ("w_y", "w_x", "conv", "w_i", "w_r", "lam", "w_o")


class RGLRU(nn.Module):
    """w_y and w_x (D, W), conv (4, W), w_i and w_r (W, W), lam (W,), w_o
    (W, D); ``tp`` the ``model`` group once placed cut (then W this rank's
    channels of the outputs and of w_o's rows)."""

    tp = None

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in _PARAMS:
            setattr(self, name, nn.Parameter(params[name]))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return rglru_block(self, u, self.cfg)


def _width(cfg: ModelConfig) -> int:
    return (cfg.hybrid.lru_width or cfg.d_model) if cfg.hybrid else \
        cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype | None = None) -> RGLRU:
    d, w = cfg.d_model, _width(cfg)
    dt = dtype or cfg.pdtype
    return RGLRU(cfg, {
        "w_y": dense_init(gen, (d, w), dt),  # gelu branch
        "w_x": dense_init(gen, (d, w), dt),  # recurrent branch
        "conv": dense_init(gen, (4, w), dt, scale=0.5),
        "w_i": dense_init(gen, (w, w), dt),  # input gate
        "w_r": dense_init(gen, (w, w), dt),  # recurrence gate
        "lam": torch.full((w,), 2.0, dtype=dt, device=gen.device),
        "w_o": dense_init(gen, (w, d), dt),
    })


def _gates(p: RGLRU, x: torch.Tensor, xg: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of this rank's channels ``x``; ``xg`` is the whole conv
    output the gate products read (``x`` itself when uncut)."""
    i = torch.sigmoid(xg @ p.w_i.to(x.dtype))
    r = torch.sigmoid(xg @ p.w_r.to(x.dtype))
    log_a = -_C * softplus(p.lam.float())[None, None, :] * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (
        i.float() * x.float())
    return a, b


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows even[0], odd[0], even[1], ... along dim 1 (``even`` has as many
    rows as ``odd`` or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], 1)


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of (a, b) along dim 1 under (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2): its b is h_t = a_t h_{t-1} + b_t from h_{-1} = 0.
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the half, then fill in the even rows from the odd ones."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = a[:, 1::2] * a[:, 0:-1:2], a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2]
    oa, ob = linear_scan(ra, rb)  # the odd rows of the scan
    if n % 2 == 0:
        oa_, ob_ = oa[:, :-1], ob[:, :-1]
    else:
        oa_, ob_ = oa, ob
    ea = torch.cat([a[:, :1], oa_ * a[:, 2::2]], dim=1)
    eb = torch.cat([b[:, :1], a[:, 2::2] * ob_ + b[:, 2::2]], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _whole(p: RGLRU, x: torch.Tensor) -> torch.Tensor:
    """The whole conv output from this rank's channels ``x``."""
    return x if p.tp is None else all_gather_parallel(x, p.tp, -1)


def _out(p: RGLRU, hy: torch.Tensor) -> torch.Tensor:
    """(h * y) @ w_o, summed over ``model`` when cut."""
    out = hy @ p.w_o.to(hy.dtype)
    return out if p.tp is None else all_reduce_replicated(out, p.tp)


def rglru_block(p: RGLRU, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """u: (B, T, D) -> (B, T, D)."""
    if p.tp is not None:
        u = copy_to_parallel(u, p.tp)
    y = F.gelu(u @ p.w_y.to(u.dtype), approximate="tanh")
    x = causal_conv(u @ p.w_x.to(u.dtype), p.conv.to(u.dtype))
    a, b = _gates(p, x, _whole(p, x))
    _, h = linear_scan(a, b)
    return _out(p, h.to(u.dtype) * y)


def init_rglru_state(cfg: ModelConfig, batch: int,
                     device: str | torch.device = "cuda",
                     width: int | None = None) -> dict:
    """{"conv": (B, 3, W) in the compute dtype, "h": (B, W) float32},
    zero; ``width`` a cut block's channels (default the config's W)."""
    w = width or _width(cfg)
    dev = resolve_device(device)
    return {"conv": torch.zeros((batch, 3, w), dtype=cfg.cdtype, device=dev),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=dev)}


def rglru_decode_step(p: RGLRU, u: torch.Tensor, state: dict,
                      cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """u: (B, 1, D) -> (y, new state); O(1) per token.  A cut block's
    state is its channels'."""
    y = F.gelu(u @ p.w_y.to(u.dtype), approximate="tanh")
    xc = u @ p.w_x.to(u.dtype)  # (B, 1, W)
    hist = torch.cat([state["conv"], xc.to(state["conv"].dtype)], dim=1)
    w = p.conv.to(u.dtype)
    x = torch.einsum("bkc,kc->bc", hist.to(u.dtype), w)[:, None, :]
    a, b = _gates(p, x, _whole(p, x))  # (B, 1, W) each
    h = a[:, 0] * state["h"] + b[:, 0]
    out = _out(p, h[:, None, :].to(u.dtype) * y)
    return out, {"conv": hist[:, 1:], "h": h}
