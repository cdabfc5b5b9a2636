"""Mamba-2 SSD (state-space duality) mixer: the chunked parallel form for
prefill and training, and the constant-memory recurrent decode step.

PyTorch port of ``repro.models.ssm`` (arXiv:2405.21060).  The chunked form
keeps the reference's structure: the quadratic attention-like form inside a
chunk of ``cfg.ssm.chunk`` steps, with the (B, L, L, H) intra-chunk gate as
the peak working set, and a sequential loop over the chunks carrying the
(B, H, N, P) float32 state, as the reference's ``lax.scan`` does.  Where the
two packages would otherwise part:

* the gate is ``exp`` of the log-decay with the entries above the diagonal
  set to -inf first, where the reference takes ``where(causal, exp(decay),
  0)``: above the diagonal the decay is positive and its ``exp`` can
  overflow, and the backward of ``where`` would then multiply 0 by inf.
  The forward is the same;
* softplus is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it
  (``F.softplus`` returns x itself past 20);
* the depthwise causal conv adds its K taps in the activation dtype in the
  reference's order.

No Pallas kernel is on this path: the products run on cuBLAS, the rest is
elementwise.  Weights are stored (in, out), as the reference stores them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.backend import resolve_device

from .common import ModelConfig, dense_init, rms_norm

__all__ = ["SSM", "init_ssm", "ssm_mixer", "init_ssm_state",
           "ssm_decode_step", "softplus", "causal_conv"]

_PARAMS = ("in_proj", "conv", "A_log", "D", "dt_bias", "norm_g", "out_proj")


class SSM(nn.Module):
    """in_proj (D, 2*d_inner + 2*N + H) -> [z, x, B, C, dt], conv (K,
    d_inner), A_log, D and dt_bias (H,), norm_g (d_inner,), out_proj
    (d_inner, D)."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in _PARAMS:
            setattr(self, name, nn.Parameter(params[name]))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        return ssm_mixer(self, u, self.cfg)


def _dims(cfg: ModelConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return sc, d_inner, d_inner // sc.head_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype | None = None) -> SSM:
    sc, d_inner, nh = _dims(cfg)
    d = cfg.d_model
    dt = dtype or cfg.pdtype
    dev = gen.device
    proj_out = 2 * d_inner + 2 * sc.d_state + nh
    return SSM(cfg, {
        "in_proj": dense_init(gen, (d, proj_out), dt),
        "conv": dense_init(gen, (sc.d_conv, d_inner), dt, scale=0.5),
        "A_log": torch.zeros((nh,), dtype=dt, device=dev),  # A = -exp(A_log)
        "D": torch.ones((nh,), dtype=dt, device=dev),
        "dt_bias": torch.full((nh,), -2.0, dtype=dt, device=dev),
        "norm_g": torch.ones((d_inner,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (d_inner, d), dt),
    })


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, at every x."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along T.  x: (B, T, C); w: (K, C), in x's
    dtype; the taps are added in order, in that dtype."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + t] * w[i][None, None, :]
    return out


def _split_proj(p: SSM, u: torch.Tensor, cfg: ModelConfig):
    sc, d_inner, _ = _dims(cfg)
    zxbcdt = u @ p.in_proj.to(u.dtype)
    n = sc.d_state
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:2 * d_inner],
            zxbcdt[..., 2 * d_inner:2 * d_inner + n],
            zxbcdt[..., 2 * d_inner + n:2 * d_inner + 2 * n],
            zxbcdt[..., 2 * d_inner + 2 * n:])


def _chunks(x: torch.Tensor, pad: int, shape: tuple[int, ...]
            ) -> torch.Tensor:
    """(B, T, ...) zero-padded on T by ``pad`` and reshaped to ``shape``."""
    spec = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, spec).reshape(shape)


def ssm_mixer(p: SSM, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Chunked SSD forward.  u: (B, T, D) -> (B, T, D).

    Recurrence per head h with state S_t in R^{P x N} (P = head_dim, N =
    d_state): S_t = a_t S_{t-1} + dt_t x_t (x) B_t; y_t = S_t C_t + D x_t,
    with a_t = exp(dt_t A).  Chunk-local terms use the quadratic dual
    form."""
    sc, d_inner, nh = _dims(cfg)
    b, t, _ = u.shape
    hd = sc.head_dim
    L = min(sc.chunk, t)
    nchunk = -(-t // L)
    pad = nchunk * L - t

    z, x, bmat, cmat, dt = _split_proj(p, u, cfg)
    x = F.silu(causal_conv(x, p.conv.to(x.dtype)))
    dt = softplus(dt.float() + p.dt_bias.float())  # (B, T, H)
    a_log = -torch.exp(p.A_log.float())  # (H,) negative
    loga = dt * a_log[None, None, :]  # (B, T, H) log-decay <= 0

    xh = _chunks(x, pad, (b, nchunk, L, nh, hd))
    bm = _chunks(bmat, pad, (b, nchunk, L, -1))
    cm = _chunks(cmat, pad, (b, nchunk, L, -1))
    dtp = _chunks(dt, pad, (b, nchunk, L, nh))
    lg = _chunks(loga, pad, (b, nchunk, L, nh))

    cum = torch.cumsum(lg, dim=2)  # (B, C, L, H) inclusive
    xs = xh.float() * dtp[..., None]  # dt-scaled inputs
    above = ~torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=u.device))

    # one chunk per step: the (B, L, L, H) gate is the peak working set
    h = torch.zeros((b, nh, sc.d_state, hd), dtype=torch.float32,
                    device=u.device)
    ys = []
    for c in range(nchunk):
        xs_c, cum_c = xs[:, c], cum[:, c]  # (B, L, H, P), (B, L, H)
        bm32, cm32 = bm[:, c].float(), cm[:, c].float()  # (B, L, N)
        scores = torch.einsum("bln,bmn->blm", cm32, bm32)
        decay = cum_c[:, :, None, :] - cum_c[:, None, :, :]  # (B, L, L, H)
        gate = torch.exp(decay.masked_fill(above[None, :, :, None],
                                           float("-inf")))
        y_intra = torch.einsum("blmh,bmhp->blhp", scores[..., None] * gate,
                               xs_c)
        y_inter = torch.einsum("bln,bhnp->blhp", cm32, h) * \
            torch.exp(cum_c)[..., None]
        dec_end = torch.exp(cum_c[:, -1:, :] - cum_c)  # (B, L, H)
        state = torch.einsum("bln,blhp->bhnp", bm32,
                             xs_c * dec_end[..., None])
        h = h * torch.exp(cum_c[:, -1])[..., None, None] + state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nchunk * L, nh, hd)[:, :t]
    y = y + x.float().reshape(b, t, nh, hd) * p.D.float()[None, None, :, None]
    y = y.reshape(b, t, d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm_g, cfg.norm_eps)
    return y @ p.out_proj.to(u.dtype)


# ------------------------------------------------------------------- decode
def init_ssm_state(cfg: ModelConfig, batch: int,
                   device: str | torch.device = "cuda") -> dict:
    """{"conv": (B, K-1, d_inner) in the compute dtype, "ssm": (B, H, N, P)
    float32}, zero."""
    sc, d_inner, nh = _dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, sc.d_conv - 1, d_inner),
                            dtype=cfg.cdtype, device=dev),
        "ssm": torch.zeros((batch, nh, sc.d_state, sc.head_dim),
                           dtype=torch.float32, device=dev),
    }


def ssm_decode_step(p: SSM, u: torch.Tensor, state: dict, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """u: (B, 1, D) -> (y (B, 1, D), new state).  O(1) in context length."""
    sc, d_inner, nh = _dims(cfg)
    b = u.shape[0]
    hd = sc.head_dim
    z, x, bmat, cmat, dt = _split_proj(p, u, cfg)

    # conv ring buffer: history (B, K-1, C) + current
    hist = torch.cat([state["conv"], x.to(state["conv"].dtype)], dim=1)
    w = p.conv.to(x.dtype)  # (K, C)
    xc = F.silu(torch.einsum("bkc,kc->bc", hist.to(x.dtype), w)[:, None, :])

    dtf = softplus(dt.float() + p.dt_bias.float())[:, 0]  # (B, H)
    a = torch.exp(dtf * (-torch.exp(p.A_log.float()))[None, :])
    xs = xc.float().reshape(b, nh, hd) * dtf[..., None]
    bm = bmat.float()[:, 0]  # (B, N)
    cm = cmat.float()[:, 0]
    new_ssm = state["ssm"] * a[..., None, None] + \
        torch.einsum("bn,bhp->bhnp", bm, xs)
    y = torch.einsum("bn,bhnp->bhp", cm, new_ssm)
    y = y + xc.float().reshape(b, nh, hd) * p.D.float()[None, :, None]
    y = y.reshape(b, 1, d_inner).to(u.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, p.norm_g, cfg.norm_eps)
    return y @ p.out_proj.to(u.dtype), {"conv": hist[:, 1:], "ssm": new_ssm}
