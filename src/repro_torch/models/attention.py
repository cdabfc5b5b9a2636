"""GQA attention: prefill through the flash_attention kernel (global or
windowed, causal or not, with or without RoPE), cross-attention from
decoder states to encoder states, and single-token decode against a KV
cache (a ring buffer for windowed layers).

PyTorch port of ``repro.models.attention``.  Prefill and cross-attention
call ``repro_torch.kernels.flash_attention.ops.flash_attention``, which
launches the hand-written Hopper kernel on a CUDA tensor and runs its plain
version on a CPU tensor; it computes what ``_blocked_attn`` computes, the
hybrid family's local window included, and the audio family's
non-causal encoder and cross-attention (T queries against S != T keys).  Decode is plain PyTorch with float32
cache math, as the JAX package's decode is plain jnp; a windowed layer's
cache holds ``min(window, max_len)`` slots, written at ``pos % L`` and
masked by the reference's age rule (floor modulo, as ``jnp`` computes it).
Weights are stored as the JAX package stores them, (in, out), and cast to
the activations' dtype where used.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.backend import resolve_device
from repro_torch.kernels.flash_attention.ops import NEG_INF, flash_attention

from .common import (ModelConfig, apply_rope, dense_init, rope_tables,
                     unported)

__all__ = [
    "Attention",
    "init_attention",
    "attention",
    "cross_attention",
    "decode_attention",
    "init_kv_cache",
]

_PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


class Attention(nn.Module):
    """Projection weights of one attention layer: wq (D, H*hd), wk and wv
    (D, KV*hd), wo (H*hd, D), and with ``cfg.qkv_bias`` the biases bq, bk,
    bv."""

    def __init__(self, cfg: ModelConfig, params: dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        for name in _PARAMS:
            t = params.get(name)
            self.register_parameter(name, None if t is None else
                                    nn.Parameter(t))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return attention(self, x, self.cfg)


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype | None = None,
                   kv_heads: int | None = None) -> Attention:
    d, hd = cfg.d_model, cfg.hd
    nh = cfg.n_heads
    nkv = kv_heads if kv_heads is not None else cfg.n_kv_heads
    dt = dtype or cfg.pdtype
    p = {
        "wq": dense_init(gen, (d, nh * hd), dt),
        "wk": dense_init(gen, (d, nkv * hd), dt),
        "wv": dense_init(gen, (d, nkv * hd), dt),
        "wo": dense_init(gen, (nh * hd, d), dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", nh), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros((n * hd,), dtype=dt, device=gen.device)
    return Attention(cfg, p)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    """q (B, T, H, hd), k and v (B, T, KV, hd); KV from wk's width."""
    b, t, _ = x.shape
    hd = cfg.hd
    nkv = p.wk.shape[1] // hd
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return (q.reshape(b, t, cfg.n_heads, hd), k.reshape(b, t, nkv, hd),
            v.reshape(b, t, nkv, hd))


def attention(
    p: Attention,
    x: torch.Tensor,  # (B, T, D)
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: int = 0,
    use_rope: bool = True,
) -> torch.Tensor:
    """Self-attention over positions 0..T-1, for train and prefill: causal
    by default (the audio encoder's is not); with ``window > 0`` query t
    sees keys (t - window, t]; RoPE on q and k unless ``use_rope`` is
    False (whisper's learned positions)."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        cos, sin = rope_tables(torch.arange(t, device=x.device), cfg.hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return o.reshape(b, t, -1) @ p.wo.to(x.dtype)


def cross_attention(
    p: Attention,
    x: torch.Tensor,  # (B, T, D) decoder states
    kv: torch.Tensor,  # (B, S, D) encoder states
    cfg: ModelConfig,
) -> torch.Tensor:
    """Attention of T decoder positions over S encoder states: q from
    ``x``, k and v from ``kv`` (no bias, no RoPE, as the reference's), every
    key visible (non-causal)."""
    b, t, _ = x.shape
    s = kv.shape[1]
    hd = cfg.hd
    nkv = p.wk.shape[1] // hd
    q = (x @ p.wq.to(x.dtype)).reshape(b, t, cfg.n_heads, hd)
    k = (kv @ p.wk.to(x.dtype)).reshape(b, s, nkv, hd)
    v = (kv @ p.wv.to(x.dtype)).reshape(b, s, nkv, hd)
    o = flash_attention(q, k, v, causal=False)
    return o.reshape(b, t, -1) @ p.wo.to(x.dtype)


# ------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  int8: bool = False,
                  device: str | torch.device = "cuda") -> dict:
    """{"k", "v"}: (B, max_len, KV, hd) in the compute dtype, zero.  A
    windowed layer's caller passes ``min(window, max_len)`` slots."""
    if int8:
        raise unported("the int8 KV cache", "12d")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev)}


def decode_attention(
    p: Attention,
    x: torch.Tensor,  # (B, 1, D) current-token hidden state
    cache: dict,  # {"k","v"}: (B, L, KV, hd)
    pos: int | torch.Tensor,  # index of the current token
    cfg: ModelConfig,
    *,
    window: int = 0,
    use_rope: bool = True,
    f32_cache_math: bool = True,
) -> tuple[torch.Tensor, dict]:
    """One decode step: write K/V at ``pos``, attend to the cache.

    The cache keeps its static shape (B, L, KV, hd); positions > pos are
    masked.  With ``window > 0`` the cache is a ring buffer: the step writes
    slot ``pos % L`` and sees the slots the reference's age rule
    (``src/repro/models/attention.py:303-306``) lets through.  Unlike the
    JAX package (which returns a new cache), the port writes the new K/V
    into ``cache`` in place and returns it, so a decode step allocates no
    second cache."""
    if not f32_cache_math:
        raise unported("bf16 cache math (bf16_cache_math)", "12d")
    b = x.shape[0]
    hd = cfg.hd
    pos = int(pos)
    q, k, v = _project_qkv(p, x, cfg)  # (B, 1, H/KV, hd)
    nkv = k.shape[2]
    if use_rope:
        cos, sin = rope_tables(torch.full((1,), pos, device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = pos % L if window > 0 else pos  # ring buffer for local attention
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    g = cfg.n_heads // nkv
    qg = q.reshape(b, nkv, g, hd).float()
    logits = torch.einsum("bkgd,blkd->bkgl", qg, ck.float()) * (hd ** -0.5)
    idx = torch.arange(L, device=x.device)
    if window > 0:
        # the reference's distance in ring layout; floor modulo, as jnp's %
        age = pos - (torch.remainder(idx - slot - 1, L) + 1)
        visible = (age >= 0) & (age < window) & (age < pos + 1)
        visible = visible | (idx == slot)
    else:
        visible = idx <= pos
    logits = logits.masked_fill(~visible, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgl,blkd->bkgd", w, cv.float())
    o = o.reshape(b, 1, cfg.n_heads * hd).to(x.dtype)
    return o @ p.wo.to(x.dtype), cache
