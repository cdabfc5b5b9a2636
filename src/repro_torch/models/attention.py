"""GQA attention: prefill through the flash_attention kernel (global or
windowed, causal or not, with or without RoPE), cross-attention from
decoder states to encoder states, and single-token decode against a KV
cache (a ring buffer for windowed layers).

PyTorch port of ``repro.models.attention``.  Prefill and cross-attention
call ``repro_torch.kernels.flash_attention.ops.flash_attention``, which
launches the hand-written Hopper kernel on a CUDA tensor and runs its plain
version on a CPU tensor; it computes what ``_blocked_attn`` computes, the
hybrid family's local window included, and the audio family's
non-causal encoder and cross-attention (T queries against S != T keys).
Decode is plain PyTorch, as the JAX package's decode is plain jnp, in the
reference's three cache modes: float32 cache math (the default), bf16
cache math (the cache in its dtype, float32 results) and the int8 cache
(a payload and per-(position, head) scales, dequantized on read); a
windowed layer's cache holds ``min(window, max_len)`` slots, written at
``pos % L`` and masked by the reference's age rule (floor modulo, as
``jnp`` computes it).
Weights are stored as the JAX package stores them, (in, out), and cast to
the activations' dtype where used.

A layer that ``launch.shardings.place`` cut over a mesh's ``model`` axis
(``Attention.tp``, an ``AttnTP``) runs tensor-parallel on whole heads: wq
(and bq) hold this rank's query heads' columns, wo their rows, and the
output projection's partial sums are all-reduced.  wk and wv (and bk, bv)
hold this rank's KV heads' columns where the KV heads split over the
axis; else they stay whole, every rank projects all KV heads and keeps
the ones its query heads read (the gradient of the whole projection is
summed over the axis).  Head counts are the local ones, taken from the
weights' widths.  Decode writes and reads this rank's KV heads of a
whole cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.core.backend import resolve_device
from repro_torch.kernels.flash_attention.ops import NEG_INF, flash_attention

from .collectives import all_reduce_replicated, copy_to_parallel
from .common import ModelConfig, apply_rope, dense_init, rope_tables

__all__ = [
    "AttnTP",
    "Attention",
    "init_attention",
    "attention",
    "cross_attention",
    "decode_attention",
    "init_kv_cache",
]

_PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


@dataclass(frozen=True)
class AttnTP:
    """How ``place`` cut a layer over ``model``: its group, and the KV
    heads [kv_lo, kv_hi) of the whole projection this rank's query heads
    read (``kv_cut``: wk and wv hold only those)."""

    group: object
    kv_cut: bool
    kv_lo: int
    kv_hi: int


class Attention(nn.Module):
    """Projection weights of one attention layer: wq (D, H*hd), wk and wv
    (D, KV*hd), wo (H*hd, D), and with ``cfg.qkv_bias`` the biases bq, bk,
    bv; ``tp`` an ``AttnTP`` once placed cut (H, and KV where cut, then
    this rank's heads)."""

    tp = None

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


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 kv: torch.Tensor | None = None, bias: bool = True):
    """q (B, T, H, hd) from ``x``, k and v (B, S, KV, hd) from ``kv``
    (default ``x``); H and KV from the weights' widths (a cut layer's
    local heads).  Biases where the layer has them, unless ``bias`` is
    False."""
    hd = cfg.hd
    tp = p.tp
    bq, bk, bv = (p.bq, p.bk, p.bv) if bias else (None, None, None)
    src = x if kv is None else kv
    x_in, src_in = x, src
    if tp is not None:
        x_in = copy_to_parallel(x, tp.group)
        src_in = x_in if kv is None else copy_to_parallel(kv, tp.group)
    q = _linear(x_in, p.wq, bq)
    if tp is None or tp.kv_cut:
        k, v = _linear(src_in, p.wk, bk), _linear(src_in, p.wv, bv)
    else:  # whole projection: keep the KV heads this rank's queries read
        lo, hi = tp.kv_lo * hd, tp.kv_hi * hd
        k = copy_to_parallel(_linear(src, p.wk, bk), tp.group)[..., lo:hi]
        v = copy_to_parallel(_linear(src, p.wv, bv), tp.group)[..., lo:hi]
    heads = lambda t: t.reshape(*t.shape[:2], -1, hd)
    return heads(q), heads(k), heads(v)


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None
            ) -> torch.Tensor:
    """x @ w (+ b), the weights cast to x's dtype."""
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def _out(p: Attention, o: torch.Tensor) -> torch.Tensor:
    """The output projection of (B, T, H, hd) heads, summed over ``model``
    when the layer is cut."""
    y = o.reshape(*o.shape[:2], -1) @ p.wo.to(o.dtype)
    return y if p.tp is None else all_reduce_replicated(y, p.tp.group)


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
    t = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        cos, sin = rope_tables(torch.arange(t, device=x.device), cfg.hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return _out(p, o)


def cross_attention(
    p: Attention,
    x: torch.Tensor,  # (B, T, D) decoder states
    kv: torch.Tensor,  # (B, S, D) encoder states
    cfg: ModelConfig,
) -> torch.Tensor:
    """Attention of T decoder positions over S encoder states: q from
    ``x``, k and v from ``kv`` (no bias, no RoPE, as the reference's), every
    key visible (non-causal)."""
    q, k, v = _project_qkv(p, x, cfg, kv=kv, bias=False)
    o = flash_attention(q, k, v, causal=False)
    return _out(p, o)


# ------------------------------------------------------------------- decode
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  int8: bool = False,
                  device: str | torch.device = "cuda") -> dict:
    """{"k", "v"}: (B, max_len, KV, hd) in the compute dtype, zero.  With
    ``int8`` the quantized cache: int8 ``k`` and ``v`` and float32
    per-(position, head) ``k_scale`` and ``v_scale`` (B, max_len, KV).  A
    windowed layer's caller passes ``min(window, max_len)`` slots."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    if int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:3], device=dev),
                "v_scale": torch.zeros(shape[:3], device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev)}


_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, 1, KV, hd) -> (int8 payload, float32 per-head scale (B, 1, KV)):
    the scale is max|x| / 127 floored at 1e-8, the payload x / scale
    rounded half to even and clipped to +-127.  The reference's compiled
    quotient by the constant 127 is max|x| times float32(1 / 127) (its
    scales are bit for bit that product, not the correctly rounded
    quotient), so the port multiplies by that float32 on both devices (a
    Python float that is exactly it: a product by a scalar rounds once on
    either device, and no tensor is copied to the card)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * _INV127
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b of bf16 operands with float32 results: on the card
    ``torch.bmm(out_dtype=float32)`` (cuBLAS accumulates in float32; no
    float32 copy of an operand is made); on the CPU, which has no such
    bmm, the products of the float32 casts (bf16 products are exact in
    float32, so only the order of the sums differs)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _bf16_cache_attend(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                       visible: torch.Tensor, hd: int) -> torch.Tensor:
    """The reference's ``f32_cache_math=False`` decode attention: both
    products take the cache in its own dtype with float32 results
    (``preferred_element_type``), the softmax weights are cast to the
    cache's dtype first.  q (B, H, hd); ck, cv (B, L, KV, hd); returns
    (B, H, hd) float32.

    The cache's batch of (b, kv-head) matrices has no single stride, so
    each product runs over all KV heads at once, batched over b: the
    scores as block-diagonal q (one head's hd columns a row, zeros
    elsewhere) against the cache viewed (L, KV * hd); the output as the
    weights against all KV heads' values, keeping each head's own block.
    The extra products are zeros (KV x the products, a few MFLOP a layer);
    the cache is read once, in place."""
    b, h, _ = q.shape
    L, nkv = ck.shape[1], ck.shape[2]
    g = h // nkv
    eye = torch.eye(nkv, dtype=q.dtype, device=q.device)
    q_blk = (q.reshape(b, nkv, g, 1, hd) * eye.reshape(1, nkv, 1, nkv, 1)
             ).reshape(b, h, nkv * hd)
    logits = _dot_f32(q_blk, ck.reshape(b, L, nkv * hd).transpose(1, 2))
    logits = logits * (hd ** -0.5)  # (B, H, L)
    logits = logits.masked_fill(~visible, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(cv.dtype)
    o_all = _dot_f32(w, cv.reshape(b, L, nkv * hd))  # (B, H, KV * hd)
    o = torch.diagonal(o_all.reshape(b, nkv, g, nkv, hd), dim1=1, dim2=3)
    return o.permute(0, 3, 1, 2).reshape(b, h, hd)


def _visible(L: int, pos: int, slot: int, window: int,
             device: torch.device) -> torch.Tensor:
    """(L,) mask of the cache slots the step at ``pos`` attends to."""
    idx = torch.arange(L, device=device)
    if window > 0:
        # the reference's distance in ring layout; floor modulo, as jnp's %
        age = pos - (torch.remainder(idx - slot - 1, L) + 1)
        visible = (age >= 0) & (age < window) & (age < pos + 1)
        return visible | (idx == slot)
    return idx <= pos


def decode_attention(
    p: Attention,
    x: torch.Tensor,  # (B, 1, D) current-token hidden state
    cache: dict,  # {"k","v"}: (B, L, KV, hd) [+ "k_scale","v_scale"]
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
    second cache.

    Cache math, as the reference's: an int8 cache (``k_scale`` in it) is
    dequantized on read, its scales factored out of the hd contraction and
    the payload cast to float32; else float32 math casts the cache to
    float32, and ``f32_cache_math=False`` keeps it in its dtype with
    float32 results (``_bf16_cache_attend``)."""
    b = x.shape[0]
    hd = cfg.hd
    pos = int(pos)
    q, k, v = _project_qkv(p, x, cfg)  # (B, 1, H/KV, hd)
    nh, nkv = q.shape[2], k.shape[2]
    whole = cache
    if p.tp is not None:  # this rank's KV heads of the whole cache
        cache = {name: t[:, :, p.tp.kv_lo:p.tp.kv_hi]
                 for name, t in cache.items()}
    if use_rope:
        cos, sin = rope_tables(torch.full((1,), pos, device=x.device), hd,
                               cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = pos % L if window > 0 else pos  # ring buffer for local attention
    visible = _visible(L, pos, slot, window, x.device)
    g = nh // nkv
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        ck[:, slot], cv[:, slot] = kq[:, 0], vq[:, 0]
        cks, cvs = cache["k_scale"], cache["v_scale"]
        cks[:, slot], cvs[:, slot] = ks[:, 0], vs[:, 0]
        qg = q.reshape(b, nkv, g, hd).float()
        # dequantize-on-read: scales factor out of the hd contraction
        raw = torch.einsum("bkgd,blkd->bkgl", qg, ck.float())
        logits = raw * cks.transpose(1, 2)[:, :, None, :] * (hd ** -0.5)
        logits = logits.masked_fill(~visible, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        wv = w * cvs.transpose(1, 2)[:, :, None, :]
        o = torch.einsum("bkgl,blkd->bkgd", wv, cv.float())
    elif f32_cache_math:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        qg = q.reshape(b, nkv, g, hd).float()
        logits = torch.einsum("bkgd,blkd->bkgl", qg, ck.float()) * \
            (hd ** -0.5)
        logits = logits.masked_fill(~visible, NEG_INF)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bkgl,blkd->bkgd", w, cv.float())
    else:
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        o = _bf16_cache_attend(q.reshape(b, nh, hd).to(ck.dtype),
                               ck, cv, visible, hd)
    return _out(p, o.reshape(b, 1, nh * hd).to(x.dtype)), whole
