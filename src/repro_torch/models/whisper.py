"""Whisper-style encoder-decoder (audio family).

PyTorch port of ``repro.models.whisper``.  As in the reference the conv/mel
frontend is a stub: the inputs carry precomputed frame embeddings (B,
n_frames, d_model).  The backbone is the real enc-dec transformer: a
bidirectional encoder, a causal decoder with cross-attention to the encoder
states, learned positional embeddings (no RoPE), pre-LayerNorm taken in
float32, GeLU MLPs, and a loss against the tied token embedding ``tok``.
Every attention of the model goes through the flash_attention kernels
(hd 64): the encoder's non-causal self-attention, the decoder's causal
self-attention, and cross-attention (T queries against the S = n_frames
encoder states), their backward too when training.

The layers are ``nn.ModuleList``s ``enc`` and ``dec`` walked in a Python
loop (the reference stacks them with ``vmap`` and scans;
``convert.params_from_numpy`` unstacks them), each under activation
checkpointing when ``cfg.remat`` asks for it and autograd records, as
``transformer._remat`` runs a block.  Decode carries one KV cache per
decoder layer, stacked as the reference stacks it, written in place; it
re-projects the cross-attention's K and V from ``enc`` at every step, as
the reference does.

On a mesh, ``launch.shardings.place`` cuts the model over ``model`` as the
reference's spec does: each attention (the encoder's, the decoder's self-
and cross-attention) on whole heads, as the dense family's
(``models.attention``; cross-attention projects K and V from ``enc`` with
the cut wk and wv), each GeLU MLP by w1's columns and w2's rows with its
biases whole (``models.mlp``), and the token table ``tok`` by rows where
the vocabulary divides (``Whisper.tok_tp``, the ``model`` group): the
lookup is then vocab-parallel, as ``embedding.vocab_lookup``, the loss
takes its log-sum-exp from the per-rank logits of the tied head
(``transformer.chunked_nll``), and decode gathers the logits over
``model`` at the end of a step.  ``enc_pos``, ``dec_pos`` and the norms
stay whole.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.backend import resolve_device

from . import attention as attn
from . import embedding as emb
from . import mlp as mlpm
from . import transformer as tfm
from .common import ModelConfig, dense_init

__all__ = [
    "LayerNorm",
    "EncLayer",
    "DecLayer",
    "Whisper",
    "init_whisper",
    "whisper_encode",
    "whisper_loss",
    "init_whisper_cache",
    "whisper_decode_step",
]


class LayerNorm(nn.Module):
    """g (D,), b (D,)."""

    def __init__(self, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.g = nn.Parameter(g)
        self.b = nn.Parameter(b)


def _layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                eps: float) -> torch.Tensor:
    """LayerNorm in float32, cast back to x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * g.float() + b.float()).to(x.dtype)


def _ln(norm: LayerNorm, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _layer_norm(x, norm.g, norm.b, cfg.norm_eps)


class EncLayer(nn.Module):
    """``ln1``, non-causal self-attention ``attn``, ``ln2``, GeLU ``mlp``."""

    def __init__(self, cfg: ModelConfig, ln1: LayerNorm,
                 attention: attn.Attention, ln2: LayerNorm,
                 mlp: mlpm.GeLUMLP):
        super().__init__()
        self.cfg = cfg
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attention, ln2, mlp

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + attn.attention(self.attn, _ln(self.ln1, h, cfg), cfg,
                               causal=False, use_rope=False)
        return h + mlpm.gelu_mlp(self.mlp, _ln(self.ln2, h, cfg))


class DecLayer(nn.Module):
    """``ln1``, causal self-attention ``self``, ``ln2``, cross-attention
    ``cross`` to the encoder states, ``ln3``, GeLU ``mlp`` (the reference's
    leaf names)."""

    def __init__(self, cfg: ModelConfig, ln1: LayerNorm,
                 self_attn: attn.Attention, ln2: LayerNorm,
                 cross: attn.Attention, ln3: LayerNorm, mlp: mlpm.GeLUMLP):
        super().__init__()
        self.cfg = cfg
        self.ln1, self.ln2, self.ln3 = ln1, ln2, ln3
        self.self = self_attn
        self.cross, self.mlp = cross, mlp

    def forward(self, h: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = h + attn.attention(self.self, _ln(self.ln1, h, cfg), cfg,
                               use_rope=False)
        h = h + attn.cross_attention(self.cross, _ln(self.ln2, h, cfg), enc,
                                     cfg)
        return h + mlpm.gelu_mlp(self.mlp, _ln(self.ln3, h, cfg))


class Whisper(nn.Module):
    """``enc_pos`` (n_frames, D), ``dec_pos`` (max_dec_len, D), the tied
    token embedding ``tok`` (V, D; this rank's rows once cut, ``tok_tp``
    then the ``model`` group), the layers ``enc`` and ``dec``, and the
    final norms ``ln_enc`` and ``ln_dec``."""

    tok_tp = None

    def __init__(self, cfg: ModelConfig, enc_pos: torch.Tensor,
                 dec_pos: torch.Tensor, tok: torch.Tensor,
                 enc: list[EncLayer], dec: list[DecLayer],
                 ln_enc: LayerNorm, ln_dec: LayerNorm):
        super().__init__()
        self.cfg = cfg
        self.enc_pos = nn.Parameter(enc_pos)
        self.dec_pos = nn.Parameter(dec_pos)
        self.tok = nn.Parameter(tok)
        self.enc = nn.ModuleList(enc)
        self.dec = nn.ModuleList(dec)
        self.ln_enc, self.ln_dec = ln_enc, ln_dec


def init_whisper(gen: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype | None = None,
                 max_dec_len: int = 4096) -> Whisper:
    """Random weights on ``gen``'s device, stored in ``dtype`` (default the
    config's param dtype)."""
    dt = dtype or cfg.pdtype
    d = cfg.d_model
    ln = lambda: LayerNorm(torch.ones((d,), dtype=dt, device=gen.device),
                           torch.zeros((d,), dtype=dt, device=gen.device))
    enc_pos = dense_init(gen, (cfg.encdec.n_frames, d), dt, scale=0.02)
    dec_pos = dense_init(gen, (max_dec_len, d), dt, scale=0.02)
    tok = dense_init(gen, (cfg.vocab_size, d), dt, scale=1.0)
    enc = [EncLayer(cfg, ln(), attn.init_attention(gen, cfg, dtype=dt), ln(),
                    mlpm.init_gelu_mlp(gen, cfg, dtype=dt))
           for _ in range(cfg.encdec.n_enc_layers)]
    dec = [DecLayer(cfg, ln(), attn.init_attention(gen, cfg, dtype=dt), ln(),
                    attn.init_attention(gen, cfg, dtype=dt), ln(),
                    mlpm.init_gelu_mlp(gen, cfg, dtype=dt))
           for _ in range(cfg.n_layers)]
    return Whisper(cfg, enc_pos, dec_pos, tok, enc, dec, ln(), ln())


def whisper_encode(p: Whisper, frames: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """frames: (B, F, D) stub embeddings -> encoder states (B, F, D)."""
    cd = cfg.cdtype
    x = frames.to(cd) + p.enc_pos[None, :frames.shape[1]].to(cd)
    for layer in p.enc:
        x = tfm._remat(layer, cfg)(x)
    return _ln(p.ln_enc, x, cfg)


def _decode_stack(p: Whisper, x: torch.Tensor, enc: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    for layer in p.dec:
        x = tfm._remat(layer, cfg)(x, enc)
    return _ln(p.ln_dec, x, cfg)


def _embed(p: Whisper, tokens: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    if p.tok_tp is not None:
        return emb.vocab_lookup(p.tok, tokens, p.tok_tp).to(cfg.cdtype)
    return p.tok[tokens.long()].to(cfg.cdtype)


def whisper_loss(
    p: Whisper,
    frames: torch.Tensor,  # (B, F, D) stub frame embeddings
    tokens: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T), -1 = masked
    cfg: ModelConfig,
    loss_chunk: int = 128,
) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over unmasked labels,
    float32, in chunks of ``loss_chunk`` positions against the tied token
    embedding."""
    enc = whisper_encode(p, frames, cfg)
    t = tokens.shape[1]
    x = _embed(p, tokens, cfg) + p.dec_pos[None, :t].to(cfg.cdtype)
    h = _decode_stack(p, x, enc, cfg)
    return tfm.chunked_nll(h, labels, p.tok.t().to(h.dtype), cfg, loss_chunk,
                           p.tok_tp)


def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int,
                       device: str | torch.device = "cuda") -> dict:
    """{"kv": {"k", "v"}}: each (n_layers, B, max_len, KV, hd) in the
    compute dtype, zero."""
    kv = attn.init_kv_cache(cfg, batch, max_len, device=resolve_device(device))
    return {"kv": tfm._stacked(kv, cfg.n_layers)}


def whisper_decode_step(
    p: Whisper,
    cache: dict,
    enc: torch.Tensor,  # (B, F, D) encoder states (from prefill)
    tokens: torch.Tensor,  # (B, 1)
    pos: int | torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One decode step.  Returns (logits (B, 1, V), cache) with the cache
    updated in place."""
    pos = int(pos)
    x = _embed(p, tokens, cfg) + p.dec_pos[None, pos:pos + 1].to(cfg.cdtype)
    ck, cv = cache["kv"]["k"], cache["kv"]["v"]
    for i, layer in enumerate(p.dec):
        y, _ = attn.decode_attention(layer.self, _ln(layer.ln1, x, cfg),
                                     {"k": ck[i], "v": cv[i]}, pos, cfg,
                                     use_rope=False)
        x = x + y
        x = x + attn.cross_attention(layer.cross, _ln(layer.ln2, x, cfg), enc,
                                     cfg)
        x = x + mlpm.gelu_mlp(layer.mlp, _ln(layer.ln3, x, cfg))
    x = _ln(p.ln_dec, x, cfg)
    return emb.gather_logits(x @ p.tok.t().to(x.dtype), p.tok_tp), cache
