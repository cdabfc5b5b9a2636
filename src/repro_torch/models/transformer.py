"""Decoder-only LM assembly for the dense and moe families.

PyTorch port of the dense and moe branches of ``repro.models.transformer``:

* the layers are an ``nn.ModuleList`` walked in a Python loop (the JAX
  package scans a stacked pytree; ``convert.params_from_numpy`` unstacks
  it);
* the LM-head cross-entropy is computed in sequence chunks so the (B, T, V)
  logits tensor never materializes (V is 128k for llama3-8b);
* decode carries one KV cache per layer, stacked as the JAX package stacks
  it, and writes it in place;
* a moe block swaps its SwiGLU for ``moe.MoE``; ``lm_forward``, ``lm_loss``
  and ``lm_decode_step`` take the hot-expert plan ``slot_map``, as the
  reference's do.

* with ``cfg.remat`` and grad enabled, each block and each loss chunk runs
  under non-reentrant activation checkpointing
  (``torch.utils.checkpoint``), as the reference wraps them in
  ``jax.checkpoint``: a block keeps only its input and recomputes the rest
  in the backward.  ``remat_policy == "dots"`` keeps the matrix products'
  outputs (``aten.mm`` / ``aten.addmm``), as
  ``dots_with_no_batch_dims_saveable`` does; the moe expert products are
  batched (``aten.bmm``) and recomputed.  Without grad (serving) the
  blocks run as they are.

The other families raise ``NotImplementedError`` naming their ROADMAP item,
the JAX package's mesh and cache options (``RuntimeOptions``) item 12d.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import embedding as emb
from . import mlp as mlpm
from . import moe as moem
from .common import ModelConfig, rms_norm, unported

__all__ = [
    "Block",
    "LM",
    "check_supported",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "init_lm_cache",
    "lm_decode_step",
]


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a family not ported yet."""
    if cfg.family not in ("dense", "moe"):
        raise unported(f"the {cfg.family!r} family ({cfg.name})", "12c")


# ------------------------------------------------------- remat (checkpoint)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under activation checkpointing when ``cfg.remat`` asks for it
    and autograd is recording; else ``fn`` itself.  The model draws no
    random numbers, so no RNG state is saved for the recompute."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kwargs = {}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _save_dots)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False, **kwargs)


# ------------------------------------------------------------------- blocks
class Block(nn.Module):
    """Pre-norm attention + FFN block: a SwiGLU ``mlp``, or in the moe
    family an ``moe.MoE`` named ``moe`` (the reference's leaf names)."""

    def __init__(self, cfg: ModelConfig, ln1: torch.Tensor,
                 ln2: torch.Tensor, attention: attn.Attention,
                 ffn: mlpm.SwiGLU | moem.MoE):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.attn = attention
        setattr(self, "moe" if cfg.moe is not None else "mlp", ffn)

    def ffn(self, z: torch.Tensor,
            slot_map: tuple[int, ...] | None = None) -> torch.Tensor:
        if self.cfg.moe is not None:
            return moem.moe_ffn(self.moe, z, self.cfg, slot_map)[0]
        return self.mlp(z)

    def forward(self, x: torch.Tensor,
                slot_map: tuple[int, ...] | None = None) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h = x + self.attn(rms_norm(x, self.ln1, eps))
        return h + self.ffn(rms_norm(h, self.ln2, eps), slot_map)


class LM(nn.Module):
    """Embedding, the blocks, and the final norm."""

    def __init__(self, cfg: ModelConfig, embed: emb.Embedding,
                 blocks: list[Block], ln_f: torch.Tensor):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = nn.Parameter(ln_f)


def init_lm(gen: torch.Generator, cfg: ModelConfig,
            dtype: torch.dtype | None = None) -> LM:
    """Random weights on ``gen``'s device, stored in ``dtype`` (default the
    config's param dtype; serving stores the compute dtype, which gives the
    same results since every weight is cast to it where used)."""
    check_supported(cfg)
    dt = dtype or cfg.pdtype
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    init_ffn = moem.init_moe if cfg.moe is not None else mlpm.init_swiglu
    blocks = [Block(cfg, ones(), ones(),
                    attn.init_attention(gen, cfg, dtype=dt),
                    init_ffn(gen, cfg, dtype=dt))
              for _ in range(cfg.n_layers)]
    return LM(cfg, emb.init_embedding(gen, cfg, dt), blocks, ones())


def lm_forward(
    params: LM,
    tokens: torch.Tensor,  # (B, T) ids
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,  # moe hot-expert plan
) -> torch.Tensor:
    """Returns final hidden states (B, T, D) after ln_f."""
    check_supported(cfg)
    x = emb.embed(params.embed, tokens, cfg)
    for block in params.blocks:
        x = _remat(block, cfg)(x, slot_map)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def _chunk_nll(hc: torch.Tensor, lc: torch.Tensor, w_out: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked NLL, count of unmasked labels) of one chunk."""
    logits = (hc @ w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def lm_loss(
    params: LM,
    tokens: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T), -1 = masked
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,
    loss_chunk: int = 128,
) -> torch.Tensor:
    """Mean next-token cross-entropy over unmasked labels, float32."""
    h = lm_forward(params, tokens, cfg, slot_map)
    w_out = (params.embed.table.t() if cfg.tie_embeddings
             else params.embed.out).to(h.dtype)
    t = h.shape[1]
    c = min(loss_chunk, t)
    chunk = _remat(_chunk_nll, cfg)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, t, c):
        nll, n = chunk(h[:, s:s + c], labels[:, s:s + c].long(), w_out)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


# ------------------------------------------------------------------- decode
def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: str | torch.device = "cuda") -> dict:
    """{"kv": {"k", "v"}}, each (n_layers, B, max_len, KV, hd) in the
    compute dtype, zero."""
    check_supported(cfg)
    kv = attn.init_kv_cache(cfg, batch, max_len, device=device)
    return {"kv": {name: t[None].repeat(cfg.n_layers, 1, 1, 1, 1)
                   for name, t in kv.items()}}


def lm_decode_step(
    params: LM,
    cache: dict,
    tokens: torch.Tensor,  # (B, 1) current token
    pos: int | torch.Tensor,  # position of the current token
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step.  Returns (logits (B, 1, V), cache) with the cache
    updated in place."""
    check_supported(cfg)
    x = emb.embed(params.embed, tokens, cfg)
    ck, cv = cache["kv"]["k"], cache["kv"]["v"]
    for i, block in enumerate(params.blocks):
        z = rms_norm(x, block.ln1, cfg.norm_eps)
        y, _ = attn.decode_attention(block.attn, z, {"k": ck[i], "v": cv[i]},
                                     pos, cfg)
        x = x + y
        z2 = rms_norm(x, block.ln2, cfg.norm_eps)
        x = x + block.ffn(z2, slot_map)  # moe: moe_ffn on (B, 1, D)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return emb.lm_head(params.embed, x, cfg), cache
