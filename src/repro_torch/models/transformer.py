"""Decoder-only LM assembly for the dense, moe, ssm, hybrid and vlm
families.

PyTorch port of ``repro.models.transformer``:

* the layers are an ``nn.ModuleList`` walked in a Python loop (the JAX
  package scans a stacked pytree; ``convert.params_from_numpy`` unstacks
  it);
* the LM-head cross-entropy is computed in sequence chunks so the (B, T, V)
  logits tensor never materializes (V is 128k for llama3-8b);
* decode carries one KV cache per layer, stacked as the JAX package stacks
  it, and writes it in place;
* a moe block swaps its SwiGLU for ``moe.MoE``; ``lm_forward``, ``lm_loss``
  and ``lm_decode_step`` take the hot-expert plan ``slot_map``, as the
  reference's do;
* an ssm block is ``ln1`` and the Mamba-2 mixer (``ssm.SSM``), no MLP; its
  decode cache is each layer's conv ring and float32 state;
* the hybrid family (RecurrentGemma) is ``groups`` of three sub-blocks,
  ``rec1``, ``rec2`` (RG-LRU) and ``attn`` (local attention over
  ``cfg.hybrid.window`` keys), each with ``ln1``, ``mixer``, ``ln2`` and a
  SwiGLU ``mlp``, then a ``tail`` of ``n_layers % 3`` recurrent
  sub-blocks; remat covers a whole group, as the reference checkpoints the
  group (the tail runs as it is); its decode cache holds each group's two
  recurrent states and its attention ring of ``min(window, max_len)``
  slots;
* ``lm_forward`` and ``lm_loss`` take ``inputs_embeds``, embeddings put
  before the tokens' (the vlm family's projected patches); the loss is
  taken over the text positions only.

* with ``cfg.remat`` and grad enabled, each block and each loss chunk runs
  under non-reentrant activation checkpointing
  (``torch.utils.checkpoint``), as the reference wraps them in
  ``jax.checkpoint``: a block keeps only its input and recomputes the rest
  in the backward.  ``remat_policy == "dots"`` keeps the matrix products'
  outputs (``aten.mm`` / ``aten.addmm``), as
  ``dots_with_no_batch_dims_saveable`` does; the moe expert products are
  batched (``aten.bmm``) and recomputed.  Without grad (serving) the
  blocks run as they are.

* ``RuntimeOptions`` are the reference's mesh and cache options, threaded
  as the reference threads them: ``lm_forward`` embeds through
  ``embedding.adaptive_embed`` (``adaptive_embedding``, on ``mesh``, with
  ``hot_ids`` and a capacity from ``cold_frac``) and a moe block runs
  ``moe_sharded.moe_ffn_sharded`` (``sharded_moe``, with ``opts.slot_map
  or slot_map``); ``init_lm_cache`` makes the int8 cache
  (``kv_cache_int8``, dense and moe only) and ``lm_decode_step`` keeps the
  cache math in bf16 (``bf16_cache_math``).  Decode embeds and runs the
  moe blocks without them, as the reference's does.  ``opts=None`` is the
  program without options.  As in the reference, ``lm_forward`` drops
  ``adaptive_embed``'s overflow (ROADMAP §3): a caller that must know
  calls ``adaptive_embed`` itself with the same capacity
  (``cold_capacity``).

* on a mesh whose ``model`` axis cuts the LM head (``embedding.Embedding.
  head``), the loss is vocab-parallel: ``chunked_nll`` takes each rank's
  logits of its vocabulary slice, the log-sum-exp from their all-reduced
  max and sum of exps, the gold logit from its owner; decode gathers the
  logits at the end of a step.  On an axis of one rank nothing is cut and
  the program is the one without a mesh, bit for bit.

The audio family (whisper) is an encoder-decoder of its own
(``models.whisper``), which uses this module's remat and chunked loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import embedding as emb
from . import mlp as mlpm
from . import moe as moem
from . import moe_sharded as moesh
from . import rglru as rg
from . import ssm as ssmm
from .collectives import (all_reduce_max, all_reduce_replicated, axis_size,
                          copy_to_parallel, data_sum, dp_blocks)
from .common import ModelConfig, rms_norm

__all__ = [
    "RuntimeOptions",
    "cold_capacity",
    "Block",
    "SSMBlock",
    "HybridSub",
    "HybridGroup",
    "LM",
    "check_supported",
    "init_lm",
    "lm_forward",
    "lm_loss",
    "hidden_loss",
    "chunked_nll",
    "init_lm_cache",
    "lm_decode_step",
]


#: the JAX package's model families, all ported
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a family the JAX package does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name}); "
                         f"known: {FAMILIES}")


@dataclass(frozen=True)
class RuntimeOptions:
    """The reference's optimization switches; the defaults are the program
    without them."""

    mesh: object = None  # launch.mesh's DeviceMesh (adaptive / sharded paths)
    sharded_moe: bool = False  # EP dispatch over `model` (moe_sharded.py)
    adaptive_embedding: bool = False  # AdHash hot-row replication
    hot_ids: tuple[int, ...] = ()  # embedding replication plan (sorted)
    cold_frac: float = 1.0  # static cold-exchange capacity fraction
    bf16_cache_math: bool = False  # decode: no f32 cast of the KV cache
    kv_cache_int8: bool = False  # decode: quantized KV cache (s8 + scales)
    slot_map: tuple[int, ...] | None = None  # hot-expert replication plan


def cold_capacity(opts: RuntimeOptions, tokens: torch.Tensor) -> int:
    """The per-shard cold-exchange capacity ``lm_forward`` gives
    ``adaptive_embed``: max(8, B * T * cold_frac / model) of the global
    batch, as the reference computes it (inside a data-parallel region
    ``tokens`` is this rank's block of it)."""
    per_shard = tokens.shape[0] * tokens.shape[1] * dp_blocks()
    return max(8, int(per_shard * opts.cold_frac
                      / axis_size(opts.mesh, "model")))


# ------------------------------------------------------- remat (checkpoint)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, cfg: ModelConfig, policy: str | None = None):
    """``fn`` under activation checkpointing when ``cfg.remat`` asks for it
    and autograd is recording; else ``fn`` itself.  ``policy`` (default
    ``cfg.remat_policy``): "full" or "dots".  The model draws no random
    numbers, so no RNG state is saved for the recompute."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    kwargs = {}
    if (policy or cfg.remat_policy) == "dots":
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
            slot_map: tuple[int, ...] | None = None,
            opts: RuntimeOptions | None = None) -> torch.Tensor:
        if self.cfg.moe is not None:
            if opts is not None and opts.sharded_moe:
                return moesh.moe_ffn_sharded(
                    self.moe, z, self.cfg, opts.mesh,
                    slot_map=opts.slot_map or slot_map)
            return moem.moe_ffn(self.moe, z, self.cfg, slot_map)[0]
        return self.mlp(z)

    def forward(self, x: torch.Tensor,
                slot_map: tuple[int, ...] | None = None,
                opts: RuntimeOptions | None = None) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h = x + self.attn(rms_norm(x, self.ln1, eps))
        return h + self.ffn(rms_norm(h, self.ln2, eps), slot_map, opts)


class SSMBlock(nn.Module):
    """Pre-norm Mamba-2 block: ``ln1`` and the mixer ``ssm``, no FFN."""

    def __init__(self, cfg: ModelConfig, ln1: torch.Tensor, ssm: ssmm.SSM):
        super().__init__()
        self.cfg = cfg
        self.ln1 = nn.Parameter(ln1)
        self.ssm = ssm

    def forward(self, x: torch.Tensor,
                slot_map: tuple[int, ...] | None = None,
                opts: RuntimeOptions | None = None) -> torch.Tensor:
        return x + self.ssm(rms_norm(x, self.ln1, self.cfg.norm_eps))


class HybridSub(nn.Module):
    """One hybrid sub-block: ``ln1``, the ``mixer`` (an RG-LRU block for
    kind "rec", windowed attention for "attn"), ``ln2`` and a SwiGLU
    ``mlp``."""

    def __init__(self, cfg: ModelConfig, kind: str, ln1: torch.Tensor,
                 mixer: rg.RGLRU | attn.Attention, ln2: torch.Tensor,
                 mlp: mlpm.SwiGLU):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.ln1 = nn.Parameter(ln1)
        self.mixer = mixer
        self.ln2 = nn.Parameter(ln2)
        self.mlp = mlp

    def mix(self, z: torch.Tensor) -> torch.Tensor:
        if self.kind == "rec":
            return rg.rglru_block(self.mixer, z, self.cfg)
        return attn.attention(self.mixer, z, self.cfg,
                              window=self.cfg.hybrid.window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        h = x + self.mix(rms_norm(x, self.ln1, eps))
        return h + self.mlp(rms_norm(h, self.ln2, eps))


class HybridGroup(nn.Module):
    """(rec, rec, local attention): sub-blocks ``rec1``, ``rec2``,
    ``attn``."""

    def __init__(self, rec1: HybridSub, rec2: HybridSub, attn_: HybridSub):
        super().__init__()
        self.rec1, self.rec2, self.attn = rec1, rec2, attn_

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn(self.rec2(self.rec1(x)))


class LM(nn.Module):
    """Embedding, the layers, and the final norm.  The layers are
    ``blocks`` (``Block`` or ``SSMBlock``), or for the hybrid family
    ``groups`` (``HybridGroup``) and ``tail`` (``HybridSub``); the vlm
    family adds a ``projector`` (``vlm.init_vlm``)."""

    def __init__(self, cfg: ModelConfig, embed: emb.Embedding,
                 blocks: list[nn.Module], ln_f: torch.Tensor,
                 tail: list[HybridSub] | None = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(blocks)
            self.tail = nn.ModuleList(tail or [])
        else:
            self.blocks = nn.ModuleList(blocks)
        self.ln_f = nn.Parameter(ln_f)


def hybrid_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(full groups of 3, trailing recurrent layers)."""
    return divmod(cfg.n_layers, 3)


def _init_hybrid_sub(gen: torch.Generator, cfg: ModelConfig, kind: str,
                     dt: torch.dtype) -> HybridSub:
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    mixer = (rg.init_rglru_block(gen, cfg, dt) if kind == "rec" else
             attn.init_attention(gen, cfg, dtype=dt,
                                 kv_heads=cfg.n_kv_heads))
    return HybridSub(cfg, kind, ones(), mixer, ones(),
                     mlpm.init_swiglu(gen, cfg, dtype=dt))


def init_lm(gen: torch.Generator, cfg: ModelConfig,
            dtype: torch.dtype | None = None) -> LM:
    """Random weights on ``gen``'s device, stored in ``dtype`` (default the
    config's param dtype; serving stores the compute dtype, which gives the
    same results since every weight is cast to it where used)."""
    check_supported(cfg)
    dt = dtype or cfg.pdtype
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)
    embed = emb.init_embedding(gen, cfg, dt)
    if cfg.family == "hybrid":
        ng, rem = hybrid_counts(cfg)
        groups = [HybridGroup(*(_init_hybrid_sub(gen, cfg, kind, dt)
                                for kind in ("rec", "rec", "attn")))
                  for _ in range(ng)]
        tail = [_init_hybrid_sub(gen, cfg, "rec", dt) for _ in range(rem)]
        return LM(cfg, embed, groups, ones(), tail)
    if cfg.family == "ssm":
        blocks = [SSMBlock(cfg, ones(), ssmm.init_ssm(gen, cfg, dt))
                  for _ in range(cfg.n_layers)]
        return LM(cfg, embed, blocks, ones())
    init_ffn = moem.init_moe if cfg.moe is not None else mlpm.init_swiglu
    blocks = [Block(cfg, ones(), ones(),
                    attn.init_attention(gen, cfg, dtype=dt),
                    init_ffn(gen, cfg, dtype=dt))
              for _ in range(cfg.n_layers)]
    return LM(cfg, embed, blocks, ones())


def lm_forward(
    params: LM,
    tokens: torch.Tensor,  # (B, T) ids
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,  # moe hot-expert plan
    inputs_embeds: torch.Tensor | None = None,  # (B, P, D) put first
    opts: RuntimeOptions | None = None,
) -> torch.Tensor:
    """Returns final hidden states (B, P + T, D) after ln_f."""
    check_supported(cfg)
    if opts is not None and opts.adaptive_embedding and opts.mesh is not None:
        x, _overflow = emb.adaptive_embed(
            params.embed, tokens, cfg, opts.hot_ids,
            cold_capacity(opts, tokens), opts.mesh)
    else:
        x = emb.embed(params.embed, tokens, cfg)
    if inputs_embeds is not None:
        x = torch.cat([inputs_embeds.to(x.dtype), x], dim=1)
    if cfg.family == "hybrid":
        for group in params.groups:  # the reference checkpoints the group
            x = _remat(group, cfg, "full")(x)
        for sub in params.tail:
            x = sub(x)
    else:
        for block in params.blocks:
            x = _remat(block, cfg)(x, slot_map, opts)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def _chunk_nll(hc: torch.Tensor, lc: torch.Tensor, w_out: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the masked NLL, count of unmasked labels) of one chunk."""
    logits = (hc @ w_out).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
    mask = (lc >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def _chunk_nll_vocab_parallel(hc: torch.Tensor, lc: torch.Tensor,
                              w_out: torch.Tensor, group
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_chunk_nll`` of a head cut over ``group`` (``w_out`` this rank's
    (D, V / m) columns): the log-sum-exp from the per-rank logits, shifted
    by their all-reduced max (no gradient), the sum of exps and the gold
    logit (from the rank that owns it) summed over the group; h enters
    through ``copy_to_parallel``."""
    import torch.distributed as dist

    logits = (copy_to_parallel(hc, group) @ w_out).float()
    v = logits.shape[-1]
    top = all_reduce_max(logits.amax(dim=-1), group)
    sum_exp = torch.exp(logits - top[..., None]).sum(dim=-1)
    lse = top + torch.log(all_reduce_replicated(sum_exp, group))
    local = lc - dist.get_rank(group) * v
    own = (local >= 0) & (local < v)
    gold = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    gold = all_reduce_replicated(gold * own, group)
    mask = (lc >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def lm_loss(
    params: LM,
    tokens: torch.Tensor,  # (B, T)
    labels: torch.Tensor,  # (B, T), -1 = masked
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,
    inputs_embeds: torch.Tensor | None = None,
    loss_chunk: int = 128,
    opts: RuntimeOptions | None = None,
) -> torch.Tensor:
    """Mean next-token cross-entropy over unmasked labels, float32; with
    ``inputs_embeds``, over the text positions only."""
    h = lm_forward(params, tokens, cfg, slot_map, inputs_embeds, opts)
    if inputs_embeds is not None:
        h = h[:, inputs_embeds.shape[1]:]
    return hidden_loss(params, h, labels, cfg, loss_chunk)


def hidden_loss(params: LM, h: torch.Tensor, labels: torch.Tensor,
                cfg: ModelConfig, loss_chunk: int = 128) -> torch.Tensor:
    """``lm_loss`` from the final hidden states (B, T, D) of the labelled
    positions: the LM head and the cross-entropy, in chunks of
    ``loss_chunk`` positions (vocab-parallel where the head is cut)."""
    w_out = emb.head_weight(params.embed, cfg).to(h.dtype)
    return chunked_nll(h, labels, w_out, cfg, loss_chunk,
                       getattr(params.embed, "head", None))


def chunked_nll(h: torch.Tensor, labels: torch.Tensor, w_out: torch.Tensor,
                cfg: ModelConfig, loss_chunk: int = 128,
                group=None) -> torch.Tensor:
    """Mean masked cross-entropy of the logits ``h @ w_out`` (taken in
    float32), in chunks of ``loss_chunk`` positions, each under remat when
    ``cfg.remat`` asks for it.  With ``group``, ``w_out`` is this rank's
    columns of a head cut over it, and the logits stay vocab-parallel
    (``_chunk_nll_vocab_parallel``).  Inside a data-parallel region the
    count is the global batch's (``collectives.data_sum``), so the ranks'
    losses sum to the global batch's mean."""
    t = h.shape[1]
    c = min(loss_chunk, t)
    chunk = _remat(_chunk_nll if group is None else
                   partial(_chunk_nll_vocab_parallel, group=group), cfg)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, t, c):
        nll, n = chunk(h[:, s:s + c], labels[:, s:s + c].long(), w_out)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp(data_sum(cnt), min=1.0)


# ------------------------------------------------------------------- decode
def _stacked(state: dict, n: int) -> dict:
    """Each tensor of ``state`` repeated on a new leading axis of n."""
    return {name: t[None].expand(n, *t.shape).clone()
            for name, t in state.items()}


def _rec_width(params) -> int | None:
    """The RG-LRU channels a hybrid model's recurrent blocks hold (a cut
    block's share), or None for the config's width (no params, or not a
    hybrid)."""
    subs = [g.rec1 for g in getattr(params, "groups", ())] + \
        list(getattr(params, "tail", ()))
    return subs[0].mixer.lam.shape[0] if subs else None


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: str | torch.device = "cuda",
                  opts: RuntimeOptions | None = None,
                  params: LM | None = None) -> dict:
    """Zero decode caches in the reference's structure, stacked over the
    layers (groups): dense, moe and vlm {"kv": {"k", "v"}}, each (n_layers,
    B, max_len, KV, hd) in the compute dtype (dense and moe with
    ``opts.kv_cache_int8``: int8 "k", "v" and float32 "k_scale",
    "v_scale" (n_layers, B, max_len, KV)); ssm {"ssm": {"conv", "ssm"}};
    hybrid {"rec1", "rec2": RG-LRU states, "attn": rings of min(window,
    max_len) slots, "tail": a list of RG-LRU states}.  ``params``: the
    model the cache is for; a hybrid placed cut over ``model`` keeps this
    rank's channels of each RG-LRU state."""
    check_supported(cfg)
    if cfg.family == "ssm":
        return {"ssm": _stacked(ssmm.init_ssm_state(cfg, batch, device),
                                cfg.n_layers)}
    if cfg.family == "hybrid":
        ng, rem = hybrid_counts(cfg)
        w = _rec_width(params)
        rec = rg.init_rglru_state(cfg, batch, device, w)
        kv = attn.init_kv_cache(cfg, batch, min(cfg.hybrid.window, max_len),
                                device=device)
        return {"rec1": _stacked(rec, ng), "rec2": _stacked(rec, ng),
                "attn": _stacked(kv, ng),
                "tail": [rg.init_rglru_state(cfg, batch, device, w)
                         for _ in range(rem)]}
    int8 = bool(opts is not None and opts.kv_cache_int8
                and cfg.family in ("dense", "moe"))
    kv = attn.init_kv_cache(cfg, batch, max_len, int8=int8, device=device)
    return {"kv": _stacked(kv, cfg.n_layers)}


def _write(cache: dict, new: dict) -> None:
    """Copy a step's new state into the cache's tensors, in place."""
    for name, t in new.items():
        cache[name].copy_(t)


def _layer(stacked: dict, i: int) -> dict:
    """Layer (group) i's views of a stacked cache."""
    return {name: t[i] for name, t in stacked.items()}


def _hybrid_sub_decode(sub: HybridSub, x: torch.Tensor, state: dict,
                       pos: int, cfg: ModelConfig) -> torch.Tensor:
    """One sub-block's decode step; its state is written in place."""
    z = rms_norm(x, sub.ln1, cfg.norm_eps)
    if sub.kind == "rec":
        y, new = rg.rglru_decode_step(sub.mixer, z, state, cfg)
        _write(state, new)
    else:
        y, _ = attn.decode_attention(sub.mixer, z, state, pos, cfg,
                                     window=cfg.hybrid.window)
    h = x + y
    return h + sub.mlp(rms_norm(h, sub.ln2, cfg.norm_eps))


def lm_decode_step(
    params: LM,
    cache: dict,
    tokens: torch.Tensor,  # (B, 1) current token
    pos: int | torch.Tensor,  # position of the current token
    cfg: ModelConfig,
    slot_map: tuple[int, ...] | None = None,
    opts: RuntimeOptions | None = None,
) -> tuple[torch.Tensor, dict]:
    """One decode step.  Returns (logits (B, 1, V), cache) with the cache
    updated in place."""
    check_supported(cfg)
    x = emb.embed(params.embed, tokens, cfg)
    if cfg.family == "ssm":
        for i, block in enumerate(params.blocks):
            state = _layer(cache["ssm"], i)
            y, new = ssmm.ssm_decode_step(
                block.ssm, rms_norm(x, block.ln1, cfg.norm_eps), state, cfg)
            _write(state, new)
            x = x + y
    elif cfg.family == "hybrid":
        pos = int(pos)
        for i, group in enumerate(params.groups):
            for name in ("rec1", "rec2", "attn"):
                x = _hybrid_sub_decode(getattr(group, name), x,
                                       _layer(cache[name], i), pos, cfg)
        for sub, state in zip(params.tail, cache["tail"]):
            x = _hybrid_sub_decode(sub, x, state, pos, cfg)
    else:
        f32c = not (opts is not None and opts.bf16_cache_math)
        x = _dense_decode(params, cache, x, pos, cfg, slot_map, f32c)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return emb.lm_head(params.embed, x, cfg), cache


def _dense_decode(params: LM, cache: dict, x: torch.Tensor,
                  pos: int | torch.Tensor, cfg: ModelConfig,
                  slot_map: tuple[int, ...] | None,
                  f32_cache_math: bool = True) -> torch.Tensor:
    """The dense, moe and vlm layers' decode step over the KV cache (an
    int8 cache carries its scales)."""
    for i, block in enumerate(params.blocks):
        z = rms_norm(x, block.ln1, cfg.norm_eps)
        y, _ = attn.decode_attention(block.attn, z, _layer(cache["kv"], i),
                                     pos, cfg, f32_cache_math=f32_cache_math)
        x = x + y
        z2 = rms_norm(x, block.ln2, cfg.norm_eps)
        x = x + block.ffn(z2, slot_map)  # moe: moe_ffn on (B, 1, D)
    return x
