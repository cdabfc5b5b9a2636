"""InternVL2-style VLM (vlm family): a stubbed ViT frontend and an
InternLM2-like GQA decoder.

PyTorch port of ``repro.models.vlm``.  The inputs carry precomputed patch
embeddings (B, n_patches, d_vision); only the projector and the LM backbone
are real compute.  The projected patches go before the text tokens
(``transformer.lm_forward``'s ``inputs_embeds``), and the loss is taken over
the text positions only.  Decode is text-only: the image was consumed by
the prefill and lives in the KV cache.  The decoder's attention layers run
the hand-written flash kernels (hd 128, causal, no window), their backward
too when training.
"""
from __future__ import annotations

import torch
from torch import nn

from . import transformer as tfm
from .common import ModelConfig, dense_init

__all__ = ["Projector", "init_vlm", "vlm_loss", "init_vlm_cache",
           "vlm_decode_step"]


class Projector(nn.Module):
    """w (d_vision, D), b (D,)."""

    def __init__(self, params: dict[str, torch.Tensor]):
        super().__init__()
        self.w = nn.Parameter(params["w"])
        self.b = nn.Parameter(params["b"])


def init_vlm(gen: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype | None = None) -> tfm.LM:
    """The LM's weights, then the ``projector``'s."""
    dt = dtype or cfg.pdtype
    p = tfm.init_lm(gen, cfg, dt)
    p.projector = Projector({
        "w": dense_init(gen, (cfg.vlm.d_vision, cfg.d_model), dt),
        "b": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
    })
    return p


def _project(p: tfm.LM, patches: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    w = p.projector.w.to(cfg.cdtype)
    b = p.projector.b.to(cfg.cdtype)
    return patches.to(cfg.cdtype) @ w + b


def vlm_loss(
    p: tfm.LM,
    patches: torch.Tensor,  # (B, n_patches, d_vision) stub ViT output
    tokens: torch.Tensor,  # (B, T_text)
    labels: torch.Tensor,  # (B, T_text)
    cfg: ModelConfig,
) -> torch.Tensor:
    return tfm.lm_loss(p, tokens, labels, cfg,
                       inputs_embeds=_project(p, patches, cfg))


def init_vlm_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: str | torch.device = "cuda") -> dict:
    return tfm.init_lm_cache(cfg, batch, max_len, device=device)


def vlm_decode_step(p: tfm.LM, cache: dict, tokens: torch.Tensor,
                    pos: int | torch.Tensor, cfg: ModelConfig
                    ) -> tuple[torch.Tensor, dict]:
    """Text-only decode: the image lives in the KV cache (positions
    [0, n_patches))."""
    return tfm.lm_decode_step(p, cache, tokens, pos, cfg)
