"""LM data pipeline: deterministic synthetic token streams.

The port's counterpart of ``repro.data.tokens``.  Token ids follow a Zipf
distribution drawn with numpy exactly as the JAX package draws them (same
seed, same ids); the batches then land on ``device`` as int64 tensors.  A
vlm batch also holds ``patches`` (B, n_patches, d_vision) float32, drawn
after the tokens from the same generator, so they equal the reference's bit
for bit.  An audio batch likewise holds ``frames`` (B, n_frames, d_model)
float32, the stub frame embeddings, drawn after the tokens.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.core.backend import resolve_device
from repro_torch.models.common import ModelConfig

__all__ = ["zipf_tokens", "make_batch", "synthetic_batches"]


def zipf_tokens(rng: np.random.Generator, vocab: int, shape: tuple[int, ...],
                alpha: float = 1.1) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab); vectorized inverse-CDF sampling."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** -alpha
    probs /= probs.sum()
    cdf = np.cumsum(probs)
    u = rng.random(size=shape)
    ids = np.searchsorted(cdf, u).astype(np.int32)
    # permute ranks -> ids so "hot" ids are scattered over the vocab space
    perm_rng = np.random.default_rng(12345)
    perm = perm_rng.permutation(vocab).astype(np.int32)
    return perm[np.minimum(ids, vocab - 1)]


def make_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
               seed: int = 0, device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng((seed, step))
    toks = torch.from_numpy(zipf_tokens(rng, cfg.vocab_size, (batch, seq + 1))
                            .astype(np.int64))
    out = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    if cfg.family == "vlm":
        patches = rng.normal(size=(batch, cfg.vlm.n_patches,
                                   cfg.vlm.d_vision)).astype(np.float32)
        out["patches"] = torch.from_numpy(patches).to(dev)
    if cfg.family == "audio":
        frames = rng.normal(size=(batch, cfg.encdec.n_frames,
                                  cfg.d_model)).astype(np.float32)
        out["frames"] = torch.from_numpy(frames).to(dev)
    return out


def synthetic_batches(cfg: ModelConfig, batch: int, seq: int, n_steps: int,
                      seed: int = 0, device: str | torch.device = "cuda"
                      ) -> Iterator[dict]:
    for step in range(n_steps):
        yield make_batch(cfg, batch, seq, step, seed, device)
