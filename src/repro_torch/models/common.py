"""Shared model components: config schema, norms, RoPE, initializers.

PyTorch port of ``repro.models.common`` for every family of the JAX
package: dense, moe, ssm, hybrid, vlm and audio.  The config dataclasses
are plain data.
The layers are tensor functions with the JAX package's cast semantics: the
compute dtype is pinned per config (bf16 by default), norms and RoPE angles
are taken in float32, and every weight is cast to the compute dtype where it
is used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "AdaptiveConfig",
    "MoEConfig",
    "SSMConfig",
    "HybridConfig",
    "EncDecConfig",
    "VLMConfig",
    "ModelConfig",
    "torch_dtype",
    "rms_norm",
    "rope_tables",
    "apply_rope",
    "dense_init",
]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0  # shared (always-on) experts
    d_expert: int = 0  # expert FFN width (0 -> use d_ff)
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: repeating (recurrent, recurrent, attention)."""

    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: int = 0  # 0 -> d_model
    window: int = 2048  # local attention window


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 4
    n_frames: int = 1500  # audio frames after the (stubbed) conv frontend


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256  # visual tokens from the (stubbed) ViT frontend
    d_vision: int = 1024


@dataclass(frozen=True)
class AdaptiveConfig:
    """The paper's technique applied to LM lookups (DESIGN §2b)."""

    embedding_hot_budget: int = 0  # replicated hot embedding rows (0 = off)
    embedding_cold_frac: float = 1.0  # static cold-exchange capacity fraction
    expert_replication: int = 0  # number of hot experts replicated


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    adaptive: AdaptiveConfig | None = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True  # activation checkpointing of blocks and loss chunks
    remat_policy: str = "full"  # "full" | "dots" (keep matmul outputs)
    scan_unroll: bool = False  # JAX lowering switch; no meaning in torch

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    # --------------------------------------------------- parameter counting
    def param_count(self) -> int:
        """Approximate N for 6*N*D model-FLOPs accounting (dense matmuls)."""
        d, hd = self.d_model, self.hd
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        if self.moe:
            de = self.moe.d_expert or self.d_ff
            ffn = (self.moe.n_experts + self.moe.n_shared) * 3 * d * de
            ffn += d * self.moe.n_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        per_layer = att + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb

    def active_param_count(self) -> int:
        """N_active for MoE (routed experts counted at top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        hd = self.hd
        de = self.moe.d_expert or self.d_ff
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        ffn = (self.moe.top_k + self.moe.n_shared) * 3 * d * de
        per_layer = att + ffn + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb


# ------------------------------------------------------------------ layers
def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * g.to(dt)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                dtype: torch.dtype = torch.float32
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., hd/2) cos/sin tables for the given positions."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., T, H, hd); cos/sin: (T, hd/2) or broadcastable (..., T, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., :, None, :].to(x.dtype)
    s = sin[..., :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype, scale: float | None = None
               ) -> torch.Tensor:
    """Normal(0, 1/sqrt(fan_in)) weights drawn in float32 on ``gen``'s
    device, then cast to ``dtype``.  The draws differ from ``jax.random``'s
    for the same seed; tests carry weights across with
    ``repro_torch.models.convert.params_from_numpy`` instead."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if len(shape) == 3:  # stacked expert / layer weights: fan over axis 1
        fan_in = shape[1]
    sd = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * sd).to(dtype)
