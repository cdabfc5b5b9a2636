"""Uniform model API over the ported architectures.

PyTorch port of ``repro.models.model_zoo``: every family of the JAX
package (dense, moe, ssm, hybrid, vlm and audio).  Each arch exposes:
  init(seed, dtype)              -> params (an ``nn.Module`` on the device)
  loss(params, batch)            -> scalar CE loss (the prefill lowering)
  init_cache(batch, max_len[, params]) -> decode cache (zeros; a placed
                                 hybrid's RG-LRU states hold its channels)
  decode(params, cache, batch)   -> (logits, cache)   (the serve lowering)
  input_specs(shape)             -> {name: (shape, dtype)} of a cell's inputs
  param_specs()                  -> the params without storage (fake)

``loss`` follows the caller's grad mode, as the reference's one ``loss``
serves both prefill and training: ``launch.train`` differentiates it,
serving callers wrap it in ``torch.inference_mode()``.  ``init_cache`` and
``decode`` run under ``torch.inference_mode()``.  ``init`` must not: a
parameter made there could never take a gradient.  The vlm family's
``loss`` takes ``batch["patches"]`` beside the tokens.  The audio family's
(whisper) ``loss`` takes ``batch["frames"]`` (B, n_frames, D) stub frame
embeddings with the tokens and labels, and its ``decode`` takes
``batch["enc"]``, the encoder states ``models.whisper.whisper_encode``
makes of the frames, with the token and position; its params are a
``whisper.Whisper`` whose ``dec_pos`` holds 65,536 positions, as the
reference builds it.

``build_model(cfg, opts)`` takes ``transformer.RuntimeOptions``, the
reference's mesh and cache options, and passes them to the decoder-only
families' ``loss``, ``init_cache`` and ``decode``, as the reference's
``build_model`` does (the vlm and audio families take none); ``None`` is
the program without them.

``input_specs`` gives the reference's names, shapes and dtypes of one
(arch, shape) cell's inputs (the vlm family's text length leaves room for
the patches, ``_text_len``); ``param_specs`` builds the parameters under
``FakeTensorMode`` (shapes and dtypes, no storage), the counterpart of
the reference's ``jax.eval_shape(init)``: the dry-run's input.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.backend import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models import vlm as vlmm
from repro_torch.models import whisper as whm
from repro_torch.models.common import ModelConfig

__all__ = ["ModelAPI", "build_model"]


@dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    loss: Callable[[Any, dict], torch.Tensor]
    init_cache: Callable[..., Any]
    decode: Callable[[Any, Any, dict], tuple[torch.Tensor, Any]]

    def input_specs(self, shape) -> dict[str, tuple[tuple[int, ...],
                                                    torch.dtype]]:
        """{name: (shape, dtype)} of a cell's inputs (``configs.SHAPES``
        entry ``shape``), as the reference's ``input_specs``."""
        return input_specs(self.cfg, shape)

    def param_specs(self):
        """The parameters built under ``FakeTensorMode``: every tensor
        fake (its shape and dtype, no storage), on the CPU.  Enter the
        same mode (``fake_mode``) to compute with them."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        mode = FakeTensorMode(allow_non_fake_inputs=True)
        with mode:
            params = build_model(self.cfg, device="cpu").init(0)
        params.fake_mode = mode
        return params


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.family == "vlm":
        return max(seq_len - cfg.vlm.n_patches, 8)
    return seq_len


def input_specs(cfg: ModelConfig, shape) -> dict:
    """{name: (shape, dtype)} of one (arch, shape) cell's inputs."""
    b, t = shape.global_batch, shape.seq_len
    i32 = torch.int32
    train = shape.kind in ("train", "prefill")
    if cfg.family == "audio":
        f = cfg.encdec.n_frames
        if train:
            return {"frames": ((b, f, cfg.d_model), torch.float32),
                    "tokens": ((b, t), i32), "labels": ((b, t), i32)}
        return {"enc": ((b, f, cfg.d_model), cfg.cdtype),
                "tokens": ((b, 1), i32), "pos": ((), i32)}
    if cfg.family == "vlm":
        t = _text_len(cfg, t)
        if train:
            return {"patches": ((b, cfg.vlm.n_patches, cfg.vlm.d_vision),
                                torch.float32),
                    "tokens": ((b, t), i32), "labels": ((b, t), i32)}
        return {"tokens": ((b, 1), i32), "pos": ((), i32)}
    if train:
        return {"tokens": ((b, t), i32), "labels": ((b, t), i32)}
    return {"tokens": ((b, 1), i32), "pos": ((), i32)}


def build_model(cfg: ModelConfig, opts: "tfm.RuntimeOptions | None" = None,
                device: str | torch.device = "cuda") -> ModelAPI:
    """The model family's API on ``device``."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "audio":
        return _audio(cfg, dev)

    vlm = cfg.family == "vlm"

    def init(seed: int = 0, dtype: torch.dtype | None = None) -> tfm.LM:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return (vlmm.init_vlm if vlm else tfm.init_lm)(gen, cfg, dtype)

    def loss(params, batch):
        if vlm:
            return vlmm.vlm_loss(params, batch["patches"], batch["tokens"],
                                 batch["labels"], cfg)
        return tfm.lm_loss(params, batch["tokens"], batch["labels"], cfg,
                           opts=opts)

    @torch.inference_mode()
    def init_cache(b, max_len, params=None):
        return tfm.init_lm_cache(cfg, b, max_len, device=dev,
                                 opts=None if vlm else opts, params=params)

    @torch.inference_mode()
    def decode(params, cache, batch):
        return tfm.lm_decode_step(params, cache, batch["tokens"],
                                  batch["pos"], cfg,
                                  opts=None if vlm else opts)

    return ModelAPI(cfg, dev, init, loss, init_cache, decode)


def _audio(cfg: ModelConfig, dev: torch.device) -> ModelAPI:
    """whisper's API: encoder-decoder loss and decode over ``batch["enc"]``."""

    def init(seed: int = 0, dtype: torch.dtype | None = None) -> whm.Whisper:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return whm.init_whisper(gen, cfg, dtype, max_dec_len=65536)

    def loss(params, batch):
        return whm.whisper_loss(params, batch["frames"], batch["tokens"],
                                batch["labels"], cfg)

    @torch.inference_mode()
    def init_cache(b, max_len, params=None):
        return whm.init_whisper_cache(cfg, b, max_len, device=dev)

    @torch.inference_mode()
    def decode(params, cache, batch):
        return whm.whisper_decode_step(params, cache, batch["enc"],
                                       batch["tokens"], batch["pos"], cfg)

    return ModelAPI(cfg, dev, init, loss, init_cache, decode)
