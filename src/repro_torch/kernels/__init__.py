"""Wrappers of the hand-written Hopper kernels (sources in ``../csrc``).

One wrapper per kernel; each checks its tensors, allocates outputs and
scratch with ``torch.empty`` on the card, launches on PyTorch's current
stream and raises if the launch returned a CUDA error.  Each wrapper adds
one to its entry of ``LAUNCHES`` where it launches its kernel, and nowhere
else, so a run can show that the main path went through the kernels.

  kernel          wrapper                                   replaces (TPU)
  range_search    semijoin.probe.range_search_cuda /        semijoin_probe
                  span_search_cuda
  expand          relalg_ops.expand.expand_cuda             expand_pallas
  bucket_by_dest  relalg_ops.bucket.bucket_by_dest_cuda     bucket_by_dest_pallas
  unique_compact  relalg_ops.compact.unique_compact_cuda    unique_compact_pallas
  flash_attention flash_attention.ops.flash_attention_cuda  flash_attention_fwd

``flash_attention_bwd`` (``flash_attention.ops.flash_attention_bwd_cuda``)
replaces no TPU kernel: the JAX package differentiates
``repro.models.attention._blocked_attn`` by autodiff.
"""
from __future__ import annotations

import torch

__all__ = ["LAUNCHES", "reset_launches", "stream_ptr", "check_cuda"]

#: launches per kernel since the last ``reset_launches()``
LAUNCHES: dict[str, int] = {
    "range_search": 0,
    "expand": 0,
    "bucket_by_dest": 0,
    "unique_compact": 0,
    "flash_attention": 0,
    "flash_attention_bwd": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stream_ptr(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device (the raw handle:
    building a ``torch.cuda.Stream`` object costs a launch's worth of host
    time)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every operand of a kernel is a CUDA tensor on one device (compared
    by device index: a CPU tensor's is -1)."""
    dev = tensors[0].get_device()
    for t in tensors:
        if dev < 0 or t.get_device() != dev:
            raise ValueError(
                f"{name}: every operand must be a CUDA tensor on "
                f"{tensors[0].device}, got one on {t.device}"
            )
