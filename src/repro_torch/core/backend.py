"""Device selection, the sorted-search probe primitives and capacity classes.

PyTorch port of ``repro.core.backend``.  The JAX package chooses the data
plane through a registry knob (``searchsorted`` | ``pallas``); the port has
no knob.  Each primitive has one public wrapper whose path follows the
device of its tensors:

  * a CPU tensor runs the plain PyTorch version (the reference the tests
    hold the kernels to),
  * a CUDA tensor launches the hand-written Hopper kernel, or raises.

There is no fallback from the kernel to the plain version, and no probe
threshold: the TPU kernel is O(N) per probe, so the JAX package keeps tiny
probe blocks on ``searchsorted``; the Hopper kernel is a binary search and
takes every probe.

Every per-worker primitive takes the worker axis W as its leading dimension
(the JAX package ``vmap``s a per-worker body over it).
"""
from __future__ import annotations

import torch

__all__ = [
    "resolve_device",
    "range_search",
    "range_search_plain",
    "span_search",
    "span_search_plain",
    "quantize_capacity",
]


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; ``"cuda"`` without a card raises
    (the port never drops quietly to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# ------------------------------------------------------------------- probes
def range_search_plain(keys: torch.Tensor, probes: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Side-left / side-right insertion points, int32, per worker row."""
    lo = torch.searchsorted(keys, probes, side="left", out_int32=True)
    hi = torch.searchsorted(keys, probes, side="right", out_int32=True)
    return lo, hi


def span_search_plain(keys: torch.Tensor, lo_keys: torch.Tensor,
                      hi_keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Side-left insertion points of two probe arrays, int32."""
    lo = torch.searchsorted(keys, lo_keys, side="left", out_int32=True)
    hi = torch.searchsorted(keys, hi_keys, side="left", out_int32=True)
    return lo, hi


def range_search(
    keys: torch.Tensor,  # (W, N) sorted per row, dtype-max padded
    probes: torch.Tensor,  # (W, M) same dtype as keys
) -> tuple[torch.Tensor, torch.Tensor]:
    """Match range [lo, hi) of each probe key — the canonical semi-join
    probe (``torch.searchsorted`` semantics).  Both (W, M) int32."""
    if keys.is_cuda:
        from repro_torch.kernels.semijoin.probe import range_search_cuda

        return range_search_cuda(keys, probes)
    return range_search_plain(keys, probes)


def span_search(
    keys: torch.Tensor,  # (W, N) sorted per row, dtype-max padded
    lo_keys: torch.Tensor,  # (W, M)
    hi_keys: torch.Tensor,  # (W, M)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Side-left insertion points of ``lo_keys`` and ``hi_keys`` — the
    [lo_key, hi_key) composite-key span form used by range scans."""
    if keys.is_cuda:
        from repro_torch.kernels.semijoin.probe import span_search_cuda

        return span_search_cuda(keys, lo_keys, hi_keys)
    return span_search_plain(keys, lo_keys, hi_keys)


# ------------------------------------------------------- capacity quantizing
def quantize_capacity(n: int | float, floor: int = 64,
                      ceil: int | None = None) -> int:
    """Round a capacity up to its power-of-two class (min ``floor``).

    The JAX package quantizes so that static shapes share jit cache
    entries; the port keeps the same classes so that capacities, retry
    ladders and ``n_retries`` match the reference exactly.  ``ceil``
    (optional, also a power of two) caps planner *hints* only — retry
    doubling must stay unbounded or overflow recovery would live-lock."""
    n = max(int(n), floor, 1)
    q = 1 << (n - 1).bit_length()
    if ceil is not None:
        q = min(q, ceil)
    return q
