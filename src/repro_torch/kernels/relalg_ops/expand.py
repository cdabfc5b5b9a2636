"""Wrapper of the expand kernel (``csrc/expand.cu``).

Replaces ``repro.kernels.relalg_ops.expand.expand_pallas``.  The plain
version is ``repro_torch.core.relalg.expand_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["expand_cuda"]


def expand_cuda(lo: torch.Tensor, hi: torch.Tensor, out_cap: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """(left_idx, right_pos, valid, total) of ``relalg.expand``; only valid
    lanes are specified."""
    from repro_torch.kernels.build import SCAN_TILE, check, library

    check_cuda("expand", lo, hi)
    if lo.dtype != torch.int32 or hi.dtype != torch.int32 or \
            lo.dim() != 2 or lo.shape != hi.shape:
        raise ValueError(
            f"expand: expected lo, hi (W, n) int32; got {tuple(lo.shape)} "
            f"{lo.dtype} and {tuple(hi.shape)} {hi.dtype}"
        )
    w, n = lo.shape
    dev = lo.device
    left = torch.empty((w, out_cap), dtype=torch.int32, device=dev)
    right_pos = torch.empty((w, out_cap), dtype=torch.int32, device=dev)
    valid = torch.empty((w, out_cap), dtype=torch.bool, device=dev)
    total = torch.empty((w,), dtype=torch.int64, device=dev)
    if n == 0:  # no ranges: every lane invalid, nothing to launch
        left.zero_()
        right_pos.zero_()
        valid.zero_()
        total.zero_()
        return left, right_pos, valid, total
    lo = lo.contiguous()
    hi = hi.contiguous()
    tile_sums = torch.empty((w, -(-n // SCAN_TILE)), dtype=torch.int64,
                            device=dev)
    cum = torch.empty((w, n), dtype=torch.int64, device=dev)
    check(library().adhash_expand(
        lo.data_ptr(), hi.data_ptr(), tile_sums.data_ptr(), cum.data_ptr(),
        total.data_ptr(), left.data_ptr(), right_pos.data_ptr(),
        valid.data_ptr(), w, n, out_cap, stream_ptr(lo)), "expand")
    LAUNCHES["expand"] += 1
    return left, right_pos, valid, total
