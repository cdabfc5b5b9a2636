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
    from repro_torch.kernels.build import check, library

    check_cuda("expand", lo, hi)
    if lo.dtype != torch.int32 or hi.dtype != torch.int32 or \
            lo.dim() != 2 or lo.shape != hi.shape:
        raise ValueError(
            f"expand: expected lo, hi (W, n) int32; got {tuple(lo.shape)} "
            f"{lo.dtype} and {tuple(hi.shape)} {hi.dtype}"
        )
    w, n = lo.shape
    dev = lo.device
    out = torch.empty((2, w, out_cap), dtype=torch.int32, device=dev)
    left, right_pos = out[0], out[1]
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
    lib = library()
    scratch = torch.empty(lib.adhash_expand_scratch_bytes(w, n, out_cap),
                          dtype=torch.uint8, device=dev)
    check(lib.adhash_expand(
        lo.data_ptr(), hi.data_ptr(), scratch.data_ptr(), total.data_ptr(),
        out.data_ptr(), out.data_ptr() + 4 * w * out_cap, valid.data_ptr(),
        w, n, out_cap, stream_ptr(lo)), "expand")
    LAUNCHES["expand"] += 1
    return left, right_pos, valid, total
