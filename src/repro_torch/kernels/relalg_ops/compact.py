"""Wrapper of the unique_compact kernel (``csrc/compact.cu``).

Replaces ``repro.kernels.relalg_ops.compact.unique_compact_pallas``.  The
plain version is ``repro_torch.core.relalg.unique_compact_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["unique_compact_cuda"]

_FN = {torch.int32: "adhash_unique_compact_i32",
       torch.int64: "adhash_unique_compact_i64"}


def unique_compact_cuda(values: torch.Tensor, valid: torch.Tensor,
                        out_cap: int, pad: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(uniq (W, out_cap), mask, n_unique (W,) int64) of
    ``relalg.unique_compact``; the whole output is specified."""
    from repro_torch.kernels.build import SCAN_TILE, check, library

    check_cuda("unique_compact", values, valid)
    if values.dtype not in _FN or values.dim() != 2 or \
            valid.shape != values.shape or valid.dtype != torch.bool:
        raise ValueError(
            "unique_compact: expected values (W, n) int32|int64 and valid "
            f"(W, n) bool; got {tuple(values.shape)} {values.dtype} and "
            f"{tuple(valid.shape)} {valid.dtype}"
        )
    w, n = values.shape
    dev = values.device
    n_pad = 1 << max(n - 1, 1).bit_length()  # power of two >= max(n, 2)
    values = values.contiguous()
    valid = valid.contiguous()
    scratch = torch.empty((w, n_pad), dtype=values.dtype, device=dev)
    tile_sums = torch.empty((w, -(-n_pad // SCAN_TILE)), dtype=torch.int64,
                            device=dev)
    uniq = torch.empty((w, out_cap), dtype=values.dtype, device=dev)
    n_unique = torch.empty((w,), dtype=torch.int64, device=dev)
    fn = getattr(library(), _FN[values.dtype])
    check(fn(values.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
             tile_sums.data_ptr(), uniq.data_ptr(), n_unique.data_ptr(), w,
             n, n_pad, out_cap, int(pad), stream_ptr(values)),
          "unique_compact")
    LAUNCHES["unique_compact"] += 1
    slot = torch.arange(out_cap, dtype=torch.int64, device=dev)
    return uniq, slot < n_unique[:, None], n_unique
