"""Wrapper of the unique_compact kernel (``csrc/compact.cu``): an LSD radix
sort over 8-bit digits per worker row, then a card-wide scan that keeps the
first occurrence of each valid value.

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
    from repro_torch.kernels.build import check, library, tiles

    check_cuda("unique_compact", values, valid)
    if values.dtype not in _FN or values.dim() != 2 or \
            valid.shape != values.shape or valid.dtype != torch.bool:
        raise ValueError(
            "unique_compact: expected values (W, n) int32|int64 and valid "
            f"(W, n) bool; got {tuple(values.shape)} {values.dtype} and "
            f"{tuple(valid.shape)} {valid.dtype}"
        )
    w, n = values.shape
    if n >= 2**31:
        raise ValueError(f"unique_compact: row length {n} is not below 2^31")
    dev = values.device
    digits = values.element_size()  # 8-bit radix digits per key
    tile = tiles()  # the loaded library's, never set apart from its build
    n_tiles = -(-n // tile.radix)
    values = values.contiguous()
    valid = valid.contiguous()
    keys = torch.empty((2, w, n), dtype=values.dtype, device=dev)
    scratch = torch.empty((4 * w + w * digits * 256 * (1 + n_tiles),),
                          dtype=torch.int32, device=dev)
    # row bin totals, summed with atomics; a row of one tile sorts without
    totals = torch.zeros((w, digits, 256), dtype=torch.int32, device=dev) \
        if n_tiles > 1 else scratch
    tile_sums = torch.empty((w, -(-max(n, 1) // tile.scan)),
                            dtype=torch.int64, device=dev)
    uniq = torch.empty((w, out_cap), dtype=values.dtype, device=dev)
    n_unique = torch.empty((w,), dtype=torch.int64, device=dev)
    fn = getattr(library(), _FN[values.dtype])
    check(fn(values.data_ptr(), valid.data_ptr(), keys.data_ptr(),
             scratch.data_ptr(), totals.data_ptr(), tile_sums.data_ptr(),
             uniq.data_ptr(), n_unique.data_ptr(), w, n, out_cap, int(pad),
             stream_ptr(values)),
          "unique_compact")
    LAUNCHES["unique_compact"] += 1
    slot = torch.arange(out_cap, dtype=torch.int64, device=dev)
    return uniq, slot < n_unique[:, None], n_unique
