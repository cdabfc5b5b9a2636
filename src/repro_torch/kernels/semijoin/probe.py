"""Wrapper of the range_search kernel (``csrc/probe.cu``).

Replaces ``repro.kernels.semijoin.semijoin.semijoin_probe`` (the TPU
masked-compare probe) with a sampled binary search per distinct probe,
holding ``torch.searchsorted`` semantics.  The plain version is
``repro_torch.core.backend.range_search_plain`` / ``span_search_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["range_search_cuda", "span_search_cuda"]

_FN = {torch.int64: "adhash_range_search_i64",
       torch.int32: "adhash_range_search_i32"}


def _launch(keys: torch.Tensor, probes: torch.Tensor,
            probes_hi: torch.Tensor | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    from repro_torch.kernels.build import check, library

    span = probes_hi is not None
    hi_src = probes_hi if span else probes
    check_cuda("range_search", keys, probes, hi_src)
    dtype = keys.dtype
    if dtype not in _FN or probes.dtype != dtype or hi_src.dtype != dtype:
        raise TypeError(
            "range_search: keys and probes must share one dtype, int64 or "
            f"int32; got {keys.dtype}, {probes.dtype}, {hi_src.dtype}"
        )
    if keys.dim() != 2 or probes.dim() != 2 or \
            probes.shape[0] != keys.shape[0] or hi_src.shape != probes.shape:
        raise ValueError(
            f"range_search: expected keys (W, N) and probes (W, M); got "
            f"{tuple(keys.shape)} and {tuple(probes.shape)}"
        )
    keys = keys.contiguous()
    probes = probes.contiguous()
    hi_src = hi_src.contiguous()
    w, n = keys.shape
    m = probes.shape[1]
    out = torch.empty((2, w, m), dtype=torch.int32, device=keys.device)
    lo_ptr = out.data_ptr()  # lo is out[0], hi out[1]
    check(getattr(library(), _FN[dtype])(
        keys.data_ptr(), probes.data_ptr(), hi_src.data_ptr(), lo_ptr,
        lo_ptr + 4 * w * m, w, n, m, int(span), stream_ptr(keys)),
        "range_search")
    LAUNCHES["range_search"] += 1
    return out[0], out[1]


def range_search_cuda(keys: torch.Tensor, probes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) = side-left / side-right insertion points, (W, M) int32."""
    return _launch(keys, probes, None)


def span_search_cuda(keys: torch.Tensor, lo_keys: torch.Tensor,
                     hi_keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Side-left insertion points of ``lo_keys`` and ``hi_keys``."""
    return _launch(keys, lo_keys, hi_keys)
