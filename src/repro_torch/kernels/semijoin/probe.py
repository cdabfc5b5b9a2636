"""Wrapper of the range_search kernel (``csrc/probe.cu``).

Replaces ``repro.kernels.semijoin.semijoin.semijoin_probe`` (the TPU
masked-compare probe) with a binary search per (worker, probe), holding
``torch.searchsorted`` semantics.  The plain version is
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

    operands = (keys, probes) + ((probes_hi,) if probes_hi is not None
                                 else ())
    check_cuda("range_search", *operands)
    if keys.dtype not in _FN or any(t.dtype != keys.dtype for t in operands):
        raise TypeError(
            "range_search: keys and probes must share one dtype, int64 or "
            f"int32; got {[t.dtype for t in operands]}"
        )
    if keys.dim() != 2 or probes.dim() != 2 or \
            probes.shape[0] != keys.shape[0] or \
            (probes_hi is not None and probes_hi.shape != probes.shape):
        raise ValueError(
            f"range_search: expected keys (W, N) and probes (W, M); got "
            f"{tuple(keys.shape)} and {tuple(probes.shape)}"
        )
    keys = keys.contiguous()
    probes = probes.contiguous()
    hi_src = probes_hi.contiguous() if probes_hi is not None else probes
    w, n = keys.shape
    m = probes.shape[1]
    lo = torch.empty((w, m), dtype=torch.int32, device=keys.device)
    hi = torch.empty((w, m), dtype=torch.int32, device=keys.device)
    fn = getattr(library(), _FN[keys.dtype])
    check(fn(keys.data_ptr(), probes.data_ptr(), hi_src.data_ptr(),
             lo.data_ptr(), hi.data_ptr(), w, n, m,
             int(probes_hi is not None), stream_ptr(keys)), "range_search")
    LAUNCHES["range_search"] += 1
    return lo, hi


def range_search_cuda(keys: torch.Tensor, probes: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) = side-left / side-right insertion points, (W, M) int32."""
    return _launch(keys, probes, None)


def span_search_cuda(keys: torch.Tensor, lo_keys: torch.Tensor,
                     hi_keys: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Side-left insertion points of ``lo_keys`` and ``hi_keys``."""
    return _launch(keys, lo_keys, hi_keys)
