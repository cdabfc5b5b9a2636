"""Wrapper of the bucket_by_dest kernel (``csrc/bucket.cu``).

Replaces ``repro.kernels.relalg_ops.bucket.bucket_by_dest_pallas``.  The
plain version is ``repro_torch.core.relalg.bucket_by_dest_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, check_cuda, stream_ptr

__all__ = ["bucket_by_dest_cuda", "MAX_DEST"]

MAX_DEST = 256  # one destination a thread of bucket.cu's 256-thread blocks


def bucket_by_dest_cuda(values: torch.Tensor, dest: torch.Tensor,
                        valid: torch.Tensor, n_dest: int, cap_peer: int,
                        pad: int = -1
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(send (W, n_dest, cap_peer, k), send_valid, max_wanted (W,) int64)
    of ``relalg.bucket_by_dest``; the whole buffer is specified."""
    from repro_torch.kernels.build import check, library

    check_cuda("bucket_by_dest", values, dest, valid)
    if values.dim() != 3 or values.dtype != torch.int32 or \
            values.shape[2] not in (1, 3):
        raise ValueError(
            "bucket_by_dest: expected values (W, n, k) int32 with k in "
            f"(1, 3); got {tuple(values.shape)} {values.dtype}"
        )
    w, n, k = values.shape
    if dest.shape != (w, n) or valid.shape != (w, n) or \
            valid.dtype != torch.bool:
        raise ValueError(
            f"bucket_by_dest: expected dest, valid (W, n) = {(w, n)} with "
            f"bool valid; got {tuple(dest.shape)}, {tuple(valid.shape)} "
            f"{valid.dtype}"
        )
    if not 0 < n_dest <= MAX_DEST:
        raise ValueError(f"bucket_by_dest: n_dest must be in [1, {MAX_DEST}],"
                         f" got {n_dest}")
    dev = values.device
    values = values.contiguous()
    dest = dest.to(torch.int32).contiguous()
    valid = valid.contiguous()
    send = torch.empty((w, n_dest, cap_peer, k), dtype=torch.int32,
                       device=dev)
    send_valid = torch.empty((w, n_dest, cap_peer), dtype=torch.bool,
                             device=dev)
    max_wanted = torch.empty((w,), dtype=torch.int64, device=dev)
    lib = library()
    scratch = torch.empty(lib.adhash_bucket_scratch_bytes(w, n, n_dest),
                          dtype=torch.uint8, device=dev)
    check(lib.adhash_bucket_by_dest(
        values.data_ptr(), dest.data_ptr(), valid.data_ptr(),
        scratch.data_ptr(), send.data_ptr(), send_valid.data_ptr(),
        max_wanted.data_ptr(), w, n, k, n_dest, cap_peer, pad,
        stream_ptr(values)), "bucket_by_dest")
    LAUNCHES["bucket_by_dest"] += 1
    return send, send_valid, max_wanted
