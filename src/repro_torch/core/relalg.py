"""Fixed-capacity relational-algebra primitives for the DSJ data plane.

PyTorch port of ``repro.core.relalg``.  Every intermediate relation is a
fixed-capacity buffer plus a validity mask, and every function here takes
the worker axis W as its leading dimension:

  * ``expand``         — variable-multiplicity join expansion (each left
                         row emits count_i rows), int64-safe total.
  * ``compact``        — stable compaction of masked rows to a prefix.
  * ``dedupe_sorted``  — mask duplicates in a sorted row.
  * ``bucket_by_dest`` — fixed-capacity per-destination send buffers.
  * ``unique_compact`` — sort + dedupe + compact (projection dedup).

``expand``, ``bucket_by_dest`` and ``unique_compact`` are the wrappers of
three Hopper kernels: on a CUDA tensor they launch the kernel (or raise),
on a CPU tensor they run the ``*_plain`` version beside them.  The plain
versions follow the JAX package's argsort/searchsorted implementations and
are the reference the kernels are held to.
"""
from __future__ import annotations

import torch

__all__ = [
    "I32MAX",
    "gather_rows_of",
    "select_cols",
    "expand",
    "expand_plain",
    "compact",
    "dedupe_sorted",
    "unique_compact",
    "unique_compact_plain",
    "bucket_by_dest",
    "bucket_by_dest_plain",
]

I32MAX = torch.iinfo(torch.int32).max


def gather_rows_of(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[w, idx[w, j]]`` per worker: (W, N, ...) x (W, m) -> (W, m, ...).

    Indices are clamped to [0, N-1] first: the JAX package relies on XLA
    clamping out-of-range gathers, torch raises instead.  Callers mask the
    lanes whose index was out of range."""
    n = table.shape[1]
    idx = idx.long().clamp(0, max(n - 1, 0))
    if table.dim() == 2:
        return torch.gather(table, 1, idx)
    tail = table.shape[2:]
    full = idx.reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return torch.gather(table, 1, full)


def select_cols(x: torch.Tensor, cols: tuple[int, ...]) -> torch.Tensor:
    """``x[..., cols]`` for a static column tuple.  Indexing a CUDA tensor
    with a Python list copies the list to the card and synchronizes with
    the host, which would break the one-sync chain; slices do not."""
    if not cols:
        return x[..., :0]
    return torch.stack([x[..., c] for c in cols], dim=-1)


# ------------------------------------------------------------------ expand
def expand(lo: torch.Tensor, hi: torch.Tensor, out_cap: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand per-left-row ranges [lo_i, hi_i) into a flat row list.

    ``lo``/``hi`` are (W, n) int32.  Returns (left_idx, right_pos, valid,
    total):
      left_idx  (W, out_cap) int32  left row that produced output j
      right_pos (W, out_cap) int32  position inside that row's range
      valid     (W, out_cap) bool   output j is live
      total     (W,) int64          true (unclamped) number of output rows
    Only valid lanes are specified; every consumer masks the rest."""
    if lo.is_cuda:
        from repro_torch.kernels.relalg_ops.expand import expand_cuda

        return expand_cuda(lo, hi, out_cap)
    return expand_plain(lo, hi, out_cap)


def expand_plain(lo: torch.Tensor, hi: torch.Tensor, out_cap: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """cumsum + searchsorted expansion.  The cumsum accumulates in int64:
    virtual expansion totals routinely exceed int32 and a wrapped total
    would defeat the overflow-retry protocol."""
    w, n = lo.shape
    dev = lo.device
    j = torch.arange(out_cap, dtype=torch.int64, device=dev).expand(w, -1)
    if n == 0:
        zeros = torch.zeros((w, out_cap), dtype=torch.int32, device=dev)
        return (zeros, zeros.clone(), torch.zeros_like(zeros, dtype=torch.bool),
                torch.zeros(w, dtype=torch.int64, device=dev))
    counts = (hi - lo).clamp(min=0).to(torch.int64)
    cum = torch.cumsum(counts, dim=1)
    total = cum[:, -1]
    left = torch.searchsorted(cum, j.contiguous(), side="right")
    left = left.clamp(max=n - 1)
    start = torch.where(
        left > 0, torch.gather(cum, 1, (left - 1).clamp(min=0)),
        torch.zeros_like(left))
    right_pos = torch.gather(lo, 1, left).to(torch.int64) + (j - start)
    valid = j < total[:, None]
    return left.to(torch.int32), right_pos.to(torch.int32), valid, total


# ----------------------------------------------------------------- compact
def compact(values: torch.Tensor, valid: torch.Tensor, out_cap: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable-compact masked rows of ``values`` (W, n, ...) into
    (W, out_cap, ...).  Surplus valid rows beyond ``out_cap`` are dropped
    (the caller checks the count).  Returns (compacted, out_valid)."""
    w, n = valid.shape
    v = valid.to(torch.int64)
    pos = torch.cumsum(v, dim=1) - 1
    n_valid = v.sum(dim=1)
    dest = torch.where(valid & (pos < out_cap), pos,
                       torch.full_like(pos, out_cap))  # dropped -> spare slot
    tail = values.shape[2:]
    out = torch.zeros((w, out_cap + 1) + tail, dtype=values.dtype,
                      device=values.device)
    idx = dest.reshape(dest.shape + (1,) * len(tail)).expand(values.shape)
    out.scatter_(1, idx, values)
    slot = torch.arange(out_cap, device=values.device)
    out_valid = slot[None, :] < n_valid.clamp(max=out_cap)[:, None]
    return out[:, :out_cap], out_valid


def dedupe_sorted(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Given per-row sorted ``values`` with a validity mask, mask all
    duplicates.  Returns the "first occurrence and valid" mask."""
    first = torch.ones_like(valid)
    first[:, 1:] = values[:, 1:] != values[:, :-1]
    return first & valid


# ---------------------------------------------------------- unique_compact
def unique_compact(values: torch.Tensor, valid: torch.Tensor, out_cap: int,
                   pad: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort + dedupe + compact per worker row.  ``values``/``valid`` are
    (W, n).  Returns (uniq (W, out_cap), mask, n_unique (W,) int64), with
    ``n_unique`` counted past ``out_cap``.  ``pad`` must be strictly
    greater than every valid value (the engine uses I32MAX)."""
    if values.is_cuda:
        from repro_torch.kernels.relalg_ops.compact import unique_compact_cuda

        return unique_compact_cuda(values, valid, out_cap, pad)
    return unique_compact_plain(values, valid, out_cap, pad)


def unique_compact_plain(values: torch.Tensor, valid: torch.Tensor,
                         out_cap: int, pad: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    big = torch.full_like(values, pad)
    keyed = torch.where(valid, values, big)
    sv, order = torch.sort(keyed, dim=1, stable=True)
    svalid = torch.gather(valid, 1, order)
    mask = dedupe_sorted(sv, svalid)
    uniq, uvalid = compact(sv, mask, out_cap)
    uniq = torch.where(uvalid, uniq, torch.full_like(uniq, pad))
    return uniq, uvalid, mask.sum(dim=1, dtype=torch.int64)


# ----------------------------------------------------------- bucket_by_dest
def bucket_by_dest(
    values: torch.Tensor,  # (W, n, k) payload rows
    dest: torch.Tensor,  # (W, n) destination per row
    valid: torch.Tensor,  # (W, n)
    n_dest: int,
    cap_peer: int,
    pad: int = -1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-destination send buffers for an all-to-all exchange.

    Returns (send (W, n_dest, cap_peer, k), send_valid (W, n_dest,
    cap_peer), max_wanted (W,) int64 — the most rows any destination
    wanted).  Rows keep their input order within each destination."""
    if values.is_cuda:
        from repro_torch.kernels.relalg_ops.bucket import bucket_by_dest_cuda

        return bucket_by_dest_cuda(values, dest, valid, n_dest, cap_peer, pad)
    return bucket_by_dest_plain(values, dest, valid, n_dest, cap_peer, pad)


def bucket_by_dest_plain(values: torch.Tensor, dest: torch.Tensor,
                         valid: torch.Tensor, n_dest: int, cap_peer: int,
                         pad: int = -1
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable sort by destination; destination d then reads the contiguous
    slice [start_d, start_{d+1})."""
    w, n, k = values.shape
    dev = values.device
    d = torch.where(valid, dest.to(torch.int32),
                    torch.full_like(dest, n_dest, dtype=torch.int32))
    ds, order = torch.sort(d, dim=1, stable=True)
    vs = gather_rows_of(values, order)
    bounds = torch.arange(n_dest + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(ds, bounds.expand(w, -1).contiguous(),
                                side="left")
    lo, hi = starts[:, :-1], starts[:, 1:]
    slot = torch.arange(cap_peer, dtype=torch.int64, device=dev)
    idx = lo[:, :, None] + slot  # (W, n_dest, cap_peer)
    send_valid = idx < hi[:, :, None]
    if n == 0:
        send = torch.full((w, n_dest, cap_peer, k), pad, dtype=values.dtype,
                          device=dev)
    else:
        send = gather_rows_of(vs, idx.reshape(w, -1)).reshape(
            w, n_dest, cap_peer, k)
        send = torch.where(send_valid[..., None], send,
                           torch.full_like(send, pad))
    return send, send_valid, (hi - lo).amax(dim=1).to(torch.int64)
