"""Subject->shard placement: the splitmix64 owner rule (hash placement).

PyTorch port of the hash half of ``repro.core.placement``.  AdHash hashes
triples on the subject: owner(v) = splitmix64(v) mod W, at ingest and again
for every DSJ hash-exchange destination, so the torch and numpy spellings
of the hash must agree bit for bit.  ``DirectoryPlacement`` (hot-subject
splitting) is a later slice of the port.

torch has no unsigned 64-bit shift and ``>>`` on int64 is arithmetic, so
the torch hash shifts logically by masking the sign-extended bits; int64
addition and multiplication wrap exactly like uint64 arithmetic mod 2^64.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "splitmix64_np",
    "splitmix64",
    "PlacementPolicy",
    "HashPlacement",
    "resolve_placement",
]

_MASK64 = (1 << 64) - 1


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_C0 = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


def splitmix64_np(ids: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit integer mix (splitmix64 finalizer), non-negative."""
    x = np.asarray(ids, dtype=np.uint64)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
    x ^= x >> np.uint64(30)
    x = (x * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK64)
    x ^= x >> np.uint64(27)
    x = (x * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK64)
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(1)).astype(np.int64)  # keep sign bit clear


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 tensors — bit-identical to
    :func:`splitmix64_np` (int32 inputs are sign-extended first, exactly as
    the JAX package's cast to uint64 does)."""
    x = x.to(torch.int64)
    x = x + _C0
    x = x ^ _srl(x, 30)
    x = x * _C1
    x = x ^ _srl(x, 27)
    x = x * _C2
    x = x ^ _srl(x, 31)
    return _srl(x, 1)


class PlacementPolicy:
    """Owner computations for ingest (host numpy) + the data plane."""

    name: str = "placement"
    #: case (i) zero-communication local joins are sound iff a subject's
    #: whole star is guaranteed local to one shard
    local_join_safe: bool = True
    #: can split a hot subject's star over shards (the engine's hot-key
    #: rebalancing); only the directory placement of ROADMAP.md §1 item 7
    supports_split: bool = False

    def place_triples_np(self, triples: np.ndarray) -> np.ndarray:
        """Worker id per (N, 3) triple row (ingest path)."""
        raise NotImplementedError


class HashPlacement(PlacementPolicy):
    """owner(v) = splitmix64(v) mod W — the AdHash default."""

    name = "hash"
    local_join_safe = True

    def __init__(self, n_workers: int):
        self.w = n_workers

    def place_triples_np(self, triples: np.ndarray) -> np.ndarray:
        triples = np.asarray(triples)
        return (splitmix64_np(triples[:, 0]) % self.w).astype(np.int32)


def resolve_placement(placement, n_workers: int) -> PlacementPolicy:
    """None/'hash' -> HashPlacement, or a HashPlacement passed through."""
    if placement is None or placement == "hash":
        return HashPlacement(n_workers)
    if placement == "directory":
        raise NotImplementedError(
            "placement='directory' is not ported yet (ROADMAP.md §1 item 7, "
            "placement and rebalancing)"
        )
    if isinstance(placement, HashPlacement):
        if placement.w != n_workers:
            raise ValueError(
                f"placement built for {placement.w} workers, engine has "
                f"{n_workers}"
            )
        return placement
    raise ValueError(f"unknown placement {placement!r}")
