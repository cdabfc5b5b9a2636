"""Execution substrate: where the worker axis W lives, and the host syncs.

PyTorch port of the single-device half of ``repro.core.substrate``.  The
stages in ``dsj.py`` are global-view functions over tensors with a leading
worker axis W; on one device the worker exchanges stay the in-memory block
transposes / broadcasts of dsj.py, so ``Substrate`` binds the stages
directly, the batched ``*_batch`` stages included.  The mesh substrates (W
split over ranks, exchanges as collectives) are a later slice of the port;
on one device the shard-local route of the parallel-replica mode is the
regular stages, and placing a store or relation is the identity.

The second half is the host-sync chokepoints: every device->host transfer
the executor performs funnels through ``host_total``, ``host_chain_totals``
or ``host_fetch``, so ``trace_host_syncs`` counts them — a warm fused chain
query makes exactly one.
"""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from . import dsj
from .triples import match_ranges

__all__ = ["Substrate", "SingleDeviceSubstrate", "host_total",
           "host_chain_totals", "host_fetch", "trace_host_syncs"]


class Substrate:
    """The single-device global view: stage methods bound straight to the
    module-level stages in dsj.py / triples.py."""

    name = "single"

    def check_workers(self, n_workers: int) -> None:
        """Validate that a worker count is placeable on this substrate."""
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")

    def shard_store(self, store):
        """Place a store on the substrate (one device: as it is)."""
        return store

    def shard_relation(self, rel):
        """Place a relation on the substrate (one device: as it is)."""
        return rel

    # -------------------------------------------------------------- stages
    match_ranges = staticmethod(match_ranges)
    match_rows = staticmethod(dsj.match_rows)
    match_first = staticmethod(dsj.match_first)
    project_unique = staticmethod(dsj.project_unique)
    exchange_hash = staticmethod(dsj.exchange_hash)
    exchange_broadcast = staticmethod(dsj.exchange_broadcast)
    probe_and_reply = staticmethod(dsj.probe_and_reply)
    finalize_join = staticmethod(dsj.finalize_join)
    local_probe_join = staticmethod(dsj.local_probe_join)
    # fused case-(i) chains: whole query, per-stage totals stacked, one sync
    local_chain = staticmethod(dsj.local_chain)
    local_chain_from = staticmethod(dsj.local_chain_from)
    # the shard-local route of a pattern-index hit: no collective to skip on
    # one device, so the regular stages
    match_first_local = staticmethod(dsj.match_first)
    local_probe_join_local = staticmethod(dsj.local_probe_join)
    # batched multi-query stages (a leading batch axis B)
    match_first_batch = staticmethod(dsj.match_first_batch)
    project_unique_batch = staticmethod(dsj.project_unique_batch)
    exchange_hash_batch = staticmethod(dsj.exchange_hash_batch)
    exchange_broadcast_batch = staticmethod(dsj.exchange_broadcast_batch)
    probe_and_reply_batch = staticmethod(dsj.probe_and_reply_batch)
    finalize_join_batch = staticmethod(dsj.finalize_join_batch)
    local_probe_join_batch = staticmethod(dsj.local_probe_join_batch)
    local_chain_batch = staticmethod(dsj.local_chain_batch)
    local_chain_from_batch = staticmethod(dsj.local_chain_from_batch)


class SingleDeviceSubstrate(Substrate):
    """Explicit name for the default substrate."""


# ---------------------------------------------------------------------------
# Host sync chokepoints.
# ---------------------------------------------------------------------------
class HostSyncTrace:
    """Counter of device->host transfers, installed by ``trace_host_syncs``."""

    def __init__(self) -> None:
        self.host_transfers = 0


_ACTIVE_TRACE: HostSyncTrace | None = None


@contextmanager
def trace_host_syncs():
    """Count every host transfer issued inside the block.

    Usage::

        with trace_host_syncs() as t:
            engine.query(q)
        assert t.host_transfers == 1   # warm fast-path query
    """
    global _ACTIVE_TRACE
    trace = HostSyncTrace()
    prev = _ACTIVE_TRACE
    _ACTIVE_TRACE = trace
    try:
        yield trace
    finally:
        _ACTIVE_TRACE = prev


def _note_host_transfer() -> None:
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.host_transfers += 1


def host_total(total: torch.Tensor) -> int:
    """Host-side max of a stage overflow total (one transfer)."""
    _note_host_transfer()
    return int(total.max().item())


def host_chain_totals(totals: torch.Tensor) -> np.ndarray:
    """One host sync for a whole fused chain: the (S,) per-stage overflow
    maxima.  This is THE one device->host transfer of a warm fast-path
    query."""
    _note_host_transfer()
    arr = totals.cpu().numpy()
    return arr.reshape(arr.shape[0], -1).max(axis=1)


def host_fetch(x: torch.Tensor) -> np.ndarray:
    """Materialize a device tensor on the host (result/accounting fetch)."""
    _note_host_transfer()
    return x.cpu().numpy()
