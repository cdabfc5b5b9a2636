"""The engine's own tracer: host-sync counts, named spans, stage row fill.

Every device->host transfer of the query path funnels through the
substrate's chokepoints (``host_total``, ``host_chain_totals``,
``host_fetch`` and a mesh's overrides), which call ``_note_host_transfer``;
``trace_host_syncs`` installs the counter they feed.

``span(name)`` marks where the engine is: the control pass and its parts,
a bucket's execution, each stage attempt, each host sync.  While no trace
opened with ``ranges=True`` is active it is one global check returning a
shared no-op context.  Under such a trace it is a
``torch.profiler.record_function("adhash.<name>")`` range, so a profiler
session records it on the clock of the device events.  The same trace then
also sums, per stage, the live rows of each accepted batched stage output
on the device (``note_rows``); ``HostSyncTrace.row_fill`` reads the sums
once, after the traced block.

Span names (each under ``adhash.``):
  control            ``AdHashEngine.stream_control_step``; inside it
  transform, pi_match, pi_execute, plan, file, adapt
  plan.oracle        the planner's count probe: a device->host read that
                     ``trace_host_syncs`` does not count (inside ``plan``)
  ird.enqueue, ird.barrier, evict, rebalance   (inside ``adapt``)
  bucket             ``AdHashEngine.execute_bucket``; inside it
  stage.consts       padding and the constants' host-to-device copy
  stage.<stage>      one attempt of a stage, its overflow check included:
                     match_first, project, exchange, probe_reply,
                     finalize, local_join, local_chain
  sync               one counted device->host transfer
  serve.control, serve.dispatch   the serving loop's two halves
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

import torch

__all__ = ["HostSyncTrace", "trace_host_syncs", "span", "note_rows"]


class HostSyncTrace:
    """Counter of device->host transfers, installed by ``trace_host_syncs``;
    under ``ranges`` also the per-stage row sums of ``note_rows``."""

    def __init__(self) -> None:
        self.host_transfers = 0
        # stage -> [live rows (0-d int64 device tensor), capacity rows]
        self._rows: dict[str, list] = {}

    def row_fill(self) -> dict[str, tuple[int, int]]:
        """``{stage: (live rows, capacity rows)}`` over the accepted batched
        stage outputs seen while ranged; reads the device sums (one
        transfer a stage, not counted: call it after the traced block)."""
        return {s: (int(live.item()), cap)
                for s, (live, cap) in self._rows.items()}


_ACTIVE_TRACE: HostSyncTrace | None = None
#: the innermost active trace opened with ``ranges=True``
_RANGED: HostSyncTrace | None = None
_NO_SPAN = nullcontext()


@contextmanager
def trace_host_syncs(ranges: bool = False):
    """Count every host transfer issued inside the block; with ``ranges``
    also open the engine's spans as profiler ranges and sum the stages'
    row fill (an inner trace without ``ranges`` keeps an outer one's on).

    Usage::

        with trace_host_syncs() as t:
            engine.query(q)
        assert t.host_transfers == 1   # warm fast-path query
    """
    global _ACTIVE_TRACE, _RANGED
    trace = HostSyncTrace()
    prev, prev_ranged = _ACTIVE_TRACE, _RANGED
    _ACTIVE_TRACE = trace
    if ranges:
        _RANGED = trace
    try:
        yield trace
    finally:
        _ACTIVE_TRACE, _RANGED = prev, prev_ranged


def _note_host_transfer() -> None:
    if _ACTIVE_TRACE is not None:
        _ACTIVE_TRACE.host_transfers += 1


def span(name: str):
    """The profiler range ``adhash.<name>`` under a ranged trace, else a
    shared no-op context."""
    if _RANGED is None:
        return _NO_SPAN
    return torch.profiler.record_function("adhash." + name)


#: int64 words of flags the first pass of ``_live_rows`` adds: each byte
#: lane then counts at most 64 flags, so no lane carries into the next
_WORDS = 64


def _live_rows(valid: torch.Tensor) -> torch.Tensor:
    """``valid.sum()`` as a 0-d int64 tensor, without the int64 copy of the
    whole flag buffer a sum of bools makes: the flags read as int64 words
    (eight one-byte lanes), 64 words added lane by lane, then the lanes."""
    if (not valid.is_contiguous() or valid.numel() % (8 * _WORDS)
            or valid.storage_offset() % 8):
        return valid.sum()
    lanes = valid.view(torch.int64).view(-1, _WORDS).sum(dim=1)
    return lanes.view(torch.uint8).sum()


def note_rows(stage: str, valid: torch.Tensor) -> None:
    """Under a ranged trace, add an accepted batched stage output's live
    rows (its true flags, summed on the device) and its capacity rows
    (``valid.numel()``) to ``stage``'s totals; otherwise nothing."""
    tr = _RANGED
    if tr is None:
        return
    live = _live_rows(valid)
    ent = tr._rows.get(stage)
    if ent is None:
        tr._rows[stage] = [live, valid.numel()]
    else:
        ent[0] += live
        ent[1] += valid.numel()
