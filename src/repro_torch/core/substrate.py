"""Execution substrate: where the worker axis W lives, and the host syncs.

PyTorch port of ``repro.core.substrate``.  The stages in ``dsj.py`` are
global-view functions over tensors with a leading worker axis W.  A
substrate decides where that axis lives and how the stage-internal worker
exchanges are made:

``SingleDeviceSubstrate`` (the default)
    W lives on one device; the exchanges stay the in-memory block
    transposes / broadcasts of dsj.py, so ``Substrate`` binds the stages
    directly, the batched ``*_batch`` stages included.  Placing a store or
    relation is the identity, and the shard-local route of the
    parallel-replica mode is the regular stages.

``MeshSubstrate``
    W is split over the ranks of a ``torch.distributed`` process group, one
    device per rank: rank r owns the contiguous worker block
    ``[r*W/P, (r+1)*W/P)`` and every worker-axis tensor it holds is that
    block.  The per-worker stage bodies run unchanged on the local block;
    the (W_sender, W_receiver) block transposes of ``exchange_hash`` and of
    the reply route become ``all_to_all_single`` on a receiver-major send
    buffer, the sender-axis broadcast of ``exchange_broadcast`` becomes
    ``all_gather_into_tensor`` -- the paper's hash distribution vs
    broadcast dichotomy (Observation 1) as real collectives.  Every other
    stage is the plain one on the local block.  The batched stages keep
    the batch axis B whole on every rank: one collective per bucket.

    A stage returns this rank's own overflow totals and wire cells.  Every
    rank must take the same retry decision and count the same cells, so
    the host reads totals through ``host_total`` / ``host_chain_totals``
    (one scalar ``all_reduce(MAX)`` at the sync it makes anyway; the
    reference's ``pmax``) and a query's cells through ``reduce_sum`` at the
    one fetch that adds them (the reference's ``psum``).  The host's retry
    protocol and the per-query ``QueryStats`` accounting are then
    bit-identical to the single device, and a warm fused chain query still
    makes exactly one host sync.

``DistributedSubstrate``
    A ``MeshSubstrate`` over the world group that
    ``repro_torch.launch.multihost.init_from_env`` joins (the ``ADHASH_*``
    env protocol), or over a world-size-1 group when no coordinator is
    configured -- the collective code path all the same.

Every host decision (overflow retries, IRD triggers, eviction, rebalances,
serving admission) reads values that are equal on every rank, so the ranks
issue the same collectives in the same order (SPMD lockstep); the group's
timeout turns a rank that leaves lockstep into a failure instead of a hang.

The second half is the host-sync chokepoints: every device->host transfer
the executor performs funnels through a substrate's ``host_total`` /
``host_chain_totals`` / ``fetch_global`` or through ``host_fetch``, so
``trace_host_syncs`` (``tracing.py``) counts them, and a ranged trace
times each in an ``adhash.sync`` span.  ``trace_collectives`` counts a mesh's
collectives by kind and by where they run (a stage body or a host sync) --
the port's counterpart of the reference's compiled-HLO assertions.
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from . import dsj
# the host-sync tracer lives in tracing.py; its names stay importable here
from .tracing import (HostSyncTrace, _note_host_transfer, span,  # noqa: F401
                      trace_host_syncs)
from .triples import match_ranges

__all__ = ["Substrate", "SingleDeviceSubstrate", "MeshSubstrate",
           "DistributedSubstrate", "host_total", "host_chain_totals",
           "host_fetch", "trace_host_syncs", "trace_collectives"]


class Substrate:
    """The single-device global view: stage methods bound straight to the
    module-level stages in dsj.py / triples.py."""

    name = "single"
    n_devices = 1
    # one process holding every worker unless a DistributedSubstrate says
    n_processes = 1
    process_id = 0
    #: the MeshSubstrate whose rank holds a store's or relation's worker
    #: block; None on one device (stores and relations carry it as ``mesh``)
    mesh = None

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

    # ------------------------------------------------ host-sharded loading
    # The ingest path builds worker shards on the host and places them
    # through these hooks: ``local_worker_slice`` names the worker block
    # this process loads, ``globalize_worker_array`` puts that block on the
    # device, ``barrier`` fences bootstrap phases.
    def local_worker_slice(self, n_workers: int) -> slice:
        """Contiguous worker block this process loads ([0, W) here)."""
        self.check_workers(n_workers)
        return slice(0, n_workers)

    def globalize_worker_array(self, local: np.ndarray, n_workers: int,
                               device: torch.device) -> torch.Tensor:
        """``local`` (this process's ``local_worker_slice`` block) as a
        tensor on ``device``; one device: the whole array."""
        return torch.from_numpy(np.require(local, requirements=["C", "W"])
                                ).to(device)

    def barrier(self, tag: str = "barrier") -> None:
        """Cross-process rendezvous (no-op off a multi-process mesh)."""

    # ------------------------------------------------- host-side reductions
    # Values the host reads outside the stages: on one device every tensor
    # is global already; a mesh reduces or gathers over its ranks.
    def host_total(self, total: torch.Tensor) -> int:
        """Max over every worker of a per-worker overflow total."""
        return host_total(total)

    def host_chain_totals(self, totals: torch.Tensor) -> np.ndarray:
        """A fused chain's (S,) per-stage maxima, in one host sync."""
        return host_chain_totals(totals)

    def fetch_global(self, x: torch.Tensor) -> np.ndarray:
        """A worker-sharded tensor (leading axis W) on the host, whole."""
        return host_fetch(x)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-worker-block partial sums (wire cells, triple counts) summed
        over the workers' owners (one device: the sums themselves)."""
        return x

    def block_transpose(self, send: torch.Tensor) -> torch.Tensor:
        """(W_sender, W_receiver, ...) -> (W_receiver, W_sender, ...)."""
        return send.transpose(0, 1).contiguous()

    def off_diagonal(self, svalid: torch.Tensor) -> torch.Tensor:
        """Cells of a (W, W, cap) send mask bound for another worker (on a
        mesh this rank's senders' cells; ``reduce_sum`` adds the ranks')."""
        return dsj._off_diagonal(svalid)

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
def host_total(total: torch.Tensor) -> int:
    """Host-side max of a stage overflow total (one transfer)."""
    _note_host_transfer()
    m = total.max()
    with span("sync"):
        return int(m.item())


def host_chain_totals(totals: torch.Tensor) -> np.ndarray:
    """One host sync for a whole fused chain: the (S,) per-stage overflow
    maxima.  This is THE one device->host transfer of a warm fast-path
    query."""
    _note_host_transfer()
    with span("sync"):
        arr = totals.cpu().numpy()
    return arr.reshape(arr.shape[0], -1).max(axis=1)


def host_fetch(x: torch.Tensor) -> np.ndarray:
    """Materialize a device tensor on the host (result/accounting fetch)."""
    _note_host_transfer()
    with span("sync"):
        return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Collective trace
# ---------------------------------------------------------------------------
class CollectiveTrace:
    """Collectives a mesh issued while ``trace_collectives`` was open.

    ``counts[(kind, where)]``: kind is ``all_to_all``, ``all_gather`` or
    ``all_reduce``; where is ``stage`` (a stage body) or ``host`` (a host
    sync, gather or reduction outside the stages).  With ``timed=True`` on
    a card, each collective is bracketed by CUDA events on the current
    stream and ``ms()`` sums their elapsed time per kind."""

    def __init__(self, timed: bool = False) -> None:
        self.counts: Counter = Counter()
        self.timed = timed
        self._events: list = []

    def count(self, kind: str | None = None, where: str | None = None
              ) -> int:
        return sum(n for (k, w), n in self.counts.items()
                   if (kind is None or k == kind)
                   and (where is None or w == where))

    def ms(self) -> dict[str, float]:
        """Elapsed milliseconds per kind (synchronizes the card once)."""
        if self._events:
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for kind, a, b in self._events:
            out[kind] = out.get(kind, 0.0) + a.elapsed_time(b)
        return out


_ACTIVE_COLLECTIVES: CollectiveTrace | None = None


@contextmanager
def trace_collectives(timed: bool = False):
    """Count (and, ``timed`` on a card, time) every collective a mesh
    substrate issues inside the block.

    Usage::

        with trace_collectives() as t:
            engine.query(q)
        assert t.count("all_to_all", "stage") == 4   # two hash DSJs
    """
    global _ACTIVE_COLLECTIVES
    trace = CollectiveTrace(timed)
    prev = _ACTIVE_COLLECTIVES
    _ACTIVE_COLLECTIVES = trace
    try:
        yield trace
    finally:
        _ACTIVE_COLLECTIVES = prev


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------
class MeshSubstrate(Substrate):
    """Worker axis W split over the ranks of a process group, one device a
    rank (see the module docstring).  ``group`` must be initialised
    (``torch.distributed.init_process_group``); world size 1 is allowed and
    runs the collective code path.  ``device`` is this rank's device: its
    tensors are what the collectives carry, so NCCL needs ``"cuda"``."""

    name = "mesh"

    def __init__(self, group=None, *, device: str | torch.device = "cuda"):
        import torch.distributed as dist

        from .backend import resolve_device

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "MeshSubstrate needs an initialised torch.distributed "
                "process group (init_process_group, or DistributedSubstrate)")
        self.group = group
        self.n_devices = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group carries CUDA tensors only; "
                             f"device {self.device} needs the gloo backend")

    @property
    def mesh(self) -> "MeshSubstrate":
        return self

    def check_workers(self, n_workers: int) -> None:
        super().check_workers(n_workers)
        if n_workers % self.n_devices:
            raise ValueError(
                f"n_workers={n_workers} must be divisible by the mesh size "
                f"{self.n_devices} (each rank owns a contiguous block of "
                f"workers)")

    # ------------------------------------------------------- collectives
    def _collective(self, kind: str, where: str, fn) -> None:
        tr = _ACTIVE_COLLECTIVES
        if tr is None:
            fn()
            return
        tr.counts[(kind, where)] += 1
        if tr.timed and self.device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            tr._events.append((kind, a, b))
        else:
            fn()

    def _all_to_all(self, buf: torch.Tensor) -> torch.Tensor:
        """(P, ...) contiguous: block p goes to rank p; returns (P, ...)
        with block p from rank p."""
        import torch.distributed as dist

        wire = buf.view(torch.uint8) if buf.dtype == torch.bool else buf
        out = torch.empty_like(wire)
        self._collective("all_to_all", "stage",
                         lambda: dist.all_to_all_single(out, wire,
                                                        group=self.group))
        return out.view(torch.bool) if buf.dtype == torch.bool else out

    def _all_gather(self, x: torch.Tensor, where: str) -> torch.Tensor:
        """(n, ...) on every rank -> (P*n, ...), rank-major."""
        import torch.distributed as dist

        x = x.contiguous()
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        out = wire.new_empty((self.n_devices * wire.shape[0],)
                             + tuple(wire.shape[1:]))
        self._collective("all_gather", where,
                         lambda: dist.all_gather_into_tensor(
                             out, wire, group=self.group))
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def _all_reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        """``x`` reduced over the ranks (``op`` "max" or "sum") at a host
        read, int64, in x's shape; ``x`` itself is left as it is."""
        import torch.distributed as dist

        t = x.to(torch.int64).reshape(-1).clone()
        rop = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        self._collective("all_reduce", "host", lambda: dist.all_reduce(
            t, op=rop, group=self.group))
        return t.view(x.shape)

    def _receiver_major(self, send: torch.Tensor, k: int) -> torch.Tensor:
        """The send buffer of the block transpose, receiver-major.

        ``send`` is (*batch, W_local_send, W, *rest) with axis k the local
        sender block and axis k+1 the global receiver, any strides; the
        result is (P, *batch, W_local_recv, W_local_send, *rest), block p
        bound for rank p -- the one copy before the collective (on one
        device the transpose's own copy)."""
        p, wl = self.n_devices, send.shape[k]
        x = send.unflatten(k + 1, (p, wl))
        tail = range(k + 3, x.dim())
        return x.permute([k + 1, *range(k), k + 2, k, *tail]).contiguous()

    def _all_to_all_blocks(self, buf: torch.Tensor, k: int) -> torch.Tensor:
        """Ship a ``_receiver_major`` buffer: one all_to_all, then (P,
        *batch, W_local_recv, W_local_send, *rest) as (*batch,
        W_local_recv, W_send, *rest) -- the global view's transpose, this
        rank's receiver block (a view on one rank, a copy on several)."""
        out = self._all_to_all(buf)
        shape = buf.shape
        out = out.permute([*range(1, k + 1), k + 1, 0, k + 2,
                           *range(k + 3, out.dim())])
        return out.reshape(*shape[1:k + 1], shape[k + 1],
                           shape[0] * shape[k + 2], *shape[k + 3:])

    def _block_transpose(self, send: torch.Tensor, k: int) -> torch.Tensor:
        """The (sender, receiver) block transpose as one all_to_all:
        (*batch, W_local_send, W, *rest) -> (*batch, W_local_recv, W_send,
        *rest).  The stages call the two halves themselves, dropping the
        send buffer in between, so an exchange holds two buffers at a time,
        as the single device's transpose does."""
        return self._all_to_all_blocks(self._receiver_major(send, k), k)

    def _offdiag_cells(self, svalid: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's off-diagonal cells of the *global* (sender, receiver)
        matrix, from its (*batch, W_local, W, *rest) send mask: local worker
        i is global worker rank*W_local + i.  One count per batch index;
        ``reduce_sum`` adds the ranks' counts."""
        wl = svalid.shape[k]
        own = svalid.narrow(k + 1, self.rank * wl, wl)
        diag = torch.diagonal(own, dim1=k, dim2=k + 1)
        return (svalid.sum(dim=tuple(range(k, svalid.dim())),
                           dtype=torch.int64)
                - diag.sum(dim=tuple(range(k, diag.dim())),
                           dtype=torch.int64))

    # ---------------------------------------------------------- placement
    def local_worker_slice(self, n_workers: int) -> slice:
        self.check_workers(n_workers)
        wl = n_workers // self.n_devices
        return slice(self.rank * wl, (self.rank + 1) * wl)

    def globalize_worker_array(self, local: np.ndarray, n_workers: int,
                               device: torch.device | None = None
                               ) -> torch.Tensor:
        """This rank's block on its device: the mesh's global array is the
        rank blocks together, never one tensor."""
        if local.shape[0] != n_workers // self.n_devices:
            raise ValueError(f"block of {local.shape[0]} workers is not a "
                             f"1/{self.n_devices} share of W={n_workers}")
        return super().globalize_worker_array(local, n_workers, self.device)

    def shard_store(self, store):
        """This rank's block of a global store, tagged with the mesh; a
        store this mesh placed already passes through."""
        if store.mesh is self:
            return store
        if store.mesh is not None:
            raise ValueError("the store belongs to another mesh")
        sl = self.local_worker_slice(store.spo_ps.shape[0])
        leaves = [self._block(x, sl) for x in store.leaves()]
        return type(store)(*leaves, n_ids=store.n_ids, mesh=self)

    def shard_relation(self, rel):
        if rel.mesh is self:
            return rel
        if rel.mesh is not None:
            raise ValueError("the relation belongs to another mesh")
        sl = self.local_worker_slice(rel.cols.shape[0])
        return type(rel)(self._block(rel.cols, sl),
                         self._block(rel.valid, sl), rel.vars, mesh=self)

    def _block(self, x: torch.Tensor, sl: slice) -> torch.Tensor:
        x = x.to(self.device)
        # a copy of the block, so the global tensor can be freed
        return x if self.n_devices == 1 else x[sl].clone()

    def barrier(self, tag: str = "barrier") -> None:
        import torch.distributed as dist

        if self.n_devices > 1:
            dist.barrier(group=self.group)

    # ---------------------------------------------------------------- host
    def host_total(self, total: torch.Tensor) -> int:
        """The global max of this rank's overflow totals: one all_reduce
        at the host sync, so every rank takes the same retry decision."""
        _note_host_transfer()
        t = self._all_reduce(total.max().reshape(1), "max")
        with span("sync"):
            return int(t.item())

    def host_chain_totals(self, totals: torch.Tensor) -> np.ndarray:
        """(S, ...) stage-major totals -> (S,) global maxima: one
        all_reduce of S values, one transfer."""
        _note_host_transfer()
        local = totals.reshape(totals.shape[0], -1).amax(dim=1)
        t = self._all_reduce(local, "max")
        with span("sync"):
            return t.cpu().numpy()

    def fetch_global(self, x: torch.Tensor) -> np.ndarray:
        """A worker-sharded tensor whole on every rank's host (one
        all_gather along W, one transfer)."""
        _note_host_transfer()
        t = self._all_gather(x, "host")
        with span("sync"):
            return t.cpu().numpy()

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, "sum")

    def block_transpose(self, send: torch.Tensor) -> torch.Tensor:
        return self._block_transpose(send, 0)

    def off_diagonal(self, svalid: torch.Tensor) -> torch.Tensor:
        return self._offdiag_cells(svalid, 0)

    # -------------------------------------------------------------- stages
    # The exchanges: the per-worker bodies of dsj.py on the local block,
    # the block transposes and broadcasts as collectives, this rank's
    # totals and cells.  Every other stage (matches, projections, joins,
    # the shard-local route and the fused chains) is inherited: the plain
    # stage on the local block, no collective.
    def exchange_hash(self, proj, proj_valid, cap_peer, spec=None,
                      table=None):
        # the hash modulus and destination count are the *global* W
        w = proj.shape[0] * self.n_devices
        send, svalid, maxw = dsj.hash_send_buffers(
            proj, proj_valid, w, cap_peer, spec=spec, table=table)
        cells = self._offdiag_cells(svalid, 0)
        buf = self._receiver_major(send, 0)
        del send
        recv = self._all_to_all_blocks(buf, 0)
        del buf
        recv_valid = self._block_transpose(svalid, 0)
        return recv, recv_valid, cells, maxw.max()

    def exchange_broadcast(self, proj, proj_valid):
        wl = proj.shape[0]
        full = self._all_gather(proj, "stage")
        fullv = self._all_gather(proj_valid, "stage")
        recv = full[None].expand((wl,) + full.shape)
        recv_valid = fullv[None].expand((wl,) + fullv.shape)
        # this rank's senders, each value to W-1 peers
        cells = proj_valid.sum(dtype=torch.int64) * (full.shape[0] - 1)
        return recv, recv_valid, cells

    def probe_and_reply(self, store, recv, recv_valid, consts, spec,
                        probe_col, cap_flat, cap_cand):
        send, svalid, totals, maxb = dsj.reply_send_buffers(
            store, recv, recv_valid, consts, spec, probe_col, cap_flat,
            cap_cand)
        cells = self._offdiag_cells(svalid, 0) * 3
        buf = self._receiver_major(send, 0)
        del send
        cand = self._all_to_all_blocks(buf, 0)
        del buf
        cand_valid = self._block_transpose(svalid, 0)
        return cand, cand_valid, cells, totals.max(), maxb.max()

    # ----------------------------------------------- batched stages: B whole
    def exchange_hash_batch(self, proj, proj_valid, cap_peer, spec=None,
                            table=None):
        b, wl, n = proj.shape
        w = wl * self.n_devices
        send, svalid, maxw = dsj.hash_send_buffers(
            proj.reshape(b * wl, n), proj_valid.reshape(b * wl, n), w,
            cap_peer, spec=spec, table=table)
        send = send.view(b, wl, w, cap_peer)
        svalid = svalid.view(b, wl, w, cap_peer)
        cells = self._offdiag_cells(svalid, 1)
        buf = self._receiver_major(send, 1)
        del send
        recv = self._all_to_all_blocks(buf, 1)
        del buf
        recv_valid = self._block_transpose(svalid, 1)
        return recv, recv_valid, cells, maxw.view(b, wl).amax(1)

    def exchange_broadcast_batch(self, proj, proj_valid):
        b, wl, n = proj.shape
        w = wl * self.n_devices

        def gather(x):  # (B, W_local, n) -> (B, W, n)
            full = self._all_gather(x, "stage").view(self.n_devices, b, wl, n)
            return full.permute(1, 0, 2, 3).reshape(b, w, n)

        full, fullv = gather(proj), gather(proj_valid)
        recv = full[:, None].expand(b, wl, w, n)
        recv_valid = fullv[:, None].expand(b, wl, w, n)
        cells = proj_valid.sum(dim=(1, 2), dtype=torch.int64) * (w - 1)
        return recv, recv_valid, cells

    def probe_and_reply_batch(self, store, recv, recv_valid, consts, spec,
                              probe_col, cap_flat, cap_cand):
        send, svalid, maxf, maxb = dsj.reply_send_buffers_batch(
            store, recv, recv_valid, consts, spec, probe_col, cap_flat,
            cap_cand)
        # worker-major (W_local_replier, B, W_sender, ...) as the batch-
        # major view the block transpose reads (no copy)
        svalid = svalid.transpose(0, 1)
        cells = self._offdiag_cells(svalid, 1) * 3
        buf = self._receiver_major(send.transpose(0, 1), 1)
        del send
        cand = self._all_to_all_blocks(buf, 1)
        del buf
        cand_valid = self._block_transpose(svalid, 1)
        return cand, cand_valid, cells, maxf, maxb


class DistributedSubstrate(MeshSubstrate):
    """A MeshSubstrate over the world group of a multi-process run.

    Bring-up first: ``repro_torch.launch.multihost.init_from_env`` joins
    the coordinator (arguments or the ``ADHASH_*`` env protocol) unless a
    default group exists already; with no coordinator configured it
    starts a world-size-1 group of its own, so the substrate stays a mesh
    (``name`` "distributed", the collective path) on one process.  Every
    process reads and hashes every ingest chunk, keeps only its
    ``local_worker_slice``, and loads that block onto its own device.
    ``device`` defaults to ``$ADHASH_DEVICE``, else ``"cuda"``; the backend
    is NCCL for CUDA tensors and gloo for the CPU, unless
    ``$ADHASH_BACKEND`` names another."""

    name = "distributed"

    def __init__(self, *, device: str | None = None,
                 coordinator: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None):
        from repro_torch.launch import multihost

        device = device or multihost.env_device()
        multihost.ensure_initialized(
            coordinator, num_processes, process_id, device=device)
        super().__init__(device=device)
        self.n_processes = self.n_devices
        self.process_id = self.rank
