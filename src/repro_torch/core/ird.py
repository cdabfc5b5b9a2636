"""Incremental ReDistribution — IRD (paper §5.3, Algorithm 3).

PyTorch port of ``repro.core.ird``: redistribution, and the main-store
rebalancing that a directory placement's hot-key splits need.

Given a hot pattern's redistribution tree, the data it touches is re-hashed
around the bindings of the core vertex, level by level:

  Phase 1 — first-hop edges: triples adjacent to the core are hash
  distributed on the core binding.  If the core is the triple's *subject*
  nothing moves (footnote 7: the initial subject-hash partitioning already
  placed them) and the edge is served by the main index.

  Phase 2 — deeper edges: triples are collocated with their parent-edge
  triples through a series of distributed semi-joins (the same machinery as
  query evaluation): each worker projects the *propagating column* of its
  parent-edge triples, the projection is exchanged (hash when the child
  edge's source column is a subject, Observation 1 again; broadcast
  otherwise), candidate triples are routed back and indexed in the per-edge
  replica module.

Replicas are maintained as raw triples in segregated storage modules so the
normal index machinery (and eviction) applies — paper §5.5.  The DSJ stages
run through the execution substrate, and freshly built replica modules are
placed on it (``shard_store``) before they serve parallel-mode queries.

**Deferred mode.**  ``redistribute_deferred`` enqueues the phase-1/phase-2
work and returns without waiting for it: CUDA launches are asynchronous, so
the exchanges and the replica indexing sorts are merely queued on the
current stream when the call returns, and the host is free to plan and
launch the next shape bucket of the query stream (on the same stream: the
overlap hides host work only).  The returned :class:`PendingRedistribution`
keeps the device-derived accounting (wire cells, indexed triples) as device
tensors, and ``finalize()`` is the barrier: one host fetch of those
counters, through ``substrate.host_fetch``, which waits for every replica
module queued before it.  The engine finalizes *before* publishing the
pattern index, so a query can only be routed to a replica module that is
complete.  The only other host syncs are the overflow-retry capacity checks
(host control flow by design).

**Rebalancing.**  ``rebalance_deferred`` re-places the *main* store under a
placement whose table just grew: one bucket_by_dest launch routes every
worker's live rows by ``triple_dest``, the (sender, receiver) transpose
ships them, and ``from_device_rows`` sort-indexes the received rows.  Its
:class:`PendingRebalance` keeps the moved-cell count on the device;
``finalize()`` is one host fetch of it and of the rebuilt store's counts.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from . import dsj
from .backend import quantize_capacity
from .heatmap import HotPattern
from .pattern_index import ReplicaIndex
from .placement import splitmix64
from .query import O, S, TriplePattern
from .relalg import bucket_by_dest
from .substrate import host_fetch, host_total
from .transform import TreeEdge
from .triples import ShardedTripleStore

__all__ = ["IRDStats", "IncrementalRedistributor", "PendingRedistribution",
           "PendingRebalance"]

_MAX_RETRIES = 7


def _index_replica_rows(rows: torch.Tensor, valid: torch.Tensor, n_ids: int
                        ) -> ShardedTripleStore:
    """Sort-index a freshly exchanged replica module (W, cap, 3).  The
    reference jits this and donates the staging buffers; here the staging
    tensors are freed when the caller drops them."""
    return ShardedTripleStore.from_device_rows(rows, valid, n_ids)


@dataclass
class IRDStats:
    comm_cells: int = 0
    triples_indexed: int = 0  # data touched by the IRD process (Fig. 16a)
    n_edges: int = 0

    @property
    def comm_bytes(self) -> int:
        return self.comm_cells * 4


@dataclass
class PendingRedistribution:
    """A dispatched-but-not-yet-published redistribution.

    Device work (exchanges, replica sort-indexing) is enqueued; the replica
    modules are already registered in the ReplicaIndex but the pattern
    index must not reference them until :meth:`finalize` has run.
    ``finalize`` is the barrier: one host fetch of the deferred device
    counters, which waits for every staged module — so the (storage, stats)
    it returns are identical to what a synchronous path would produce."""

    storage: dict[int, str | None] = field(default_factory=dict)
    stats: IRDStats = field(default_factory=IRDStats)
    # 0-d device tensors, fetched only at the barrier
    _cells: list = field(default_factory=list)
    _triples: list = field(default_factory=list)
    _done: bool = False

    def finalize(self) -> tuple[dict[int, str | None], IRDStats]:
        if not self._done:
            counters = [c.to(torch.int64).reshape(())
                        for c in self._cells + self._triples]
            if counters:
                vals = host_fetch(torch.stack(counters))
                n = len(self._cells)
                self.stats.comm_cells += int(vals[:n].sum())
                self.stats.triples_indexed += int(vals[n:].sum())
            self._cells.clear()
            self._triples.clear()
            self._done = True
        return self.storage, self.stats


class IncrementalRedistributor:
    def __init__(
        self,
        main: ShardedTripleStore,
        replicas: ReplicaIndex,
        n_workers: int,
        capacity: int = 1 << 12,
        substrate=None,
        placement=None,
    ):
        from .placement import HashPlacement
        from .substrate import SingleDeviceSubstrate

        self.main = main
        self.replicas = replicas
        self.w = n_workers
        self.cap = quantize_capacity(capacity)
        self.placement = placement if placement is not None else \
            HashPlacement(n_workers)
        self.sub = substrate if substrate is not None else \
            SingleDeviceSubstrate()

    # ------------------------------------------------------------- top level
    def redistribute(self, hot: HotPattern
                     ) -> tuple[dict[int, str | None], IRDStats]:
        """Algorithm 3, synchronous: dispatch and immediately barrier.
        Returns pattern_idx -> storage id (None = served by main index) +
        stats.  ``redistribute(hot)`` == ``redistribute_deferred(hot)
        .finalize()`` by construction — one code path, two sync points."""
        return self.redistribute_deferred(hot).finalize()

    def redistribute_deferred(self, hot: HotPattern) -> PendingRedistribution:
        """Algorithm 3 over every root-to-leaf path (DFS), enqueued without
        waiting; accounting stays on the device.  The caller may interleave
        other work (e.g. the next shape bucket of the query stream), then
        must ``finalize()`` the returned handle before publishing the
        pattern entries it describes."""
        pending = PendingRedistribution()
        stats = pending.stats
        tree = hot.rtree
        storage = pending.storage
        # replica module holding each edge's triples (None = main index)
        store_of_edge: dict[int, ShardedTripleStore | None] = {}
        # the edge that *leads to* each tree node (object identity)
        edge_into: dict[int, TreeEdge] = {}
        for _, e, _ in tree.iter_edges():
            edge_into[id(e.child)] = e

        for parent, edge, depth in tree.iter_edges():
            idx = edge.pattern_idx
            if idx in storage:  # shared prefix already redistributed
                continue
            q = tree.query.patterns[idx]
            stats.n_edges += 1
            if depth == 0:
                if edge.parent_is_subject and self.placement.local_join_safe:
                    # footnote 7: subject-core edges stay in the main index
                    # (but their matches count as data touched by IRD —
                    # paper §6.4.3 counts "data in the main and replica
                    # indices")
                    storage[idx] = None
                    store_of_edge[id(edge)] = None
                    self._count_matches(q, pending)
                else:
                    key_col = S if edge.parent_is_subject else O
                    sid, st = self._hash_distribute_core_edge(
                        q, pending, key_col
                    )
                    storage[idx] = sid
                    store_of_edge[id(edge)] = st
            else:
                pedge = edge_into[id(parent)]
                pstore = store_of_edge[id(pedge)]
                pq = tree.query.patterns[pedge.pattern_idx]
                # propagating column of the parent edge = its child side
                prop_col = O if pedge.parent_is_subject else S
                sid, st = self._collocate_edge(
                    q, edge, pq, pstore, prop_col, pending
                )
                storage[idx] = sid
                store_of_edge[id(edge)] = st
        return pending

    def _match_rows(self, store: ShardedTripleStore, q: TriplePattern):
        """All rows of ``store`` matching ``q``, along the capacity ladder
        (only the overflow-retry check syncs)."""
        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, store.device)
        cap = self.cap
        for _ in range(_MAX_RETRIES):
            rows, valid, total = self.sub.match_rows(store, consts, spec, cap)
            t = host_total(total)
            if t <= cap:
                break
            cap = quantize_capacity(max(cap * 2, t))
        return rows, valid, cap

    def _count_matches(self, q: TriplePattern,
                       pending: PendingRedistribution) -> None:
        """Main-index matches of a pattern (touched-data accounting).  The
        count itself is deferred to the barrier."""
        _, valid, _ = self._match_rows(self.main, q)
        pending._triples.append(valid.sum())

    # ----------------------------------------------------------- phase 1
    def _hash_distribute_core_edge(
        self, q: TriplePattern, pending: PendingRedistribution,
        key_col: int = O,
    ) -> tuple[str, ShardedTripleStore]:
        """Hash-distribute triples matching q on the core binding (column
        ``key_col``).

        Destinations come from the placement's *base* owner — deliberately
        without the directory split salt: every edge module of a hot pattern
        must place a given core binding on the *same* worker, or the
        parallel-mode local joins between them would miss rows.  A split
        star therefore concentrates in its replica modules (correctness
        first); the skew win comes from the split main-store path.  One
        bucket_by_dest launch routes all W workers' rows."""
        rows, valid, cap = self._match_rows(self.main, q)
        w = self.w
        pspec = self.placement.stage_spec
        keys = rows[..., key_col]
        if pspec is None:
            dest = (splitmix64(keys) % w).to(torch.int32)
        else:
            dest = pspec.owner_dest(
                keys, valid, self.placement.device_table(rows.device))
        cap_peer = cap
        for _ in range(_MAX_RETRIES):
            send, svalid, maxw = bucket_by_dest(rows, dest, valid, w,
                                                cap_peer)
            mw = host_total(maxw)
            if mw <= cap_peer:
                break
            cap_peer = quantize_capacity(max(cap_peer * 2, mw))
        recv = send.transpose(0, 1).reshape(w, -1, 3)
        rvalid = svalid.transpose(0, 1).reshape(w, -1)
        pending._cells.append(dsj._off_diagonal(svalid) * 3)
        st = self._stage_replica(recv, rvalid, pending)
        sid = self.replicas.new_id()
        self.replicas.put(sid, st)
        return sid, st

    def _stage_replica(self, rows: torch.Tensor, valid: torch.Tensor,
                       pending: PendingRedistribution) -> ShardedTripleStore:
        """Enqueue the sort-indexing + substrate placement of a replica
        module; ``pending``'s barrier waits for it before the PI may
        publish it."""
        st = _index_replica_rows(rows, valid, self.main.n_ids)
        st = self.sub.shard_store(st)
        pending._triples.append(st.counts.sum())
        return st

    # ----------------------------------------------------------- phase 2
    def _collocate_edge(
        self,
        q: TriplePattern,
        edge: TreeEdge,
        parent_q: TriplePattern,
        parent_store: ShardedTripleStore | None,
        prop_col: int,
        pending: PendingRedistribution,
    ) -> tuple[str, ShardedTripleStore]:
        """Collocate triples matching q with their parent-edge triples
        (a DSJ between the parent replica module and the main index)."""
        pstore = parent_store if parent_store is not None else self.main
        prows, pvalid, cap = self._match_rows(pstore, parent_q)

        # project + dedupe the propagating column
        cap_proj = cap
        for _ in range(_MAX_RETRIES):
            proj, projv, nuniq = self.sub.project_unique(
                prows, pvalid, prop_col, cap_proj)
            nu = host_total(nuniq)
            if nu <= cap_proj:
                break
            cap_proj = quantize_capacity(max(cap_proj * 2, nu))

        # source column of the child edge: where the parent vertex binds
        src_col = S if edge.parent_is_subject else O
        if src_col == S:
            cap_peer = cap_proj
            # probes the main index, so split subjects need the placement's
            # replicated destinations (as query-time case ii)
            pspec = self.placement.stage_spec
            ptable = self.placement.device_table(proj.device)
            for _ in range(_MAX_RETRIES):
                recv, rvalid, cells, maxb = self.sub.exchange_hash(
                    proj, projv, cap_peer, spec=pspec, table=ptable)
                mb = host_total(maxb)
                if mb <= cap_peer:
                    break
                cap_peer = quantize_capacity(max(cap_peer * 2, mb))
        else:
            recv, rvalid, cells = self.sub.exchange_broadcast(proj, projv)
        pending._cells.append(cells)

        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, self.main.device)
        cap_flat = cap_cand = self.cap
        for _ in range(_MAX_RETRIES):
            cand, cvalid, cells, maxf, maxc = self.sub.probe_and_reply(
                self.main, recv, rvalid, consts, spec, src_col,
                cap_flat, cap_cand,
            )
            mf, mc = host_total(maxf), host_total(maxc)
            if mf <= cap_flat and mc <= cap_cand:
                break
            if mf > cap_flat:
                cap_flat = quantize_capacity(max(cap_flat * 2, mf))
            if mc > cap_cand:
                cap_cand = quantize_capacity(max(cap_cand * 2, mc))
        pending._cells.append(cells)

        flat = cand.reshape(self.w, -1, 3)
        flatv = cvalid.reshape(self.w, -1)
        st = self._stage_replica(flat, flatv, pending)
        sid = self.replicas.new_id()
        self.replicas.put(sid, st)
        return sid, st

    # ----------------------------------------------------- main-store moves
    def rebalance_deferred(self, placement) -> "PendingRebalance":
        """Re-place the *main* store under a splitting placement policy
        whose table just grew, enqueued without waiting — the hot-key
        analogue of ``redistribute_deferred``.

        Every worker buckets its live triples by ``placement.triple_dest``
        (split subjects fan out over their split set, salted by the
        object) in one bucket_by_dest launch (k = 3), the (sender,
        receiver) transpose ships them, and the receiving shards are
        sort-indexed like replica modules.  The caller overlaps query
        traffic and calls ``finalize()`` before publishing the rebuilt
        store.  The host syncs are the reference's: the largest shard count
        (the first capacity class) and each retry's check.

        The rebuild flows through ``from_device_rows``, which drops exact
        duplicate triples — RDF set semantics; the main store is
        duplicate-free after bootstrap anyway."""
        main = self.main
        w = self.w
        rows = main.spo_ps  # (W, capT, 3); first counts[w] rows are live
        cap_t = rows.shape[1]
        valid = (torch.arange(cap_t, device=rows.device)[None, :]
                 < main.counts[:, None])
        dest = placement.stage_spec.triple_dest(
            rows[..., S], rows[..., O], valid,
            placement.device_table(rows.device))
        # start near the balanced shard size; retry-double on skew overflow
        cap_peer = quantize_capacity(
            max(host_total(main.counts) // max(w // 2, 1), 1))
        for _ in range(_MAX_RETRIES):
            send, svalid, maxw = bucket_by_dest(rows, dest, valid, w,
                                                cap_peer)
            mw = host_total(maxw)
            if mw <= cap_peer:
                break
            del send, svalid
            cap_peer = quantize_capacity(max(cap_peer * 2, mw))
        else:
            raise RuntimeError("rebalance bucketing exceeded retry budget")
        del dest, valid
        pending = PendingRebalance()
        pending._cells.append(dsj._off_diagonal(svalid) * 3)
        recv = send.transpose(0, 1).reshape(w, -1, 3)
        rvalid = svalid.transpose(0, 1).reshape(w, -1)
        del send, svalid
        st = _index_replica_rows(recv, rvalid, main.n_ids)
        pending.store = self.sub.shard_store(st)
        return pending


@dataclass
class PendingRebalance:
    """A dispatched-but-not-yet-published main-store rebalance.

    ``finalize()`` is the barrier: one host fetch of the moved-cell count
    together with the rebuilt store's counts, which come last in stream
    order, so it waits for the rebuilt shards; it returns (new_store,
    moved_cells), and the engine then republishes the store to every
    component (executor, IRD, parallel executor)."""

    store: ShardedTripleStore | None = None
    _cells: list = field(default_factory=list)
    _done: bool = False
    _moved: int = 0

    def finalize(self) -> tuple[ShardedTripleStore, int]:
        if not self._done:
            parts = [c.to(torch.int64).reshape(1) for c in self._cells]
            if self.store is not None:
                parts.append(self.store.counts.to(torch.int64))
            if parts:
                vals = host_fetch(torch.cat(parts))
                self._moved = int(vals[:len(self._cells)].sum())
            self._cells.clear()
            self._done = True
        return self.store, self._moved
