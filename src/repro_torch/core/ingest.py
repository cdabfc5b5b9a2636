"""Streaming ingest: the single bootstrap path of the port's engine.

PyTorch port of ``repro.core.ingest``.  Both one-shot arrays and chunk
streams flow through ``StreamIngestor``, so chunked ingest is bit-identical
to one-shot by construction.  Per chunk it hash-places every row through
the placement policy, buffers the rows of the workers this process loads
(``substrate.local_worker_slice``: all of them on one device, this rank's
block on a mesh), and folds the chunk into the global accumulators:
per-worker counts, id range, vertex degrees, subject out-degrees (the
engine's split-candidate pool) and the §3.3 predicate statistics.  Every
process reads and hashes every chunk the same way, so the accumulators,
and hence the store's capacity and the statistics, are equal on every
rank.

``finish`` assembles the loaded workers' sorted indexes host-side with
numpy (the same stable lexsort keys as the JAX package, buffered rows in
stream order, so even sort ties break identically), places the five leaves
through ``substrate.globalize_worker_array`` and fences the ranks
(``barrier("ingest:store")``).  The statistics reproduce
``stats.compute_stats`` exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .backend import resolve_device
from .stats import GlobalStats, PredicateStats
from .triples import I64MAX, ShardedTripleStore

__all__ = ["StreamIngestor", "IngestResult"]


class IngestResult(tuple):
    """(store, stats, n_ids) with attribute access."""

    __slots__ = ()

    def __new__(cls, store, stats, n_ids):
        return super().__new__(cls, (store, stats, n_ids))

    store = property(lambda self: self[0])
    stats = property(lambda self: self[1])
    n_ids = property(lambda self: self[2])


def _grow_to(arr: np.ndarray, n: int) -> np.ndarray:
    """Grow a 1-D accumulator to hold index n-1 (amortized doubling)."""
    if n <= len(arr):
        return arr
    cap = max(len(arr), 1)
    while cap < n:
        cap *= 2
    out = np.zeros(cap, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class StreamIngestor:
    """Chunk-by-chunk bootstrap: place, buffer per worker, accumulate stats."""

    def __init__(self, n_workers: int, *, placement, substrate=None):
        from .substrate import SingleDeviceSubstrate

        self.w = n_workers
        self.placement = placement
        self.substrate = substrate if substrate is not None else \
            SingleDeviceSubstrate()
        # the worker block this process loads
        self.local = self.substrate.local_worker_slice(n_workers)
        # per-worker row buffers of the loaded block (int64, stream order)
        self._buffers: list[list[np.ndarray]] = [
            [] for _ in range(self.local.stop - self.local.start)]
        self._counts = np.zeros(n_workers, dtype=np.int64)
        self.n_triples = 0
        self._max_id = -1
        self._deg = np.zeros(1, dtype=np.int64)  # in+out degree per vertex
        self._sdeg = np.zeros(1, dtype=np.int64)  # subject out-degree
        # predicate id -> [cardinality, sorted unique subjects, objects]
        self._preds: dict[int, list] = {}
        self._finished = False

    # ------------------------------------------------------------------ add
    def add_chunk(self, chunk: np.ndarray) -> None:
        if self._finished:
            raise RuntimeError("StreamIngestor already finished")
        chunk = np.asarray(chunk, dtype=np.int64)
        if chunk.ndim != 2 or chunk.shape[1] != 3:
            raise ValueError(f"chunk must be (n, 3), got {chunk.shape}")
        if not len(chunk):
            return
        assign = self.placement.place_triples_np(chunk)
        self._counts += np.bincount(assign, minlength=self.w)
        # one stable sort groups the rows by worker in stream order
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(self.w + 1))
        for i, w in enumerate(range(self.local.start, self.local.stop)):
            if bounds[w + 1] > bounds[w]:
                self._buffers[i].append(chunk[order[bounds[w]:bounds[w + 1]]])

        # ---- global accumulators
        self.n_triples += len(chunk)
        mx = int(chunk.max())
        self._max_id = max(self._max_id, mx)
        self._deg = _grow_to(self._deg, mx + 1)
        # bincount == np.add.at(deg, ids, 1), without the unbuffered loop
        n = len(self._deg)
        self._deg += np.bincount(chunk[:, 0], minlength=n)
        self._deg += np.bincount(chunk[:, 2], minlength=n)
        self._sdeg = _grow_to(self._sdeg, mx + 1)
        self._sdeg += np.bincount(chunk[:, 0], minlength=len(self._sdeg))
        for p in np.unique(chunk[:, 1]):
            rows = chunk[chunk[:, 1] == p]
            ent = self._preds.get(int(p))
            subs = np.unique(rows[:, 0])
            objs = np.unique(rows[:, 2])
            if ent is None:
                self._preds[int(p)] = [len(rows), subs, objs]
            else:
                ent[0] += len(rows)
                ent[1] = np.union1d(ent[1], subs)
                ent[2] = np.union1d(ent[2], objs)

    # ------------------------------------------------------------- assemble
    @property
    def n_ids(self) -> int:
        return self._max_id + 1 if self._max_id >= 0 else 1

    def finish(self, device: str | torch.device = "cuda") -> IngestResult:
        """Build this process's block of the store on ``device`` and the
        exact global statistics."""
        if self._finished:
            raise RuntimeError("StreamIngestor already finished")
        self._finished = True
        n_ids = self.n_ids
        # the capacity comes from every worker's count: equal on all ranks
        cap = max(int(self._counts.max()), 1)
        wl = len(self._buffers)
        spo_ps = np.zeros((wl, cap, 3), dtype=np.int32)
        keys_ps = np.full((wl, cap), I64MAX, dtype=np.int64)
        spo_po = np.zeros((wl, cap, 3), dtype=np.int32)
        keys_po = np.full((wl, cap), I64MAX, dtype=np.int64)
        for i in range(wl):
            parts = self._buffers[i]
            if not parts:
                continue
            rows = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._buffers[i] = []  # free as we go: peak is one worker's rows
            n = len(rows)
            kps = rows[:, 1] * n_ids + rows[:, 0]
            o1 = np.lexsort((rows[:, 2], kps))
            spo_ps[i, :n] = rows[o1]
            keys_ps[i, :n] = kps[o1]
            kpo = rows[:, 1] * n_ids + rows[:, 2]
            o2 = np.lexsort((rows[:, 0], kpo))
            spo_po[i, :n] = rows[o2]
            keys_po[i, :n] = kpo[o2]
        sub = self.substrate
        dev = resolve_device(device)
        place = lambda a: sub.globalize_worker_array(a, self.w, dev)
        store = ShardedTripleStore(
            spo_ps=place(spo_ps), keys_ps=place(keys_ps),
            spo_po=place(spo_po), keys_po=place(keys_po),
            counts=place(self._counts[self.local].astype(np.int32)),
            n_ids=int(n_ids), mesh=sub.mesh,
        )
        sub.barrier("ingest:store")
        return IngestResult(store, self._build_stats(n_ids), n_ids)

    def _build_stats(self, n_ids: int) -> GlobalStats:
        if self.n_triples == 0:
            return GlobalStats()
        deg = np.zeros(n_ids, dtype=np.int64)
        deg[: len(self._deg)] = self._deg[:n_ids]
        gs = GlobalStats(n_triples=self.n_triples)
        gs._degree = deg
        for p in sorted(self._preds):
            card, subs, objs = self._preds[p]
            gs.per_pred[p] = PredicateStats(
                card=int(card),
                n_subj=int(len(subs)),
                n_obj=int(len(objs)),
                subj_score=float(deg[subs].mean()),
                obj_score=float(deg[objs].mean()),
            )
        return gs

    def split_candidates(
        self, k_max: int = 64
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Top subjects by out-degree — the engine's skew split-candidate
        pool, the reference's selection (same ``argpartition``, so the
        candidates come in the same order)."""
        if self.n_triples == 0:
            return None
        deg = np.zeros(self.n_ids, dtype=np.int64)
        deg[: len(self._sdeg)] = self._sdeg[: self.n_ids]
        k = min(k_max, int((deg > 0).sum()))
        if not k:
            return None
        top = np.argpartition(deg, -k)[-k:]
        return top.astype(np.int64), deg[top].astype(np.int64)
