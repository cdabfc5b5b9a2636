"""AdHash engine facade (paper §3, system overview §3.4) — the port's
non-adaptive engine.

PyTorch port of ``repro.core.engine`` with ``adaptive=False`` (the paper's
AdHash-NA baseline).  Bootstraps like the paper: encode -> subject-hash
partition -> load worker shards -> collect statistics -> answer queries.
Per query:

  1. a subject star (every join case (i)) runs the fused chain over the
     main index in parallel mode,
  2. otherwise the locality-aware DP plan runs distributed (Algorithm 1).

The ablation flags (§6.3.1) pass through to the executor.  Adaptivity
(heat map, IRD, pattern index), batched queries, directory placement and
the mesh substrates are later slices of the port and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .backend import quantize_capacity, resolve_device
from .dictionary import Dictionary
from .executor import Executor, QueryStats
from .ingest import StreamIngestor
from .placement import resolve_placement
from .planner import LocalityAwarePlanner
from .query import Query, TriplePattern
from .relation import Relation
from .substrate import SingleDeviceSubstrate

__all__ = ["AdHashEngine", "EngineReport"]


@dataclass
class EngineReport:
    """Cumulative workload accounting (paper Figs. 13/14)."""

    n_queries: int = 0
    n_parallel: int = 0
    n_distributed: int = 0
    comm_cells: int = 0
    wall_time_s: float = 0.0
    history: list[tuple[str, int, float]] = field(default_factory=list)

    @property
    def comm_bytes(self) -> int:
        return self.comm_cells * 4


class AdHashEngine:
    """``triples`` may be a host array (one-shot bootstrap) or an iterator
    of (n, 3) chunks (streaming bootstrap) — both flow through
    :class:`repro_torch.core.ingest.StreamIngestor`, so a chunked ingest
    produces a store bit-identical to the one-shot build.  The store lives
    on ``device`` (default ``"cuda"``; ``"cuda"`` without a card raises)."""

    def __init__(
        self,
        triples,
        n_workers: int,
        *,
        dictionary: Dictionary | None = None,
        adaptive: bool = True,
        locality_aware: bool = True,
        pinned_opt: bool = True,
        capacity: int = 1 << 12,
        use_count_oracle: bool = True,
        substrate=None,
        placement=None,
        local_chain: bool = True,
        device: str | torch.device = "cuda",
    ):
        t0 = time.perf_counter()
        if adaptive:
            raise NotImplementedError(
                "adaptive=True is not ported yet (ROADMAP.md §1 item 6, "
                "adaptivity); pass adaptive=False"
            )
        if substrate is not None and not isinstance(substrate,
                                                    SingleDeviceSubstrate):
            raise NotImplementedError(
                "mesh substrates are not ported yet (ROADMAP.md §1 item 10, "
                "multi-device substrate)"
            )
        self.device = resolve_device(device)
        self.w = n_workers
        self.dictionary = dictionary
        self.adaptive = adaptive
        self.capacity = quantize_capacity(capacity)
        self.substrate = substrate if substrate is not None else \
            SingleDeviceSubstrate()
        self.substrate.check_workers(n_workers)
        self.placement = resolve_placement(placement, n_workers)

        # bootstrap (paper §3.4): partition, load, collect statistics — one
        # code path for a host array (one chunk) and a chunk iterator
        ingestor = StreamIngestor(n_workers, placement=self.placement)
        if isinstance(triples, (np.ndarray, list, tuple)):
            arr = np.asarray(triples)
            if arr.size:
                ingestor.add_chunk(arr)
        else:
            for chunk in triples:
                ingestor.add_chunk(chunk)
        self.store, self.stats, self.n_ids = ingestor.finish(self.device)

        oracle = self._count_pattern if use_count_oracle else None
        self.planner = LocalityAwarePlanner(self.stats, n_workers, oracle)
        self.executor = Executor(
            self.store, n_workers, locality_aware, pinned_opt,
            substrate=self.substrate, placement=self.placement, health=None,
            local_chain=local_chain,
        )
        self.report = EngineReport()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.startup_time_s = time.perf_counter() - t0

    # ------------------------------------------------------------- streaming
    @classmethod
    def ingest_stream(cls, chunks, n_workers: int, **kwargs) -> "AdHashEngine":
        """Bootstrap from an iterable of (n, 3) triple chunks: hash-places
        and buffers chunk by chunk, never holding the concatenated array;
        the store is bit-identical to a one-shot ``AdHashEngine(
        np.concatenate(chunks), ...)``."""
        return cls(iter(chunks), n_workers, **kwargs)

    # ------------------------------------------------------------ cardinality
    def _count_pattern(self, q: TriplePattern) -> int:
        """Exact pattern count via a cheap index probe (planner oracle)."""
        from . import dsj

        spec = dsj.PatternSpec.of(q)
        consts = dsj.pattern_consts(q, self.device)
        none = torch.full_like(consts[0], -1)
        ranges = self.substrate.match_ranges
        if spec.p_const and spec.s_const:
            lo, hi = ranges(self.store, consts[1], consts[0], False,
                            self.n_ids)
        elif spec.p_const and spec.o_const:
            lo, hi = ranges(self.store, consts[1], consts[2], True,
                            self.n_ids)
        elif spec.p_const:
            lo, hi = ranges(self.store, consts[1], none, False, self.n_ids)
        else:
            lo, hi = ranges(self.store, none, none, False, self.n_ids)
        return int(torch.sum(hi - lo))

    # ------------------------------------------------------------------ query
    def query(self, q: Query) -> tuple[Relation, QueryStats]:
        t0 = time.perf_counter()
        plan = self.planner.plan(q)
        rel, qstats = self.executor.execute(
            q, plan.ordering, plan.join_vars,
            capacity=max(self.capacity, plan.capacity_hint()),
        )
        if qstats.mode == "parallel":
            self.report.n_parallel += 1
        else:
            self.report.n_distributed += 1
        dt = time.perf_counter() - t0
        self.report.n_queries += 1
        self.report.comm_cells += qstats.comm_cells
        self.report.wall_time_s += dt
        self.report.history.append((qstats.mode, qstats.comm_cells, dt))
        return rel, qstats

    def query_batch(self, queries: list[Query]):
        raise NotImplementedError(
            "query_batch is not ported yet (ROADMAP.md §1 item 5, batched "
            "execution); call query() per query"
        )
