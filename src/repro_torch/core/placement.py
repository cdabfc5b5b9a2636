"""Placement layer: pluggable subject->shard mapping (DESIGN §8).

PyTorch port of ``repro.core.placement``.  AdHash hashes triples on the
subject, and the same owner computation reappears at every level of the
data plane: ingest, the DSJ hash-exchange destinations and IRD's replica
placement.  A :class:`PlacementPolicy` answers every "which worker owns
vertex v?" question, so skew resistance (splitting a hot hub subject over
shards) needs no change to any stage.

Two policies:

``HashPlacement``
    The AdHash default: owner(v) = splitmix64(v) mod W.  Stages receive
    ``spec=None`` for it and run their single-destination code.

``DirectoryPlacement``
    Hash placement overlaid with a small exception table of hot subjects,
    kept on the engine's device.  An entry maps subject s to (base shard
    b_s, power-of-two split factor f_s): the triples of s are spread over
    the split set {(b_s + k) mod W : k < f_s}, salted by the object —
    ``owner(s, o) = (b_s + H(o) mod f_s) mod W``.  The table is a
    :class:`DirectoryTable` of three tensors whose capacity is quantized to
    power-of-two classes; it is rebuilt only when the policy's ``version``
    changes.  Probe values bound to a possibly-split subject are replicated
    to the whole split set during the hash exchange
    (``PlacementSpec.value_dests``), so every shard holding a part of a
    split star is probed.

The static part of a policy (worker count, maximum split factor) travels as
a frozen :class:`PlacementSpec`; ``max_split`` bounds the replication
fan-out, and a spec with ``max_split == 1`` is the single-destination hash
path.

On a mesh substrate every rank holds the whole table (``device_table`` on
its own device: a replicated operand), and the spec's ``n_workers`` is the
global W, so ``owner_dest`` / ``triple_dest`` / ``value_dests`` return
*global* worker ids for a rank's local rows; the substrate's block
transpose routes them.  Growing the table within one capacity class still
adds no launch shape.

torch has no unsigned 64-bit shift and ``>>`` on int64 is arithmetic, so
the torch hash shifts logically by masking the sign-extended bits; int64
addition and multiplication wrap exactly like uint64 arithmetic mod 2^64.
Every ``%`` here sees a non-negative dividend and a positive divisor, so
torch's floor modulo and the JAX package's agree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .backend import quantize_capacity

__all__ = [
    "splitmix64_np",
    "splitmix64",
    "DirectoryTable",
    "PlacementSpec",
    "PlacementPolicy",
    "HashPlacement",
    "DirectoryPlacement",
    "resolve_placement",
    "placement_state",
    "placement_from_state",
]

I64MAX = np.iinfo(np.int64).max
_TABLE_FLOOR = 64  # smallest exception-table capacity class
_MASK64 = (1 << 64) - 1


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_C0 = _signed(0x9E3779B97F4A7C15)
_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)


# ---------------------------------------------------------------------------
# The canonical hash: splitmix64 finalizer, numpy and torch spellings.
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# The exception table, on the engine's device
# ---------------------------------------------------------------------------
class DirectoryTable(NamedTuple):
    """Hot-subject exception table, padded to a power-of-two capacity class.

    ``keys`` are sorted subject ids (pad = I64MAX, so padding never matches
    a probe); ``base``/``logf`` carry the base shard and the log2 split
    factor per entry."""

    keys: torch.Tensor  # (C,) int64, sorted, padded with I64MAX
    base: torch.Tensor  # (C,) int32 base shard per entry
    logf: torch.Tensor  # (C,) int32 log2(split factor) per entry


def _table_lookup(table: DirectoryTable, v64: torch.Tensor,
                  valid: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(hit, base, logf) per value — one searchsorted over the sorted keys
    (left side, clipped to the table), as the reference's."""
    idx = torch.searchsorted(table.keys, v64.contiguous()).clamp_(
        0, table.keys.shape[0] - 1)
    hit = (table.keys[idx] == v64) & valid
    return hit, table.base[idx], table.logf[idx]


# ---------------------------------------------------------------------------
# Static spec: the hashable part of a policy
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlacementSpec:
    """Static placement descriptor.  ``max_split`` bounds every table
    entry's split factor and therefore the replication fan-out of
    :meth:`value_dests`; the table's contents are the
    :class:`DirectoryTable` operand.  Every method takes values of any
    shape (the reference's take one worker's row)."""

    kind: str  # "directory" (hash placement passes spec=None to the stages)
    n_workers: int
    max_split: int = 1

    def owner_dest(self, keys: torch.Tensor, valid: torch.Tensor,
                   table: DirectoryTable | None) -> torch.Tensor:
        """Single *base* destination per value (no split salt).

        Used where all rows of one vertex must collocate on a single shard
        regardless of splits (IRD replica modules: parallel-mode local joins
        probe them shard-locally, so a split star's parts must not scatter
        across modules)."""
        w = self.n_workers
        h = (splitmix64(keys) % w).to(torch.int32)
        if table is None or self.max_split == 1:
            return h
        hit, base, _ = _table_lookup(table, keys.to(torch.int64), valid)
        return torch.where(hit, base, h)

    def triple_dest(self, s: torch.Tensor, o: torch.Tensor,
                    valid: torch.Tensor, table: DirectoryTable | None
                    ) -> torch.Tensor:
        """Destination of a (s, p, o) triple: base shard of s, salted by
        H(o) within the split set — the device twin of
        ``PlacementPolicy.place_triples_np``."""
        w = self.n_workers
        h = (splitmix64(s) % w).to(torch.int32)
        if table is None or self.max_split == 1:
            return h
        hit, base, logf = _table_lookup(table, s.to(torch.int64), valid)
        f = (torch.ones_like(logf) << logf).to(torch.int64)
        salt = (splitmix64(o) % f).to(torch.int32)
        return torch.where(hit, (base + salt) % w, h)

    def value_dests(self, vals: torch.Tensor, valid: torch.Tensor,
                    table: DirectoryTable | None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Replicated destinations of probe values (..., n): (dests
        (..., F, n), dvalid).

        A value bound to a split subject must reach *every* shard in the
        split set — its triples are spread over all of them — so replica k
        targets (base + k) mod W and is valid iff k < f(v).  With
        ``max_split == 1`` this is the plain hash path: one destination
        row, no table reads."""
        w = self.n_workers
        h = (splitmix64(vals) % w).to(torch.int32)
        if table is None or self.max_split == 1:
            return h.unsqueeze(-2), valid.unsqueeze(-2)
        hit, base, logf = _table_lookup(table, vals.to(torch.int64), valid)
        base = torch.where(hit, base, h)
        one = torch.ones_like(logf)
        f = torch.where(hit, one << logf, one)
        k = torch.arange(self.max_split, dtype=torch.int32,
                         device=vals.device)[:, None]  # (F, 1)
        dests = (base.unsqueeze(-2) + k) % w
        dvalid = valid.unsqueeze(-2) & (k < f.unsqueeze(-2))
        return dests, dvalid


# ---------------------------------------------------------------------------
# Host-facing policies
# ---------------------------------------------------------------------------
class PlacementPolicy:
    """Owner computations for ingest (host numpy) + the data plane.

    ``stage_spec`` / ``device_table(device)`` are what the executor and IRD
    pass to the stages: (None, None) for hash placement, or a
    (:class:`PlacementSpec`, :class:`DirectoryTable`) pair for directory
    placement."""

    name: str = "placement"
    #: case (i) zero-communication local joins (and IRD's footnote-7
    #: "subject-core edges stay in the main index") are sound iff a subject's
    #: whole star is guaranteed local to one shard
    local_join_safe: bool = True
    #: whether the engine's skew detector may schedule splits on this policy
    supports_split: bool = False

    @property
    def stage_spec(self) -> PlacementSpec | None:
        raise NotImplementedError

    def device_table(self, device: str | torch.device
                     ) -> DirectoryTable | None:
        """The exception table on ``device`` (None: no table)."""
        raise NotImplementedError

    def place_triples_np(self, triples: np.ndarray) -> np.ndarray:
        """Worker id per (N, 3) triple row (ingest path)."""
        raise NotImplementedError

    def owner_np(self, ids: np.ndarray) -> np.ndarray:
        """Base owner per vertex id (split salt excluded) — load accounting
        and split-candidate selection."""
        raise NotImplementedError

    def fingerprint(self) -> tuple:
        """Canonical snapshot for parity tests."""
        raise NotImplementedError


class HashPlacement(PlacementPolicy):
    """owner(v) = splitmix64(v) mod W — the AdHash default (``stage_spec``
    is None, so the stages run their single-destination code)."""

    name = "hash"
    local_join_safe = True
    supports_split = False

    def __init__(self, n_workers: int):
        self.w = n_workers

    @property
    def stage_spec(self) -> None:
        return None

    def device_table(self, device: str | torch.device) -> None:
        return None

    def place_triples_np(self, triples: np.ndarray) -> np.ndarray:
        triples = np.asarray(triples)
        return (splitmix64_np(triples[:, 0]) % self.w).astype(np.int32)

    def owner_np(self, ids: np.ndarray) -> np.ndarray:
        return (splitmix64_np(ids) % self.w).astype(np.int32)

    def fingerprint(self) -> tuple:
        return ("hash", self.w)


class DirectoryPlacement(PlacementPolicy):
    """Hash placement + an exception table of split subjects.

    ``local_join_safe`` is False from construction — not merely once the
    table is non-empty — so an engine on this policy always runs the
    split-safe plan shapes (case (i) demoted to hash DSJ, IRD replicating
    subject-core edges): adding a split later never invalidates previously
    published pattern-index state."""

    name = "directory"
    local_join_safe = False
    supports_split = True

    def __init__(self, n_workers: int, *, max_split: int | None = None):
        self.w = n_workers
        if max_split is None:
            max_split = min(8, n_workers)
        # power-of-two split factors only: consistent split sets across
        # growth
        ms = 1
        while ms * 2 <= max_split:
            ms *= 2
        self.max_split = max(ms, 1)
        # subject id -> (base shard, log2 split factor)
        self.entries: dict[int, tuple[int, int]] = {}
        self._spec = PlacementSpec("directory", n_workers,
                                   max_split=self.max_split)
        # one table per device, dropped whenever ``version`` moves
        self._tables: dict[torch.device, DirectoryTable] = {}
        self._np_cache: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self.version = 0

    # ------------------------------------------------------------- mutation
    def add_splits(self, subjects, logf: int | None = None) -> list[int]:
        """Register split entries for ``subjects``; returns those added.

        Base shard stays the subject's hash owner, so unsplit lookups and
        the k=0 member of every split set agree with plain hash placement.
        The split factor is a power of two (default: the policy maximum),
        making split sets nest across factor growth."""
        if logf is None:
            logf = self.max_split.bit_length() - 1
        f = 1 << logf
        if not (1 <= f <= self.max_split):
            raise ValueError(
                f"split factor {f} outside [1, max_split={self.max_split}]"
            )
        added = []
        for s in subjects:
            s = int(s)
            if s in self.entries:
                continue
            base = int(splitmix64_np(np.asarray([s]))[0] % self.w)
            self.entries[s] = (base, logf)
            added.append(s)
        if added:
            self.version += 1
            self._tables = {}
            self._np_cache = None
        return added

    # ------------------------------------------------------------ accessors
    @property
    def stage_spec(self) -> PlacementSpec:
        return self._spec

    def table_capacity(self) -> int:
        """Current power-of-two capacity class of the exception table."""
        return quantize_capacity(max(len(self.entries), 1),
                                 floor=_TABLE_FLOOR)

    def device_table(self, device: str | torch.device) -> DirectoryTable:
        """The table on ``device``; built there once per ``version``."""
        dev = torch.device(device)
        table = self._tables.get(dev)
        if table is None:
            keys_np, base_np, logf_np = self._np_arrays()
            cap = self.table_capacity()
            keys = np.full(cap, I64MAX, dtype=np.int64)
            base = np.zeros(cap, dtype=np.int32)
            logf = np.zeros(cap, dtype=np.int32)
            n = len(keys_np)
            keys[:n], base[:n], logf[:n] = keys_np, base_np, logf_np
            table = DirectoryTable(*(torch.from_numpy(a).to(dev)
                                     for a in (keys, base, logf)))
            self._tables[dev] = table
        return table

    def _np_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._np_cache is None:
            ks = np.sort(np.fromiter(self.entries, dtype=np.int64,
                                     count=len(self.entries)))
            base = np.array([self.entries[int(k)][0] for k in ks],
                            dtype=np.int32)
            logf = np.array([self.entries[int(k)][1] for k in ks],
                            dtype=np.int32)
            self._np_cache = (ks, base, logf)
        return self._np_cache

    # ----------------------------------------------------------- host owner
    def place_triples_np(self, triples: np.ndarray) -> np.ndarray:
        triples = np.asarray(triples)
        s = triples[:, 0].astype(np.int64)
        h = (splitmix64_np(s) % self.w).astype(np.int32)
        if not self.entries:
            return h
        keys, base, logf = self._np_arrays()
        idx = np.clip(np.searchsorted(keys, s), 0, len(keys) - 1)
        hit = keys[idx] == s
        f = (np.int64(1) << logf[idx].astype(np.int64))
        salt = (splitmix64_np(triples[:, 2]) % f).astype(np.int32)
        return np.where(hit, (base[idx] + salt) % self.w, h).astype(np.int32)

    def owner_np(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        h = (splitmix64_np(ids) % self.w).astype(np.int32)
        if not self.entries:
            return h
        keys, base, _ = self._np_arrays()
        idx = np.clip(np.searchsorted(keys, ids), 0, len(keys) - 1)
        hit = keys[idx] == ids
        return np.where(hit, base[idx], h).astype(np.int32)

    def split_factor(self, s: int) -> int:
        e = self.entries.get(int(s))
        return 1 << e[1] if e is not None else 1

    def fingerprint(self) -> tuple:
        return ("directory", self.w, self.max_split,
                tuple(sorted(self.entries.items())))


# ---------------------------------------------------------------------------
# Checkpointing (DESIGN §9): the placement table is part of the master's
# recoverable state.  The state dict is the reference's, key for key, so a
# snapshot written by either package restores in the other.
# ---------------------------------------------------------------------------
def placement_state(plc: PlacementPolicy) -> dict:
    """JSON-serializable snapshot of a policy (fingerprint included, so a
    restore can be verified against the saved state)."""
    st: dict = {"kind": plc.name, "n_workers": plc.w,
                "fingerprint": repr(plc.fingerprint())}
    if isinstance(plc, DirectoryPlacement):
        st["max_split"] = plc.max_split
        st["entries"] = [[int(s), int(b), int(lf)]
                         for s, (b, lf) in sorted(plc.entries.items())]
    return st


def placement_from_state(state: dict, n_workers: int | None = None
                         ) -> PlacementPolicy:
    """Rebuild a policy from :func:`placement_state`.

    Elastic restore: with ``n_workers`` different from the saved W, base
    shards are recomputed under the new modulus (``add_splits`` re-derives
    them from the hash) and split factors are clamped to the new policy
    maximum.  On the same W the restored fingerprint is the saved one."""
    w = int(n_workers if n_workers is not None else state["n_workers"])
    if state["kind"] == "hash":
        return HashPlacement(w)
    if state["kind"] != "directory":
        raise ValueError(f"unknown placement kind {state['kind']!r}")
    plc = DirectoryPlacement(w, max_split=min(int(state["max_split"]), w))
    max_logf = plc.max_split.bit_length() - 1
    for s, _base, logf in state.get("entries", []):
        plc.add_splits([int(s)], logf=min(int(logf), max_logf))
    return plc


def resolve_placement(placement, n_workers: int) -> PlacementPolicy:
    """Engine-facing constructor: None/'hash' -> HashPlacement,
    'directory' -> DirectoryPlacement, or a policy instance passed through
    (its worker count must match)."""
    if placement is None or placement == "hash":
        return HashPlacement(n_workers)
    if placement == "directory":
        return DirectoryPlacement(n_workers)
    if isinstance(placement, PlacementPolicy):
        w = getattr(placement, "w", n_workers)
        if w != n_workers:
            raise ValueError(
                f"placement built for {w} workers, engine has {n_workers}"
            )
        return placement
    raise ValueError(f"unknown placement {placement!r}")
