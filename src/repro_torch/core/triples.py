"""Worker storage module (paper §3.2) — sorted-array indexes on the device.

PyTorch port of ``repro.core.triples``.  AdHash workers keep three hash
indexes (P, PS, PO); here each worker shard is stored twice, sorted by the
composite keys (p, s) and (p, o), and probes are vectorized binary searches:

  1. given p            -> all (s, o)          [P-index  = ps-sorted range]
  2. given (s, p)       -> all o               [PS-index = ps-sorted range]
  3. given (o, p)       -> all s               [PO-index = po-sorted range]

Every array carries a leading worker axis W.  Padded rows carry key =
INT64_MAX so they sort to the end and never match a probe.

On a mesh substrate a rank's store holds only its worker block and carries
the substrate as ``mesh``: ``n_workers`` stays the global W (the store, not
the caller, knows how many blocks there are), and the host views
(``to_numpy``, ``host_leaves``) gather the blocks of every rank, as the
reference's go through ``fetch_global``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .backend import range_search, resolve_device, span_search
from .query import O, P
from .relalg import expand, gather_rows_of

__all__ = ["ShardedTripleStore", "match_ranges", "probe_values", "gather_rows",
           "match_ranges_batch", "probe_values_batch", "gather_rows_batch"]

I64MAX = np.iinfo(np.int64).max


@dataclass
class ShardedTripleStore:
    """(W, capT, 3) twice-sorted triple shards + composite probe keys."""

    spo_ps: torch.Tensor  # (W, capT, 3) int32 sorted by (p, s, o)
    keys_ps: torch.Tensor  # (W, capT) int64 = p*NID + s  (pad: I64MAX)
    spo_po: torch.Tensor  # (W, capT, 3) int32 sorted by (p, o, s)
    keys_po: torch.Tensor  # (W, capT) int64 = p*NID + o  (pad: I64MAX)
    counts: torch.Tensor  # (W,) int32 live triples per worker
    n_ids: int  # id-space size (NID)
    # the MeshSubstrate whose rank holds this worker block (None: all of W)
    mesh: object = field(default=None, repr=False, compare=False)

    @property
    def n_workers(self) -> int:
        """The global worker count W (a mesh rank holds W / P of them)."""
        p = self.mesh.n_devices if self.mesh is not None else 1
        return self.spo_ps.shape[0] * p

    @property
    def device(self) -> torch.device:
        return self.keys_ps.device

    def nbytes(self) -> int:
        """Bytes of the padded store on its device."""
        return sum(t.numel() * t.element_size() for t in self.leaves())

    @classmethod
    def from_numpy(cls, spo_ps: np.ndarray, keys_ps: np.ndarray,
                   spo_po: np.ndarray, keys_po: np.ndarray,
                   counts: np.ndarray, n_ids: int,
                   device: str | torch.device = "cuda"
                   ) -> "ShardedTripleStore":
        """Build the store from host leaves — the port's own ingest output
        or ``np.asarray`` of each field of a ``repro`` store, so both
        packages can run their stages on one identical index."""
        dev = resolve_device(device)

        def put(a, dtype):
            # writable + contiguous: copies only leaves that are not already
            return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(dev)

        return cls(
            spo_ps=put(spo_ps, np.int32),
            keys_ps=put(keys_ps, np.int64),
            spo_po=put(spo_po, np.int32),
            keys_po=put(keys_po, np.int64),
            counts=put(counts, np.int32),
            n_ids=int(n_ids),
        )

    @classmethod
    def from_device_rows(cls, rows: torch.Tensor, valid: torch.Tensor,
                         n_ids: int, mesh=None) -> "ShardedTripleStore":
        """Build a store from device-resident (W, cap, 3) rows + mask.

        Used by IRD to index replicated candidate triples without a host
        round-trip: per-worker sort by both composite keys.  Duplicate rows
        (same triple shipped for two probe values) are masked.  Every sort
        is stable, as ``jnp.argsort`` is, so rows with equal keys (padding
        included) keep the reference's order and the five tensors are
        bit-identical to the JAX package's.  Each worker row is sorted on
        its own, so a mesh rank indexes its block (``mesh``) in place."""
        nid = int(n_ids)
        s = rows[..., 0].to(torch.int64)
        p = rows[..., 1].to(torch.int64)
        o = rows[..., 2].to(torch.int64)
        # full composite key for exact-duplicate elimination
        full = torch.where(valid, (p * nid + s) * nid + o, I64MAX)
        fsorted, order = torch.sort(full, dim=1, stable=True)
        rsorted = gather_rows_of(rows, order)
        prev = torch.cat([fsorted[:, :1] - 1, fsorted[:, :-1]], dim=1)
        keep = (fsorted != prev) & (fsorted != I64MAX)
        p, s, o = (gather_rows_of(x, order) for x in (p, s, o))
        kps = torch.where(keep, p * nid + s, I64MAX)
        kpo = torch.where(keep, p * nid + o, I64MAX)
        keys_ps, o1 = torch.sort(kps, dim=1, stable=True)
        keys_po, o2 = torch.sort(kpo, dim=1, stable=True)
        return cls(
            spo_ps=gather_rows_of(rsorted, o1),
            keys_ps=keys_ps,
            spo_po=gather_rows_of(rsorted, o2),
            keys_po=keys_po,
            counts=keep.sum(dim=1, dtype=torch.int32),
            n_ids=nid,
            mesh=mesh,
        )

    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The five tensors, in the reference's pytree order."""
        return (self.spo_ps, self.keys_ps, self.spo_po, self.keys_po,
                self.counts)

    def _host(self, x: torch.Tensor) -> np.ndarray:
        return x.cpu().numpy() if self.mesh is None else \
            self.mesh.fetch_global(x)

    def host_leaves(self) -> tuple[np.ndarray, ...]:
        """The five tensors on the host, every worker's block (a mesh
        gathers them from its ranks)."""
        return tuple(self._host(x) for x in self.leaves())

    def to_numpy(self) -> np.ndarray:
        """All live triples, host-side (tests / collection)."""
        counts = self._host(self.counts)
        spo = self._host(self.spo_ps)
        out = [spo[w, : counts[w]] for w in range(self.n_workers)]
        return np.concatenate(out, axis=0) if out else np.zeros((0, 3),
                                                                np.int32)


# =============================================================== probe stages
def match_ranges(
    store: ShardedTripleStore,
    p_const: torch.Tensor,  # 0-d int32 on the store's device; -1 = variable
    sk_const: torch.Tensor,  # 0-d int32; -1 = no s/o constant bound
    use_po: bool,  # probe (p,o) on PO-index instead of (p,s) on PS-index
    nid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-worker contiguous match range [lo, hi) for a triple pattern,
    each (W,) int32.

    Handles the paper's three search ops: (p), (p,s), (p,o); a variable
    predicate degrades to the full shard range (paper §3.2: "iterate over all
    predicates")."""
    keys = store.keys_po if use_po else store.keys_ps
    w = keys.shape[0]
    lo_key, hi_key = _span_keys(p_const, sk_const, nid)
    lo, hi = span_search(keys, lo_key.expand(w, 1).contiguous(),
                         hi_key.expand(w, 1).contiguous())
    return lo[:, 0], torch.minimum(hi[:, 0], store.counts)


def _span_keys(p_const: torch.Tensor, sk_const: torch.Tensor, nid: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """[lo_key, hi_key) composite-key span of a (p, s|o) pattern bound; a
    variable predicate spans the whole shard."""
    p64 = p_const.to(torch.int64)
    k64 = sk_const.to(torch.int64)
    var_p = p_const < 0
    lo_key = torch.where(var_p, torch.zeros_like(p64),
                         p64 * nid + k64.clamp(min=0))
    hi_key = torch.where(
        var_p, torch.full_like(p64, I64MAX - 1),
        torch.where(sk_const < 0, (p64 + 1) * nid, p64 * nid + k64 + 1),
    )
    return lo_key, hi_key


def probe_values(
    store: ShardedTripleStore,
    p_const: torch.Tensor,  # 0-d int32 (>=0 when col is S or O)
    values: torch.Tensor,  # (W, n) int32 probe values (bindings), -1 pad
    valid: torch.Tensor,  # (W, n) bool
    col: int,  # which column the values bind: S(0), P(1) or O(2)
    nid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized semi-join probe.

    col=S: triples with (p=p_const, s=v)   [PS-index]
    col=O: triples with (p=p_const, o=v)   [PO-index]
    col=P: triples with (p=v)              [P-index = PS range per predicate]
    Returns per-value ranges (lo, hi), each (W, n) int32."""
    keys = store.keys_po if col == O else store.keys_ps
    v64 = values.to(torch.int64).clamp(min=0)
    if col == P:
        lo, hi = span_search(keys, v64 * nid, (v64 + 1) * nid)
    else:
        # [k, k+1) span == (side-left, side-right) of the single key k
        lo, hi = range_search(keys, p_const.to(torch.int64) * nid + v64)
    hi = torch.minimum(hi, store.counts[:, None])
    zero = torch.zeros_like(lo)
    lo = torch.where(valid, lo, zero)
    hi = torch.where(valid, hi, zero)
    return lo, torch.maximum(hi, lo)


def gather_rows(
    store: ShardedTripleStore,
    lo: torch.Tensor,  # (W, n) range starts from probe_values/match_ranges
    hi: torch.Tensor,  # (W, n)
    cap_out: int,
    use_po: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand per-value ranges into triple rows.

    Returns (rows (W, cap_out, 3), src_idx (W, cap_out) index of the probe
    value that produced each row, valid (W, cap_out), total (W,) unclamped).
    """
    spo = store.spo_po if use_po else store.spo_ps
    left, pos, valid, total = expand(lo, hi, cap_out)
    rows = gather_rows_of(spo, pos)
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1))
    return rows, left, valid, total


# ======================================================== batched probe stages
# B queries probe one store.  The store's keys are (W, N) and every query
# shares them, so a batch folds into the probes: (B, W, M) probes become the
# (W, B*M) probe rows of ONE range_search / span_search launch, and lo/hi
# unfold back.  ``expand`` works row by row, so the (B, W, n) ranges become
# B*W rows of one launch.  Inside a stage the rows are kept worker-major
# (W, B, ...), the order in which they gather from the store's (W, N) rows
# without a copy; the (B, W, ...) results the stages return are views.
def match_ranges_batch(
    store: ShardedTripleStore,
    p_const: torch.Tensor,  # (B,) int32; -1 = variable predicate
    sk_const: torch.Tensor,  # (B,) int32; -1 = no s/o constant bound
    use_po: bool,
    nid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``match_ranges``: (lo, hi) each (B, W) int32, from one
    span_search launch at M = B probes a worker."""
    keys = store.keys_po if use_po else store.keys_ps
    w = keys.shape[0]
    b = p_const.shape[0]
    lo_key, hi_key = _span_keys(p_const, sk_const, nid)
    lo, hi = span_search(keys, lo_key.expand(w, b).contiguous(),
                         hi_key.expand(w, b).contiguous())
    return lo.t(), torch.minimum(hi, store.counts[:, None]).t()


def probe_values_batch(
    store: ShardedTripleStore,
    p_const: torch.Tensor,  # (B,) int32 (>=0 when col is S or O)
    values: torch.Tensor,  # (B, W, n) int32 probe values, -1 pad
    valid: torch.Tensor,  # (B, W, n) bool
    col: int,
    nid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``probe_values``: (lo, hi) each (B, W, n) int32, from one
    range_search (or span_search for col=P) launch over (W, B*n) probes."""
    keys = store.keys_po if col == O else store.keys_ps
    b, w, n = values.shape
    # worker-major int64 probes, built in place: at the reply stage's
    # shape this is the largest buffer of the batch
    v64 = torch.empty((w, b, n), dtype=torch.int64, device=values.device)
    v64.copy_(values.transpose(0, 1))
    v64.clamp_(min=0)
    if col == P:
        lo, hi = span_search(keys, (v64 * nid).view(w, b * n),
                             v64.add_(1).mul_(nid).view(w, b * n))
    else:
        v64.add_(p_const.to(torch.int64).mul(nid)[None, :, None])
        lo, hi = range_search(keys, v64.view(w, b * n))
    del v64
    lo = lo.view(w, b, n).transpose(0, 1)
    hi = torch.minimum(hi.view(w, b, n), store.counts[:, None, None]
                       ).transpose(0, 1)
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    lo = torch.where(valid, lo, zero)
    hi = torch.where(valid, hi, zero)
    return lo, torch.maximum(hi, lo)


def gather_rows_batch(
    store: ShardedTripleStore,
    lo: torch.Tensor,  # (B, W, n)
    hi: torch.Tensor,  # (B, W, n)
    cap_out: int,
    use_po: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ``gather_rows``: (rows (B, W, cap_out, 3), src_idx, valid,
    total (B, W)), from one expand launch over B*W rows."""
    spo = store.spo_po if use_po else store.spo_ps
    b, w, n = lo.shape
    rows_of = lambda x: x.transpose(0, 1).reshape(w * b, n)
    left, pos, valid, total = expand(rows_of(lo), rows_of(hi), cap_out)
    rows = gather_rows_of(spo, pos.view(w, b * cap_out)).view(
        w, b, cap_out, 3)
    valid = valid.view(w, b, cap_out)
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1))
    unfold = lambda x: x.view((w, b) + x.shape[1:]).transpose(0, 1)
    return (rows.transpose(0, 1), unfold(left), valid.transpose(0, 1),
            unfold(total))
