"""Worker storage module (paper §3.2) — sorted-array indexes on the device.

PyTorch port of ``repro.core.triples``.  AdHash workers keep three hash
indexes (P, PS, PO); here each worker shard is stored twice, sorted by the
composite keys (p, s) and (p, o), and probes are vectorized binary searches:

  1. given p            -> all (s, o)          [P-index  = ps-sorted range]
  2. given (s, p)       -> all o               [PS-index = ps-sorted range]
  3. given (o, p)       -> all s               [PO-index = po-sorted range]

Every array carries a leading worker axis W.  Padded rows carry key =
INT64_MAX so they sort to the end and never match a probe.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .backend import range_search, resolve_device, span_search
from .query import O, P
from .relalg import expand, gather_rows_of

__all__ = ["ShardedTripleStore", "match_ranges", "probe_values", "gather_rows"]

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

    @property
    def n_workers(self) -> int:
        return self.spo_ps.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys_ps.device

    def nbytes(self) -> int:
        """Bytes of the padded store on its device."""
        return sum(t.numel() * t.element_size() for t in
                   (self.spo_ps, self.keys_ps, self.spo_po, self.keys_po,
                    self.counts))

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

    def to_numpy(self) -> np.ndarray:
        """All live triples, host-side (tests / collection)."""
        counts = self.counts.cpu().numpy()
        spo = self.spo_ps.cpu().numpy()
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
    p64 = p_const.to(torch.int64)
    k64 = sk_const.to(torch.int64)
    var_p = p_const < 0
    lo_key = torch.where(var_p, torch.zeros_like(p64),
                         p64 * nid + k64.clamp(min=0))
    hi_key = torch.where(
        var_p, torch.full_like(p64, I64MAX - 1),
        torch.where(sk_const < 0, (p64 + 1) * nid, p64 * nid + k64 + 1),
    )
    lo, hi = span_search(keys, lo_key.expand(w, 1).contiguous(),
                         hi_key.expand(w, 1).contiguous())
    return lo[:, 0], torch.minimum(hi[:, 0], store.counts)


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
