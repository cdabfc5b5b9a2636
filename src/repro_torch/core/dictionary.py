"""Bi-directional string dictionary (paper §3.1, "String Dictionary").

RDF terms (URIs / literals) are encoded to dense int32 ids.  The dictionary is
master-side, read-mostly state: after bulk loading it is only consulted to
encode incoming queries and decode final results, exactly as in AdHash.  It is
therefore recoverable from stable storage on master failure (paper §3.1,
"Failure Recovery") — see :meth:`save` / :meth:`load`.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Sequence

import numpy as np

__all__ = ["Dictionary"]


class Dictionary:
    """Dense bi-directional term <-> id mapping.

    Ids are assigned in first-seen order and are stable across save/load.
    Encoding of a full triple file is vectorized through numpy where possible.
    """

    def __init__(self) -> None:
        self._term_to_id: dict[str, int] = {}
        self._id_to_term: list[str] = []

    # ------------------------------------------------------------------ encode
    def encode_term(self, term: str) -> int:
        tid = self._term_to_id.get(term)
        if tid is None:
            tid = len(self._id_to_term)
            self._term_to_id[term] = tid
            self._id_to_term.append(term)
        return tid

    def encode_triples(self, triples: Iterable[tuple[str, str, str]]) -> np.ndarray:
        """Encode an iterable of (s, p, o) string triples -> (N, 3) int32."""
        enc = self.encode_term
        rows = [(enc(s), enc(p), enc(o)) for s, p, o in triples]
        if not rows:
            return np.zeros((0, 3), dtype=np.int32)
        return np.asarray(rows, dtype=np.int32)

    def encode_chunk(self, triples: Sequence[tuple[str, str, str]]) -> np.ndarray:
        """Streaming encoder: one chunk of (s, p, o) string triples -> ids.

        Vectorized through ``np.unique`` over the flattened (row-major)
        chunk; new terms are assigned ids in first-occurrence order of that
        flattening, which is exactly the order the sequential
        :meth:`encode_term` loop visits them — so encoding a triple file
        chunk-by-chunk yields the same ids as :meth:`encode_triples` on the
        whole file, for **any** chunk boundaries (the dictionary-stability
        regression in tests/test_ingest_stream.py)."""
        arr = np.asarray(list(triples), dtype=np.str_)
        if arr.size == 0:
            return np.zeros((0, 3), dtype=np.int32)
        arr = arr.reshape(-1, 3)
        flat = arr.ravel()
        uniq, first, inv = np.unique(flat, return_index=True,
                                     return_inverse=True)
        get = self._term_to_id.get
        ids = np.fromiter((get(t, -1) for t in uniq), dtype=np.int64,
                          count=len(uniq))
        missing = np.flatnonzero(ids < 0)
        if missing.size:
            # assign new ids in first-occurrence order within the chunk
            for j in missing[np.argsort(first[missing], kind="stable")]:
                term = str(uniq[j])
                tid = len(self._id_to_term)
                self._term_to_id[term] = tid
                self._id_to_term.append(term)
                ids[j] = tid
        return ids[inv].reshape(arr.shape).astype(np.int32)

    # ------------------------------------------------------------------ decode
    def decode_term(self, tid: int) -> str:
        return self._id_to_term[int(tid)]

    def decode_rows(self, rows: np.ndarray) -> list[tuple[str, ...]]:
        it = self._id_to_term
        return [tuple(it[int(v)] for v in row) for row in np.asarray(rows)]

    def lookup(self, term: str) -> int | None:
        return self._term_to_id.get(term)

    def __len__(self) -> int:
        return len(self._id_to_term)

    def __contains__(self, term: str) -> bool:
        return term in self._term_to_id

    # ------------------------------------------------- persistence (recovery)
    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._id_to_term, f)
        os.replace(tmp, path)  # atomic

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        d = cls()
        with open(path) as f:
            terms: Sequence[str] = json.load(f)
        d._id_to_term = list(terms)
        d._term_to_id = {t: i for i, t in enumerate(terms)}
        return d
