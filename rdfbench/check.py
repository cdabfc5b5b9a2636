"""What decides ``correct``: the program's answers against the reference.

During the window a ``Sampler`` keeps one answer a stratum, drawn from the
seed.  A stratum is the template, the route the program answered by,
whether an eviction had happened, and the query's lane: its place among
the queries of its template that one round (or one delivery of the serving
loop) answered, which is its lane in the batcher's bucket.  A kept answer
is a copy of the program's relation made on the card when it is kept, so
the window waits for nothing.  Afterwards each kept answer's distinct rows
are compared with the reference's, computed from the same triples and the
same query JSON.  The numbers compared: the answers that differ (limit 0:
an exact comparison), the queries the program failed to answer (limit 0),
and the requests due in the window that never got a fate at all (limit 0).

The control (``control_rows``) breaks the guarantee that answers are
complete: it is the reference's answer cut at the rows a worker's starting
capacity class holds, as an engine that skipped its overflow retry would
return.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "answer_of", "answer_from_rows", "canon",
           "canon_answer", "diff_canon", "control_rows", "CONTROL_CAPACITY"]

#: rows a worker's relation holds before its first overflow retry
#: (``AdHashEngine(capacity=1 << 12)``, the engine's default)
CONTROL_CAPACITY = 1 << 12


class Sampler:
    """One answer a stratum, drawn uniformly from ``rng`` (a reservoir).

    ``offer`` takes the answer as a function that makes the copy to keep,
    called only when the draw keeps it."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.kept: dict[tuple, tuple] = {}
        self.seen: dict[tuple, int] = {}

    def offer(self, stratum: tuple, query: dict, make) -> None:
        n = self.seen.get(stratum, 0) + 1
        self.seen[stratum] = n
        if n == 1 or int(self.rng.integers(n)) == 0:
            self.kept[stratum] = (query, make())

    def items(self):
        for stratum in sorted(self.kept, key=repr):
            yield (stratum, *self.kept[stratum])


def answer_of(rel) -> tuple:
    """A copy of a relation kept for the comparison: ``(variable names,
    cols (W, cap, k), valid (W, cap))`` on the relation's device.  A
    relation the batched path returns is a view of its bucket's tensors;
    the copy frees the bucket."""
    return [v.name for v in rel.vars], rel.cols.clone(), rel.valid.clone()


def answer_from_rows(names: list[str], rows: np.ndarray) -> tuple:
    """An answer of host rows, in the form ``answer_of`` gives."""
    import torch

    rows = torch.from_numpy(np.asarray(rows, np.int64).reshape(
        len(rows), len(names)))
    return list(names), rows[None], torch.ones(rows.shape[:1],
                                               dtype=torch.bool)[None]


def _words(rows: np.ndarray, bits: int) -> np.ndarray:
    """Rows packed into as few int64 words as ``bits`` per id allows."""
    n, k = rows.shape
    per = max(63 // bits, 1)
    words = []
    for j in range(0, k, per):
        w = np.zeros(n, dtype=np.int64)
        for c in range(j, min(j + per, k)):
            w = (w << bits) | rows[:, c]
        words.append(w)
    return np.stack(words, axis=1) if words else np.zeros((n, 0), np.int64)


def canon(rows: np.ndarray, bits: int) -> np.ndarray:
    """The distinct rows, packed and sorted: two answers are equal as sets
    exactly where their canons are equal arrays."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size and rows.min() < 0:
        raise ValueError("an answer binds a negative id")
    w = _words(rows, bits)
    if w.shape[1] == 1:
        return np.unique(w[:, 0])[:, None]
    w = w[np.lexsort(w.T[::-1])]
    keep = np.ones(len(w), dtype=bool)
    keep[1:] = (w[1:] != w[:-1]).any(axis=1)
    return w[keep]


def canon_answer(answer: tuple, order: list[str], bits: int) -> np.ndarray:
    """``canon`` of a kept answer's valid rows, its columns in ``order``,
    worked out where the answer lies (on the card after the window): the
    same packing and order as ``canon``, so the two compare as arrays."""
    import torch

    names, cols, valid = answer
    rows = cols[valid][:, [names.index(v) for v in order]].to(torch.int64)
    if rows.numel() and int(rows.min()) < 0:
        raise ValueError("an answer binds a negative id")
    n, k = rows.shape
    per = max(63 // bits, 1)
    words = []
    for j in range(0, k, per):
        w = torch.zeros(n, dtype=torch.int64, device=rows.device)
        for c in range(j, min(j + per, k)):
            w = (w << bits) | rows[:, c]
        words.append(w)
    if not words:
        return np.zeros((n, 0), np.int64)
    w = torch.stack(words, dim=1)
    for c in reversed(range(w.shape[1])):  # lexicographic, first word first
        w = w[torch.sort(w[:, c], stable=True).indices]
    keep = torch.ones(len(w), dtype=torch.bool, device=w.device)
    keep[1:] = (w[1:] != w[:-1]).any(dim=1)
    return w[keep].cpu().numpy()


def diff_canon(got: np.ndarray, want: np.ndarray, bits: int,
               packed: bool = False) -> tuple[int, int]:
    """(rows missing from ``got``, rows ``got`` has in excess): ``got`` an
    answer's rows (or, with ``packed``, their ``canon``), ``want`` the
    reference's ``canon``, both of the same variables in the same order."""
    a = got if packed else canon(got, bits)
    if a.shape == want.shape and np.array_equal(a, want):
        return 0, 0
    both = np.concatenate([a, want], axis=0)
    _, inv, cnt = np.unique(both, axis=0, return_inverse=True,
                            return_counts=True)
    common = int((cnt[inv.reshape(-1)[:len(a)]] == 2).sum())
    return len(want) - common, len(a) - common


def control_rows(rows: np.ndarray, n_workers: int,
                 capacity: int = CONTROL_CAPACITY) -> np.ndarray:
    """The reference's answer as a run without overflow retry returns it:
    its distinct rows, at most ``capacity`` a worker."""
    rows = np.asarray(rows, dtype=np.int64)
    if len(rows) == 0:
        return rows
    distinct = np.unique(rows, axis=0)
    return distinct[:n_workers * capacity]
