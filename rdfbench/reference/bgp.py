"""A straightforward evaluator of basic graph patterns over a triple array.

Each pattern is matched by slicing the triples of its predicate (sorted
once by predicate) and filtering on its constants; the patterns are then
joined one at a time, the smallest connected one next, by sorting the
pattern's rows on the shared variables and expanding each binding's range.
The answer is every binding of the query's variables (sorted by name),
duplicates included: ``check.canon`` takes the distinct rows.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TripleIndex", "evaluate"]


class TripleIndex:
    """The triples sorted by predicate, with each predicate's row range."""

    def __init__(self, triples: np.ndarray):
        t = np.asarray(triples, dtype=np.int64)
        self.triples = t[np.argsort(t[:, 1], kind="stable")]
        preds = self.triples[:, 1]
        self._preds = preds

    def rows(self, s, p, o) -> np.ndarray:
        """The triples matching the constants given (None: a variable)."""
        t = self.triples
        if p is not None:
            lo, hi = np.searchsorted(self._preds, [p, p + 1])
            t = t[lo:hi]
        keep = np.ones(len(t), dtype=bool)
        if s is not None:
            keep &= t[:, 0] == s
        if o is not None:
            keep &= t[:, 2] == o
        return t if keep.all() else t[keep]


def _term(t: dict):
    return ("v", t["v"]) if "v" in t else ("c", int(t["c"]))


def _match(index: TripleIndex, pattern: list[dict]
           ) -> tuple[list[str], np.ndarray]:
    """A pattern's bindings: (variables, (n, len(variables)) int64)."""
    terms = [_term(t) for t in pattern]
    consts = [v if k == "c" else None for k, v in terms]
    rows = index.rows(*consts)
    names: list[str] = []
    cols: list[int] = []
    for col, (kind, v) in enumerate(terms):
        if kind != "v":
            continue
        if v in names:  # a repeated variable, as in (?x p ?x)
            rows = rows[rows[:, cols[names.index(v)]] == rows[:, col]]
        else:
            names.append(v)
            cols.append(col)
    return names, rows[:, cols]


def _codes(left: np.ndarray, right: np.ndarray
           ) -> tuple[np.ndarray, np.ndarray]:
    """One int64 code per row of the shared columns, equal across the two
    sides exactly where the rows are equal: the ids packed side by side
    where they fit in 63 bits, else each distinct row's rank."""
    if left.shape[1] == 1:
        return left[:, 0], right[:, 0]
    hi = max(int(left.max(initial=0)), int(right.max(initial=0)))
    bits = max(hi.bit_length(), 1)
    if bits * left.shape[1] <= 63 and min(left.min(initial=0),
                                          right.min(initial=0)) >= 0:
        def pack(x):
            code = np.zeros(len(x), dtype=np.int64)
            for c in range(x.shape[1]):
                code = (code << bits) | x[:, c]
            return code
        return pack(left), pack(right)
    both = np.concatenate([left, right], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    return inv[:len(left)], inv[len(left):]


def _join(lvars, lrows, rvars, rrows):
    shared = [v for v in rvars if v in lvars]
    if not shared:
        raise ValueError("the reference joins only connected patterns")
    lk, rk = _codes(lrows[:, [lvars.index(v) for v in shared]],
                    rrows[:, [rvars.index(v) for v in shared]])
    order = np.argsort(rk, kind="stable")
    rk = rk[order]
    lo = np.searchsorted(rk, lk, side="left")
    hi = np.searchsorted(rk, lk, side="right")
    counts = hi - lo
    left_idx = np.repeat(np.arange(len(lk)), counts)
    starts = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    right_idx = order[starts + np.arange(len(left_idx))]
    extra = [i for i, v in enumerate(rvars) if v not in lvars]
    out = np.concatenate([lrows[left_idx], rrows[right_idx][:, extra]],
                         axis=1)
    return lvars + [rvars[i] for i in extra], out


def evaluate(index: TripleIndex, query: dict) -> tuple[list[str], np.ndarray]:
    """``(variables sorted by name, rows)`` of a query given as JSON."""
    tables = [_match(index, pat) for pat in query["patterns"]]
    todo = sorted(range(len(tables)), key=lambda i: len(tables[i][1]))
    first = todo.pop(0)
    names, rows = list(tables[first][0]), tables[first][1]
    while todo:
        nxt = next((i for i in todo if set(tables[i][0]) & set(names)), None)
        if nxt is None:
            raise ValueError("the reference evaluates connected queries only")
        todo.remove(nxt)
        names, rows = _join(names, rows, *tables[nxt])
    out = sorted(names)
    return out, rows[:, [names.index(v) for v in out]]
