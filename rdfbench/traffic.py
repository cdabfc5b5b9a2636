"""The one traffic generator: a mix file's parameters to a query stream.

A mix (``traffic/<mix>.json``) gives:

  loop        ``"closed"`` (``clients`` outstanding queries, all answered
              by one ``query_batch`` call a round) or ``"open"`` (arrivals
              at ``rate_per_s`` on the wall clock, served by ``ServeLoop``)
  templates   ``{name: weight}``; with ``rotate_every`` the weights are by
              rank, ``1 / rank ** zipf``, and the ranking (the key order)
              moves one place every ``rotate_every`` queries
  block       queries drawn as a set: each block holds every template in
              proportion to its weight (largest remainders), so every seed
              sends the same work in another order; in a closed loop a
              block's split into rounds of ``clients`` is the same for
              every seed too (the batch sizes), and the seed orders the
              rounds; with ``rotate_every``, a block is one rotation period
  max_per_round  at most this many queries of one template in a round of
              ``clients`` (a batch's size class stays where set-up warmed
              it); a block must be whole rounds
  slo_s, batch_target, queue_bound, max_wait_s   the serving loop's
              settings (open); ``warmup_s``: seconds of a warm stream
              through it before the window
  warmup_queries  closed: queries of a warm stream before the window (an
              adaptive engine warms on its own traffic; a non-adaptive one
              runs each template at each batch size class instead)

Open-loop gaps are drawn the same way: each block's gaps are the
exponential distribution's quantiles at (j + 1/2) / block, shuffled, so a
block's arrivals are Poisson in distribution and every seed's sum to the
same time.  Constants are uniform over the template's id range.
"""
from __future__ import annotations

import numpy as np

from rdfbench.gen import Template

__all__ = ["Stream"]

#: the stream, apart from every seed's, that splits a closed block into rounds
ROUNDS = 0x524F554E


def _counts(weights: np.ndarray, n: int) -> np.ndarray:
    """n split in proportion to weights, by largest remainders."""
    share = weights / weights.sum() * n
    counts = np.floor(share).astype(np.int64)
    rest = n - int(counts.sum())
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[:rest]] += 1
    return counts


class Stream:
    """The queries of one run, as JSON (the form the program's
    ``Query.from_json`` and the reference read), made block by block."""

    def __init__(self, mix: dict, templates: dict[str, Template],
                 rng: np.random.Generator):
        self.mix = mix
        self.names = list(mix["templates"])
        missing = [n for n in self.names if n not in templates]
        if missing:
            raise KeyError(f"templates {missing} not in the configuration's "
                           f"generator")
        self.templates = templates
        self.rng = rng
        self.block = int(mix["block"])
        self.rotate = mix.get("rotate_every")
        if self.rotate is not None and int(self.rotate) != self.block:
            raise ValueError("a rotating mix draws one block a period: "
                             "block must equal rotate_every")
        self._queue: list[dict] = []
        self._gaps: list[float] = []
        self._blocks = 0

    # ------------------------------------------------------------ templates
    def _weights(self, period: int) -> np.ndarray:
        w = np.array([float(self.mix["templates"][n]) for n in self.names])
        if self.rotate is None:
            return w
        t = len(self.names)
        ranked = 1.0 / np.arange(1, t + 1) ** float(self.mix["zipf"])
        # the template at rank r in this period: names[(r + period) % t]
        return ranked[(np.arange(t) - period) % t]

    def _refill(self) -> None:
        counts = _counts(self._weights(self._blocks), self.block)
        names = np.repeat(np.arange(len(self.names)), counts)
        if self.mix["loop"] == "closed":
            # a block's split into rounds (the batch sizes) is the same for
            # every seed; the seed orders the rounds
            clients = int(self.mix["clients"])
            np.random.default_rng([self._blocks, ROUNDS]).shuffle(names)
            cap = self.mix.get("max_per_round")
            if cap is not None:
                names = _cap_rounds(names, clients, int(cap))
            rounds = names.reshape(-1, clients)
            names = rounds[self.rng.permutation(len(rounds))].reshape(-1)
        else:
            self.rng.shuffle(names)
        for i in names:
            tpl = self.templates[self.names[i]]
            const = (None if tpl.constants is None else
                     int(self.rng.integers(*tpl.constants)))
            self._queue.append(tpl.instantiate(const))
        if self.mix["loop"] == "open":
            q = (np.arange(self.block) + 0.5) / self.block
            gaps = -np.log1p(-q) / float(self.mix["rate_per_s"])
            self.rng.shuffle(gaps)
            self._gaps.extend(gaps.tolist())
        self._blocks += 1

    def take(self, n: int) -> list[dict]:
        """The next n queries."""
        while len(self._queue) < n:
            self._refill()
        out, self._queue = self._queue[:n], self._queue[n:]
        self._gaps = self._gaps[n:] if self.mix["loop"] == "open" else []
        return out

    def arrivals(self, seconds: float) -> list[tuple[float, dict]]:
        """Open loop: ``(due offset s, query)`` of every arrival due in
        [0, seconds)."""
        out: list[tuple[float, dict]] = []
        t = 0.0
        while True:
            if not self._gaps:
                self._refill()
            t += self._gaps[0]
            if t >= seconds:
                return out
            out.append((t, self.take(1)[0]))


def _cap_rounds(names: np.ndarray, size: int, cap: int) -> np.ndarray:
    """Reorder a block so that no round of ``size`` holds more than ``cap``
    of one template: an excess query swaps with a query of another round
    of the block whose template this round has room for, and which has
    room for it."""
    names = names.copy()
    n_t = int(names.max()) + 1
    rounds = [slice(r, min(r + size, len(names)))
              for r in range(0, len(names), size)]
    count = [np.bincount(names[r], minlength=n_t) for r in rounds]
    for a, ra in enumerate(rounds):
        for i in range(ra.start, ra.stop):
            t = names[i]
            if count[a][t] <= cap:
                continue
            for b, rb in enumerate(rounds):
                j = next((j for j in range(rb.start, rb.stop)
                          if count[a][names[j]] < cap
                          and names[j] != t), None) \
                    if b != a and count[b][t] < cap else None
                if j is not None:
                    u = names[j]
                    names[i], names[j] = u, t
                    count[a][t] -= 1
                    count[a][u] += 1
                    count[b][u] -= 1
                    count[b][t] += 1
                    break
            else:
                raise ValueError(f"cannot keep {cap} a round of {size}: "
                                 f"the block is too uneven")
    return names
