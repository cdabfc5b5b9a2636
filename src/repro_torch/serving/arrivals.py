"""Open-loop arrival schedules and the virtual-clock stream replay.

PyTorch port of ``repro.serving.arrivals``.  Arrival gaps come from
numpy's ``default_rng(seed).exponential`` and ``np.cumsum``, as in the
reference, so a schedule is bit-identical to the reference's for the same
seed.  Open-loop means arrival times are drawn independently of service
times — the client population does not slow down because the server is
slow.  That is the regime where admission control and shedding matter: a
closed-loop client population self-throttles and can never expose the
overload behaviour the SLO story is about (offered load = 2x saturation).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .loop import ServeLoop
from .request import Request, RetryAfter

__all__ = ["open_loop_arrivals", "replay_open_loop"]


def open_loop_arrivals(queries, rate_qps: float, *, start_s: float = 0.0,
                       seed: int = 0, clients=("c0",), process="poisson",
                       slo_s: float | None = None) -> list[Request]:
    """Stamp ``queries`` with open-loop arrival times at ``rate_qps``.

    ``process`` is ``"poisson"`` (exponential gaps — the bursty default that
    actually stresses queues) or ``"uniform"`` (constant gaps).  Clients are
    assigned round-robin; ``slo_s`` pre-stamps per-request deadlines
    (otherwise the serve loop applies its configured default)."""
    n = len(queries)
    if process == "poisson":
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate_qps, size=n)
    elif process == "uniform":
        gaps = np.full(n, 1.0 / rate_qps)
    else:
        raise ValueError(f"unknown arrival process {process!r}")
    times = start_s + np.cumsum(gaps)
    return [
        Request(rid=i, query=q, client=clients[i % len(clients)],
                arrival_s=float(t),
                deadline_s=None if slo_s is None else float(t) + slo_s)
        for i, (q, t) in enumerate(zip(queries, times))
    ]


def replay_open_loop(loop: ServeLoop, arrivals: list[Request]
                     ) -> tuple[list, list[RetryAfter]]:
    """Drive a pre-stamped arrival schedule through a serve loop on its
    (virtual) clock: between arrivals the loop works, jumping idle gaps via
    ``next_due``; each request is offered at its arrival time (or as soon
    as the server's clock gets there — queueing delay under overload counts
    against the SLO because ``arrival_s`` stays the true arrival).

    When the server falls behind (a pump charges more time than one
    inter-arrival gap), every arrival inside the elapsed window is offered
    *before* the next pump — exactly like clients hammering a busy server —
    so the bounded queue actually fills and admission control / brownout
    engage under overload instead of the replay politely serializing.

    Returns ``(completions, rejections)``: every admitted request resolves
    to a ``ServedResult`` or ``SheddedResult`` in ``completions`` (the
    stream is drained at the end), rejected ones to ``RetryAfter``."""
    completions: list = []
    rejections: list[RetryAfter] = []
    pending = deque(sorted(arrivals, key=lambda r: r.arrival_s))
    while pending:
        now = loop.clock.now()
        while pending and pending[0].arrival_s <= now:
            verdict = loop.offer(pending.popleft())
            if verdict is not None:
                rejections.append(verdict)
        if not pending:
            break
        completions.extend(loop.pump())
        now = loop.clock.now()
        if pending[0].arrival_s <= now:
            continue   # the pump's charged time covered more arrivals
        nxt = loop.next_due()
        target = pending[0].arrival_s
        if nxt is not None and now < nxt < target:
            loop.clock.advance_to(nxt)   # due work before the next arrival
        else:
            loop.clock.advance_to(target)
    completions.extend(loop.drain())
    return completions, rejections
