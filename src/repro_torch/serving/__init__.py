"""Online serving front-end for the AdHash engine (DESIGN §10).

PyTorch port of ``repro.serving``: the same admission, batching, shedding
and brownout decisions in the same order, so a stream served by either
package on the same virtual timeline gives the same ledger.

Continuous batching under a latency SLO with admission control (bounded
queue + per-client token buckets -> ``RetryAfter`` backpressure),
deadline-based load shedding (``SheddedResult``, never silently late), a
brownout ladder that sheds adaptivity work before queries, degraded-mesh
tightening, and periodic adaptivity checkpointing — all on an injected
clock so every behaviour is deterministically testable without sleeping.
"""
from .admission import AdmissionController, BrownoutController, TokenBucket
from .arrivals import open_loop_arrivals, replay_open_loop
from .loop import ServeConfig, ServeLoop
from .request import (Request, RetryAfter, ServedResult, ServeReport,
                      SheddedResult)

__all__ = [
    "AdmissionController", "BrownoutController", "TokenBucket",
    "open_loop_arrivals", "replay_open_loop",
    "ServeConfig", "ServeLoop",
    "Request", "RetryAfter", "ServedResult", "ServeReport", "SheddedResult",
]
