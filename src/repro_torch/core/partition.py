"""Initial data partitioning (paper §3.1, "Data Partitioner").

PyTorch port of ``repro.core.partition`` (the hash used by the engine).
AdHash hash-partitions triples on the subject: triple t goes to worker
``H(t.subject) mod W`` under the default placement policy
(``repro_torch.core.placement``).  The paper's footnote uses
``subject mod W``; the mixed hash keeps the same locality property while
being robust to structured id assignment.
"""
from __future__ import annotations

import numpy as np

from .placement import splitmix64_np

__all__ = ["hash_ids"]


def hash_ids(ids: np.ndarray, mix: bool = True) -> np.ndarray:
    """Vectorized 64-bit integer mix (splitmix64 finalizer), non-negative;
    ``mix=False`` is the paper's plain ``subject mod W`` id."""
    if not mix:
        return np.asarray(ids, dtype=np.int64)
    return splitmix64_np(ids)
