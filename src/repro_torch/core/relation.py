"""Fixed-capacity sharded relations (intermediate results).

PyTorch port of ``repro.core.relation``.  A Relation is the stand-in for
the paper's per-worker intermediate result sets RS: a (W, cap, k) int32
binding table plus a (W, cap) validity mask, where column j binds variable
``vars[j]``.  Padded rows are -1/invalid.  On a mesh substrate a rank
holds its worker block and the relation carries the substrate as ``mesh``;
the host views gather every rank's block (the reference's
``fetch_global``), so each rank sees the whole answer.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .query import Var

__all__ = ["Relation"]


@dataclass
class Relation:
    cols: torch.Tensor  # (W, cap, k) int32 bindings
    valid: torch.Tensor  # (W, cap) bool
    vars: tuple[Var, ...]  # variable bound by each column
    # the MeshSubstrate whose rank holds this worker block (None: all of W)
    mesh: object = field(default=None, repr=False, compare=False)

    def col_of(self, v: Var) -> int:
        return self.vars.index(v)

    # ------------------------------------------------------------ host utils
    def to_numpy(self) -> np.ndarray:
        """All valid binding rows concatenated across workers (host-side)."""
        if self.mesh is None:
            cols, valid = self.cols.cpu().numpy(), self.valid.cpu().numpy()
        else:
            cols = self.mesh.fetch_global(self.cols)
            valid = self.mesh.fetch_global(self.valid)
        return cols[valid]

    def to_set(self) -> set[tuple[int, ...]]:
        return {tuple(int(x) for x in row) for row in self.to_numpy()}

    def project_to(self, var_order: list[Var]) -> np.ndarray:
        """Host-side projection in a requested variable order (tests)."""
        idx = [self.col_of(v) for v in var_order]
        return self.to_numpy()[:, idx]
