"""Data generators, one module per family of deployments.

A configuration names its generator (``"generator": "lubm"`` loads
``gen/lubm.py``).  A generator module exposes ``generate(params, seed)``,
which returns ``(triples, layout)``: an ``(N, 3)`` int64 array of distinct
triples and whatever ``templates(layout)`` needs to place the query
templates' constants.  ``templates(layout)`` returns ``{name: Template}``.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

__all__ = ["Template", "load", "rng"]


@dataclass(frozen=True)
class Template:
    """A query template as plain data.

    ``patterns`` holds ``(s, p, o)`` triples whose terms are a variable
    name (``"?x"``), an integer id, or ``"$"`` for the template's constant.
    ``constants`` is the half-open id range ``[lo, hi)`` the constant is
    drawn from uniformly, or None for a template without one."""

    name: str
    patterns: tuple[tuple, ...]
    constants: tuple[int, int] | None = None

    def instantiate(self, const: int | None) -> dict:
        """The query as JSON (``{"v": name}`` / ``{"c": id}`` terms), the
        form both the program's ``Query.from_json`` and the reference
        read."""
        def term(t):
            if t == "$":
                return {"c": int(const)}
            if isinstance(t, str):
                return {"v": t.lstrip("?")}
            return {"c": int(t)}

        return {"name": self.name,
                "patterns": [[term(t) for t in pat] for pat in self.patterns]}


def load(name: str):
    """The generator module ``gen/<name>.py``."""
    return importlib.import_module(f"rdfbench.gen.{name}")


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use (data, traffic, sampling) of a
    run's seed; any whole number is a seed, negative and above 64 bits
    included."""
    return np.random.default_rng([seed % (1 << 64), stream])
