"""The kernels' least traffic, the card's peak, and the census of launches.

A launch is keyed by its kernel and the shapes of its operands, which is
all the bytes it must move depend on: each input byte read once, each
output byte written once, whatever the kernel reads again.  Where the
least traffic depends on the data (a binary search reads a path of keys,
not every key), the count takes the least the shapes allow, so a share of
the roofline never passes 100% by counting too much.

``Census`` replaces the four wrappers of the port's DSJ kernels in their
modules (the engine's modules import them at each call) by ones that count
each launch by key and, in a traced run, open a profiler range named
``rdfbench.kernel.<kernel>`` around it, so the device time of everything
the wrapper launched can be summed from the trace.
"""
from __future__ import annotations

import math
from collections import Counter
from contextlib import contextmanager

__all__ = ["HBM_BYTES_PER_S", "launch_bytes", "bound_s", "Census"]

#: NVIDIA H100 SXM5 80 GB, data sheet: 3.35 TB/s of HBM3 at 700 W
HBM_BYTES_PER_S = 3.35e12


def _log2(n: int) -> int:
    return math.ceil(math.log2(max(n, 2)))


def launch_bytes(key: tuple) -> int:
    """Least bytes a launch moves, from its census key."""
    kernel, shape = key[0], dict(key[1:])
    w = shape["rows"]
    if kernel in ("range_search", "span_search"):
        n, m, isz = shape["N"], shape["M"], shape["itemsize"]
        arrays = 1 if kernel == "range_search" else 2
        keys_read = min(n, m * _log2(n))  # a search path of keys a probe
        return w * keys_read * isz + arrays * w * m * isz + 2 * w * m * 4
    if kernel == "expand":  # lo and hi once, 9 bytes a lane, the totals
        return 2 * w * shape["n"] * 4 + w * shape["out_cap"] * 9 + w * 8
    if kernel == "bucket_by_dest":
        # every row's valid flag; the whole send buffer and its flags; the
        # most wanted (a valid row's value and destination need not be
        # counted: the share of valid rows is data)
        cells = w * shape["n_dest"] * shape["cap_peer"]
        return w * shape["n"] + cells * (4 * shape["k"] + 1) + w * 8
    if kernel == "unique_compact":  # values and flags in, uniq and mask out
        isz = shape["itemsize"]
        return (w * shape["n"] * (isz + 1) + w * shape["out_cap"] * (isz + 1)
                + w * 8)
    raise KeyError(kernel)


def bound_s(key: tuple) -> float:
    """Least seconds a launch takes on the card: its bytes at HBM speed
    (every DSJ kernel is bound by bytes)."""
    return launch_bytes(key) / HBM_BYTES_PER_S


def _probe_key(name):
    def key(keys, probes, *_):
        return (name, ("rows", keys.shape[0]), ("N", keys.shape[1]),
                ("M", probes.shape[1]), ("itemsize", keys.element_size()))
    return key


_KEYS = {
    ("semijoin.probe", "range_search_cuda"): _probe_key("range_search"),
    ("semijoin.probe", "span_search_cuda"): _probe_key("span_search"),
    ("relalg_ops.expand", "expand_cuda"): lambda lo, hi, out_cap: (
        "expand", ("rows", lo.shape[0]), ("n", lo.shape[1]),
        ("out_cap", int(out_cap))),
    ("relalg_ops.bucket", "bucket_by_dest_cuda"):
        lambda values, dest, valid, n_dest, cap_peer, *_: (
            "bucket_by_dest", ("rows", values.shape[0]),
            ("n", values.shape[1]), ("k", values.shape[2]),
            ("n_dest", int(n_dest)), ("cap_peer", int(cap_peer))),
    ("relalg_ops.compact", "unique_compact_cuda"):
        lambda values, valid, out_cap, pad: (
            "unique_compact", ("rows", values.shape[0]),
            ("n", values.shape[1]), ("out_cap", int(out_cap)),
            ("itemsize", values.element_size())),
}


def kernel_of(key: tuple) -> str:
    """The kernel a key belongs to (span_search is range_search's)."""
    return "range_search" if key[0] == "span_search" else key[0]


class Census:
    """Launches by key while installed: ``counts`` since the last
    ``mark()``, ``before`` every key counted before it."""

    def __init__(self):
        self.counts: Counter = Counter()
        self.before: set = set()
        self.annotate = False

    def mark(self) -> None:
        """Start a new count (the window's); remember the keys seen."""
        self.before |= set(self.counts)
        self.counts = Counter()

    def new_keys(self) -> list[tuple]:
        return sorted(k for k in self.counts if k not in self.before)

    @contextmanager
    def installed(self):
        import importlib

        import torch

        originals = {}
        for (mod, name), key in _KEYS.items():
            module = importlib.import_module(f"repro_torch.kernels.{mod}")
            originals[(module, name)] = fn = getattr(module, name)
            setattr(module, name, self._counting(torch, fn, key))
        try:
            yield self
        finally:
            for (module, name), fn in originals.items():
                setattr(module, name, fn)

    def _counting(self, torch, fn, key_of):
        def wrapper(*args):
            key = key_of(*args)
            self.counts[key] += 1
            if not self.annotate:
                return fn(*args)
            with torch.profiler.record_function(
                    f"rdfbench.kernel.{kernel_of(key)}"):
                return fn(*args)
        return wrapper
