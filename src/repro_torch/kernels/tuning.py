"""Per-platform tuned tile table of the hand-written CUDA kernels.

The port's counterpart of ``repro.kernels.tuning``.  The Pallas kernels take
grid block sizes at dispatch; the CUDA kernels take their tiles at compile
time, so the table is keyed by what the CUDA sources take and each entry
becomes a ``-D`` flag of the build (``kernels/build.py``):

  scan            items  kScanItems (csrc/common.cuh): elements a thread of
                         the card-wide scans takes; the scan tile is
                         kScanThreads (1024) x items
  unique_compact  items  kItems (csrc/compact.cu): keys a thread of the
                         radix passes takes; the radix tile is 256 x items

The table lives in ``repro_torch/kernels/tuned/<platform>.json``, where the
platform is the card's arch (``"sm90"``, the arch ``build.py`` compiles for)
or ``"cpu"``.  No table is checked in: ``DEFAULTS`` are the sources' own
constants, so the default build makes the kernels the sources define.
``ADHASH_TUNED_DIR`` overrides the directory, resolved on every call; only
the file load is cached.  An unreadable table gives the defaults, never an
error.  The reference's autotune sweep is benchmark code and has no
counterpart here.
"""
from __future__ import annotations

import functools
import json
import os
from pathlib import Path


__all__ = [
    "BUILD_PLATFORM",
    "DEFAULTS",
    "block_config",
    "tuned_table",
    "tuned_path",
    "save_tuned",
]

#: the platform the kernel library is built for (``-arch sm_90a``)
BUILD_PLATFORM = "sm90"

#: the sources' own constants (the untuned build)
DEFAULTS: dict[str, dict[str, int]] = {
    "scan": {"items": 8},
    "unique_compact": {"items": 16},
}


def tuned_path(platform: str | None = None) -> Path:
    """Location of the per-platform tuned table (JSON); the default
    platform is the build's."""
    platform = platform or BUILD_PLATFORM
    base = os.environ.get("ADHASH_TUNED_DIR")
    root = Path(base) if base else Path(__file__).parent / "tuned"
    return root / f"{platform}.json"


def tuned_table(platform: str | None = None) -> dict[str, dict[str, int]]:
    """DEFAULTS overlaid with the platform's persisted table.

    The env-dependent path is resolved on every call (so a late
    ``ADHASH_TUNED_DIR`` override is honored); only the file load is
    cached, keyed by the resolved path."""
    return _load_table(str(tuned_path(platform)))


@functools.lru_cache(maxsize=None)
def _load_table(path_str: str) -> dict[str, dict[str, int]]:
    cfg = {k: dict(v) for k, v in DEFAULTS.items()}
    path = Path(path_str)
    if path.exists():
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return cfg  # unreadable table -> untuned defaults, never crash
        for kernel, blocks in data.get("kernels", {}).items():
            cfg.setdefault(kernel, {}).update(
                {k: int(v) for k, v in blocks.items()}
            )
    return cfg


def block_config(kernel: str, platform: str | None = None) -> dict[str, int]:
    """Tuned (or default) tiles of one kernel on this platform."""
    table = tuned_table(platform)
    if kernel not in table:
        raise KeyError(
            f"unknown kernel {kernel!r}; known: {sorted(table)}"
        )
    return dict(table[kernel])


def save_tuned(
    kernels: dict[str, dict[str, int]],
    platform: str | None = None,
    meta: dict | None = None,
) -> Path:
    """Persist a table for ``platform`` and drop the lookup cache."""
    path = tuned_path(platform)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"platform": platform or BUILD_PLATFORM, "kernels": kernels}
    if meta:
        payload["meta"] = meta
    path.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    _load_table.cache_clear()
    return path
