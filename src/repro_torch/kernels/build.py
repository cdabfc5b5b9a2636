"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

The kernels are compiled at first use on the machine with the card: one
``nvcc`` per source, all started together, into object files for
``sm_90a``, then linked into one shared library with a plain C interface
that ``ctypes`` loads.  The library goes into ``repro_torch/_build`` under a
name keyed by the sources' hash and the build's flags, so an unchanged tree
reuses it and an edited source rebuilds.  A failed build raises; nothing
falls back.

The tiles come from the tuned table (``kernels/tuning.py``, platform
``sm90``): each entry is a ``-D`` flag, and each source keeps its own
constant behind ``#ifndef``.  The wrappers size scratch by the same tiles,
read through ``tiles()`` from the table the loaded library was built with,
never apart from it.

Nothing here runs when the module is imported: the CPU tests import every
module and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple

from . import tuning

__all__ = ["SOURCES", "BWD_T_PAD", "Tiles", "build", "built_table",
           "defines", "library", "build_log", "check", "tiles"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("probe.cu", "expand.cu", "bucket.cu", "compact.cu", "flash_attn.cu",
           "flash_attn_sm90.cu", "flash_attn_bwd.cu", "flash_attn_bwd_sm90.cu")
#: headers the sources include: hashed with them, so an edited header rebuilds
_HEADERS = ("common.cuh", "sm90.cuh")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
#: threads of a card-wide scan block (kScanThreads in csrc/common.cuh) and
#: of a radix pass block (kThreads in csrc/compact.cu)
_SCAN_THREADS = 1024
_RADIX_THREADS = 256
#: the tuned table's entry -> the macro the sources read it from
_DEFINES = {("scan", "items"): "ADHASH_SCAN_ITEMS",
            ("unique_compact", "items"): "ADHASH_RADIX_ITEMS"}
#: T is padded to this in the attention backward's rows of L and D (kPad in
#: csrc/flash_attn_bwd_sm90.cu, whose bulk copies read a row's tiles whole);
#: the wrapper sizes that scratch with it
BWD_T_PAD = 128

_lib: ctypes.CDLL | None = None
_lib_table: dict[str, dict[str, int]] | None = None


class Tiles(NamedTuple):
    """The tiles the wrappers size scratch with."""

    scan: int   # rows per tile of the card-wide scans (kScanTile)
    radix: int  # keys per tile of unique_compact's radix passes (kTile)


def _build_table() -> dict[str, dict[str, int]]:
    """A copy of the current sm90 table (the loader's is cached, shared)."""
    return {k: dict(v) for k, v in
            tuning.tuned_table(tuning.BUILD_PLATFORM).items()}


def defines(table: dict[str, dict[str, int]]) -> list[str]:
    """The ``-D`` flags of a tuned table."""
    return [f"-D{macro}={int(table[kernel][key])}"
            for (kernel, key), macro in _DEFINES.items()]


def built_table() -> dict[str, dict[str, int]]:
    """The tuned table the loaded library was built with (loading it)."""
    library()
    return {k: dict(v) for k, v in _lib_table.items()}


def _tiles(table: dict[str, dict[str, int]]) -> Tiles:
    return Tiles(_SCAN_THREADS * int(table["scan"]["items"]),
                 _RADIX_THREADS * int(table["unique_compact"]["items"]))


def tiles() -> Tiles:
    """The tiles of the loaded library (the table its build used), loading
    it first."""
    library()
    return _tiles(_lib_table)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# exported symbol -> argtypes (every function returns a cudaError_t as int)
_SIGNATURES = {
    "adhash_range_search_i64": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "adhash_range_search_i32": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _P],
    "adhash_expand": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _P],
    "adhash_bucket_by_dest": [_P, _P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L,
                              _I, _P],
    "adhash_unique_compact_i32": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                                  _L, ctypes.c_int32, _P],
    "adhash_unique_compact_i64": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _L,
                                  _L, ctypes.c_int64, _P],
    "adhash_flash_attn_f32": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I,
                              _I, _L, _L, _P],
    "adhash_flash_attn_bf16": [_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I,
                               _I, _L, _L, _P],
    "adhash_flash_attn_bwd_f32": [_P] * 10 + [_I, _L, _L, _I, _I, _I, _I,
                                              _L, _L, _P],
    "adhash_flash_attn_bwd_bf16": [_P] * 10 + [_I, _L, _L, _I, _I, _I, _I,
                                               _L, _L, _P],
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels can only be built where the CUDA "
            "toolkit is installed"
        )
    return found


def _digest(table: dict[str, dict[str, int]]) -> str:
    """The build key: the sources, the headers and every flag."""
    h = hashlib.sha256()
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_ARCH + _FLAGS + defines(table)).encode())
    return h.hexdigest()[:16]


def build(*, table: dict[str, dict[str, int]] | None = None) -> Path:
    """Compile the kernels with ``table``'s tiles (default: the current
    sm90 table; ``library()`` passes the one it records), or reuse an
    up-to-date build; returns the shared library's path.  Raises
    RuntimeError when a compile fails."""
    table = _build_table() if table is None else table
    digest = _digest(table)
    out = BUILD_DIR / f"libadhash_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *_ARCH, *_FLAGS, *defines(table), "-Xptxas", "-v",
                 "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES, objs)
        ]
        logs = []
        failed = []
        for src, proc in zip(SOURCES, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src} (rc={proc.returncode})\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / f"build_{digest}.log").write_text(log)
        os.replace(tmp_lib, out)
    return out


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills per kernel) of the loaded (else the current) build, if this tree
    built it."""
    table = _build_table() if _lib_table is None else _lib_table
    path = BUILD_DIR / f"build_{_digest(table)}.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use with the current sm90
    table, which ``tiles()`` reads from then on."""
    global _lib, _lib_table
    if _lib is None:
        table = _build_table()
        lib = ctypes.CDLL(str(build(table=table)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.adhash_expand_scratch_bytes.argtypes = [_I, _L, _L]
        lib.adhash_expand_scratch_bytes.restype = ctypes.c_int64
        lib.adhash_bucket_scratch_bytes.argtypes = [_I, _L, _I]
        lib.adhash_bucket_scratch_bytes.restype = ctypes.c_int64
        _lib, _lib_table = lib, table
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
