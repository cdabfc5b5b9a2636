"""Atomic, async-capable checkpointing, and the AdHash master's recoverable
state (DESIGN §9, paper §3.1 "Failure Recovery").

PyTorch port of ``repro.checkpoint.checkpoint``, with the same on-disk
format, so a snapshot written by either package restores in the other:

  * ``save`` / ``restore_latest`` write one flat ``.npz`` per array tree
    (dicts, lists or tuples of tensors or numpy arrays; leaf names are the
    tree path joined by ``/``, as the reference names them) plus a JSON
    manifest (``format: 1``).  Writes go to a temp directory, fsynced, then
    ``os.replace``-d into place (atomic on POSIX), so a crash mid-save
    never corrupts the latest step.  An optional background thread writes
    while the caller continues.  Restore casts each leaf to the dtype of
    the tree it is restored into and puts tensors on a given device; there
    is no mesh to re-place onto.  bfloat16 leaves are stored as float32
    (exact) since numpy has no bfloat16.
  * ``save_engine_state``: dictionary + statistics (read-only, saved
    once), the placement table, and the **append-only** query log the PI
    replay needs (offset-tracked — a mid-workload save appends only the new
    suffix, never truncates).  Queries are stored as JSON, so a log crosses
    packages.
  * ``save_adaptivity`` / ``restore_adaptivity`` snapshot the *full*
    adaptivity state (heat map, pattern-index structure + LRU clock,
    replica module contents, placement table) in one atomically published
    directory: ``manifest.json`` and ``replicas.npz`` with
    ``"{sid}/{leaf}"`` names.  Restore onto the same W is bit-identical;
    onto a different W the replica state is dropped and the query log
    replays from the start — the paper's pay-as-you-go recovery — while
    the placement table re-derives base shards under the new modulus.
    On a mesh substrate every rank gathers each replica module's worker
    blocks and writes the whole snapshot (each into its own directory);
    restore places the modules through the engine's substrate
    (``shard_store``), so each rank keeps its own block.

The port has no tuned-kernel table yet (ROADMAP.md §1 item 11): its
manifest writes ``"tuned": {}`` and its snapshot holds no ``tuned/``
directory.  ``restore_adaptivity`` ignores ``tuned`` in both packages, so a
reference snapshot that carries one restores here all the same.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_STORE_LEAVES = ("spo_ps", "keys_ps", "spo_po", "keys_po", "counts")


def _atomic_publish(src, dst) -> None:
    """The atomic-rename chokepoint (``os.replace``).  Module-level so the
    fault-injection harness (``repro_torch.runtime.fault_injection``) can
    crash a save *between* writing the data and publishing it — the
    scenario the atomicity claim is about."""
    os.replace(src, dst)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _items(tree: Any):
    """(name, child) pairs in the reference's flattening order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_names(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    items = _items(tree)
    if items is None:
        return {prefix: _to_host(tree)}
    flat: dict[str, np.ndarray] = {}
    for name, child in items:
        flat.update(_flatten_with_names(
            child, f"{prefix}/{name}" if prefix else name))
    return flat


def _unflatten_like(tree: Any, flat: dict[str, np.ndarray], device,
                    prefix: str = "") -> Any:
    items = _items(tree)
    if items is None:
        arr = flat[prefix]
        if tuple(arr.shape) != tuple(tree.shape):
            raise ValueError(
                f"checkpoint leaf {prefix}: shape {arr.shape} != "
                f"{tuple(tree.shape)}"
            )
        if isinstance(tree, torch.Tensor):
            dev = tree.device if device is None else torch.device(device)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=dev, dtype=tree.dtype)
        return arr.astype(np.asarray(tree).dtype)
    out = {name: _unflatten_like(child, flat, device,
                                 f"{prefix}/{name}" if prefix else name)
           for name, child in items}
    if isinstance(tree, dict):
        return {k: out[str(k)] for k in tree}
    return type(tree)(out[str(i)] for i in range(len(tree)))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        # lines already persisted to query_log.jsonl (append-only offset);
        # lazily initialized from the file so a restarted master keeps
        # appending where the crashed one stopped
        self._log_persisted: int | None = None

    # ------------------------------------------------------------------ save
    def save(self, params: Any, opt_state: Any, step: int,
             extra: dict | None = None) -> None:
        # snapshot to the host first, then write (in the background when
        # async, so the caller continues)
        host_p = _flatten_with_names(params)
        host_o = _flatten_with_names(opt_state)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(host_p, host_o, step, extra)
            )
            self._thread.start()
        else:
            self._write(host_p, host_o, step, extra)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, host_p: dict, host_o: dict, step: int,
               extra: dict | None) -> None:
        tmp = self.dir / f".tmp_step{step}"
        final = self.dir / f"step{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "params.npz", **host_p)
        np.savez(tmp / "opt.npz", **host_o)
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "format": 1,
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        _atomic_publish(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step*"))
        for old in steps[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = sorted(self.dir.glob("step*"))
        if not steps:
            return None
        return int(steps[-1].name[4:])

    def restore_latest(self, params_like: Any, opt_like: Any,
                       device: str | torch.device | None = None):
        """Restore into the structure of (params_like, opt_like): each leaf
        takes its like-leaf's dtype; tensor leaves go to ``device`` (default:
        the like-leaf's device), numpy leaves stay numpy."""
        step = self.latest_step()
        if step is None:
            return None
        d = self.dir / f"step{step:010d}"
        with np.load(d / "params.npz") as z:
            params = _unflatten_like(params_like, dict(z), device)
        with np.load(d / "opt.npz") as z:
            opt = _unflatten_like(opt_like, dict(z), device)
        return params, opt, step

    # --------------------------------------- AdHash master state (paper §3.1)
    def save_engine_state(self, engine, query_log: list) -> None:
        """Master recovery state (DESIGN §9): dictionary + statistics are
        read-only and saved once; the placement table is snapshotted on
        every call (it grows as the rebalancer splits hot keys); the query
        log — what the heat map / PI replay needs — is persisted
        **append-only** with offset tracking: ``query_log`` is the full
        in-memory log, and only the suffix beyond what is already on disk
        is written (then fsynced)."""
        from repro_torch.core.query import Query

        if engine.dictionary is not None:
            engine.dictionary.save(str(self.dir / "dictionary.json"))
        self.save_placement(engine.placement)
        n = self._log_lines_on_disk()
        if len(query_log) < n:
            raise ValueError(
                f"query log shrank: {len(query_log)} entries passed but "
                f"{n} already persisted — the log is append-only"
            )
        if len(query_log) == n:
            return
        with open(self.dir / "query_log.jsonl", "a") as f:
            for q in query_log[n:]:
                payload = q.to_json() if isinstance(q, Query) else q
                f.write(json.dumps(payload) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._log_persisted = len(query_log)

    def _log_lines_on_disk(self) -> int:
        if self._log_persisted is None:
            p = self.dir / "query_log.jsonl"
            self._log_persisted = (
                sum(1 for _ in p.open()) if p.exists() else 0
            )
        return self._log_persisted

    def load_query_log(self) -> list:
        """The persisted query log, as ``Query`` objects (raw entries from
        pre-serialization logs pass through unchanged)."""
        from repro_torch.core.query import Query

        p = self.dir / "query_log.jsonl"
        if not p.exists():
            return []
        out = []
        for line in p.read_text().splitlines():
            d = json.loads(line)
            out.append(
                Query.from_json(d)
                if isinstance(d, dict) and "patterns" in d else d
            )
        return out

    # ---------------------------------------------------- placement snapshot
    def save_placement(self, placement) -> None:
        """Atomically persist the placement table (DESIGN §9: part of the
        master's recoverable state — under a directory policy the exception
        table is what makes the restored store layout match)."""
        from repro_torch.core.placement import placement_state

        tmp = self.dir / ".tmp_placement.json"
        with open(tmp, "w") as f:
            json.dump(placement_state(placement), f)
            f.flush()
            os.fsync(f.fileno())
        _atomic_publish(tmp, self.dir / "placement.json")

    def load_placement(self, n_workers: int | None = None):
        """Rebuild the persisted placement policy (or None when no snapshot
        exists).  ``n_workers`` re-derives base shards for an elastic
        restore onto a different W."""
        from repro_torch.core.placement import placement_from_state

        p = self.dir / "placement.json"
        if not p.exists():
            return None
        return placement_from_state(json.loads(p.read_text()), n_workers)

    # ----------------------------------------- full adaptivity snapshot
    def save_adaptivity(self, engine, step: int) -> None:
        """Snapshot the engine's *entire* adaptivity state in one atomically
        published directory: heat map (counts, Boyer-Moore metadata, clock),
        pattern-index structure (specializations, storage ids, LRU
        timestamps, clock), every replica module's five tensors, and the
        placement table.

        The manifest records how many query-log lines the snapshot covers
        (``n_queries_logged``), so a restore replays only the suffix."""
        from repro_torch.core.placement import placement_state

        tmp = self.dir / f".tmp_adaptivity{step}"
        final = self.dir / f"adaptivity{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        arrays: dict[str, np.ndarray] = {}
        modules = {}
        for sid, st in engine.replicas.modules.items():
            # every worker's block: on a mesh each rank gathers the module
            # and writes the whole snapshot, as each reference process does
            for name, leaf in zip(_STORE_LEAVES, st.host_leaves()):
                arrays[f"{sid}/{name}"] = leaf
            modules[sid] = {"n_ids": int(st.n_ids)}
        np.savez(tmp / "replicas.npz", **arrays)

        manifest = {
            "step": step,
            "time": time.time(),
            "format": 1,
            "n_workers": engine.w,
            "n_queries_logged": self._log_lines_on_disk(),
            "heatmap": engine.heatmap.to_state(),
            "pattern_index": engine.pattern_index.to_state(),
            "placement": placement_state(engine.placement),
            "replica_modules": modules,
            "replica_next_id": engine.replicas.next_id_n,
            "tuned": {},  # no tuned-kernel table in the port yet
        }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        _atomic_publish(tmp, final)
        # keep only the newest adaptivity snapshot (same policy as _gc)
        for old in sorted(self.dir.glob("adaptivity*"))[:-1]:
            shutil.rmtree(old, ignore_errors=True)

    def load_adaptivity(self) -> dict | None:
        """The newest adaptivity snapshot's manifest, or None."""
        snaps = sorted(self.dir.glob("adaptivity*"))
        if not snaps:
            return None
        manifest = json.loads((snaps[-1] / "manifest.json").read_text())
        manifest["_dir"] = str(snaps[-1])
        return manifest

    def restore_adaptivity(self, engine) -> int:
        """Restore the newest adaptivity snapshot into ``engine``; returns
        the query-log offset already covered by the restored state (the
        caller replays ``log[offset:]``).

        Same W: full bit-identical restore — heat map, PI (with LRU clock),
        replica modules put on the engine's device and placed through its
        substrate.  Different W (elastic): the worker-indexed state (PI +
        replica modules) is dropped and offset 0 is returned — replaying
        the whole log rebuilds them on the new W, the paper's pay-as-you-go
        recovery.  ``tuned`` is ignored."""
        from repro_torch.core.heatmap import HeatMap
        from repro_torch.core.pattern_index import PatternIndex
        from repro_torch.core.triples import ShardedTripleStore

        manifest = self.load_adaptivity()
        if manifest is None:
            return 0
        if int(manifest["n_workers"]) != engine.w:
            return 0  # elastic restore: replay rebuilds heat map + PI
        engine.heatmap = HeatMap.from_state(manifest["heatmap"])
        engine.pattern_index = PatternIndex.from_state(
            manifest["pattern_index"]
        )
        engine.replicas.next_id_n = int(manifest["replica_next_id"])
        snap_dir = Path(manifest["_dir"])
        with np.load(snap_dir / "replicas.npz") as z:
            for sid, meta in manifest["replica_modules"].items():
                store = ShardedTripleStore.from_numpy(
                    *(z[f"{sid}/{name}"] for name in _STORE_LEAVES),
                    n_ids=int(meta["n_ids"]), device=engine.device,
                )
                engine.replicas.put(sid, engine.substrate.shard_store(store))
        return int(manifest["n_queries_logged"])
