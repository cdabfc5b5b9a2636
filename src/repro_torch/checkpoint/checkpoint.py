"""Atomic, async-capable checkpointing, and the AdHash master's recoverable
state (DESIGN §9, paper §3.1 "Failure Recovery").

PyTorch port of ``repro.checkpoint.checkpoint``, with the same on-disk
format, so a snapshot written by either package restores in the other:

  * ``save`` / ``restore_latest`` write one flat ``.npz`` per array tree
    (dicts, lists or tuples of tensors or numpy arrays; leaf names are the
    tree path joined by ``/``, as the reference names them) plus a JSON
    manifest (``format: 1``).  The LM-training pair is the port's ``LM``
    and ``OptState``: the ``LM`` is written as the reference's parameter
    tree (``models.convert.params_to_numpy``: ``embed/table``,
    ``blocks/attn/wq`` stacked over the layers, ...) and a NamedTuple's
    fields as JAX names them (``.step``, ``.m/blocks/attn/wq``), so a
    checkpoint written by either package's train CLI restores in the
    other.  An ``LM`` and an ``OptState`` restore in place (their tensors
    are overwritten, so a full-size restore needs no second copy on the
    card); other trees restore into new arrays.  Writes go to a temp
    directory, fsynced, then ``os.replace``-d into place (atomic on
    POSIX), so a crash mid-save never corrupts the latest step.  An
    optional background thread writes while the caller continues.
    Restore casts each leaf to the dtype of the tree it is restored into
    and puts tensors on a given device.  bfloat16 leaves are stored as
    float32 (exact) since numpy has no bfloat16.

    On a mesh (an ``LM`` that ``launch.shardings.place`` placed: its
    ``placement``), every rank calls ``save``: each leaf cut over
    ``model`` (and its ``OptState`` moments, cut alike) is gathered back
    to its whole shape, only rank 0 writes, synchronously, and every rank
    waits on a barrier until the step is published; so a checkpoint holds
    whole leaves whatever mesh wrote it.  ``restore_latest(...,
    mesh=, specs=)`` is the elastic restore: it places a module not yet
    placed (``place(params, mesh, specs)``), then each rank reads the
    whole leaves and copies its slice of each into the module and the
    moments, in place, so a step saved on one mesh shape restores onto
    another.
  * ``save_engine_state``: dictionary + statistics (read-only, saved
    once), the placement table, and the **append-only** query log the PI
    replay needs (offset-tracked — a mid-workload save appends only the new
    suffix, never truncates).  Queries are stored as JSON, so a log crosses
    packages.
  * ``save_adaptivity`` / ``restore_adaptivity`` snapshot the *full*
    adaptivity state (heat map, pattern-index structure + LRU clock,
    replica module contents, placement table, tuned kernel table) in one
    atomically published directory: ``manifest.json``, ``replicas.npz``
    with ``"{sid}/{leaf}"`` names and ``tuned/<platform>.json``.  Restore
    onto the same W is bit-identical; onto a different W the replica state
    is dropped and the query log
    replays from the start — the paper's pay-as-you-go recovery — while
    the placement table re-derives base shards under the new modulus.
    On a mesh substrate every rank gathers each replica module's worker
    blocks and writes the whole snapshot (each into its own directory);
    restore places the modules through the engine's substrate
    (``shard_store``), so each rank keeps its own block.

The tuned table is the port's (``repro_torch.kernels.tuning``, keyed by
the CUDA kernels' tiles) for the engine's platform: on the card ``"sm90"``
with the table the loaded kernel library was built with, on the CPU
``"cpu"``; it is written in the loader's own format under ``tuned/`` and under
``"tuned"`` in the manifest, as the reference writes its platform's.
``restore_adaptivity`` ignores it in both packages, so snapshots cross
either way; point ``ADHASH_TUNED_DIR`` at ``<snapshot>/tuned`` to build
the kernels with it.
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

from repro_torch.models.convert import params_to_numpy, ref_path
from repro_torch.models.collectives import axis_rank, axis_size

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


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree: Any):
    """(name, child) pairs in the reference's flattening order: dict keys
    sorted, a NamedTuple's fields as ``.field`` (JAX's ``GetAttrKey``),
    sequences by index."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _flatten_with_names(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    if isinstance(tree, torch.nn.Module):
        tree = params_to_numpy(tree)
    items = _items(tree)
    if items is None:
        return {prefix: _to_host(tree)}
    flat: dict[str, np.ndarray] = {}
    for name, child in items:
        flat.update(_flatten_with_names(child, _join(prefix, name)))
    return flat


def _placement(tree: Any):
    """The placement of a placed module, else None."""
    if isinstance(tree, torch.nn.Module):
        return getattr(tree, "placement", None)
    return None


def _moment_dims(placement) -> dict[str, int]:
    """Flat name of each cut leaf in the reference's tree (the moments'
    structure) -> the dimension its stacked tensor is cut along."""
    out = {}
    for name, dim in placement.cut.items():
        path, layer = ref_path(name)
        out["/".join(path)] = dim + (layer is not None)
    return out


def _whole_tree(tree: Any, dims: dict[str, int], group, prefix: str = ""):
    """A moments tree with each cut leaf gathered over ``group``."""
    from repro_torch.launch.shardings import gather_cut

    if isinstance(tree, dict):
        return {k: _whole_tree(v, dims, group, _join(prefix, str(k)))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_whole_tree(v, dims, group, _join(prefix, str(i)))
                for i, v in enumerate(tree)]
    return tree if prefix not in dims else gather_cut(tree, dims[prefix],
                                                      group)


def _whole(params: Any, opt_state: Any) -> tuple[Any, Any]:
    """(params, opt_state) with every leaf cut over ``model`` joined back
    to its whole shape (a collective a cut leaf); a placed module with cut
    leaves becomes a mapping of its parameter names to whole tensors."""
    from repro_torch.launch.shardings import gather_whole
    from repro_torch.models.collectives import axis_group

    placement = _placement(params)
    if placement is None or not placement.cut:
        return params, opt_state
    whole = gather_whole(dict(params.named_parameters()), placement)
    if _is_namedtuple(opt_state) and hasattr(opt_state, "m"):
        dims = _moment_dims(placement)
        group = axis_group(placement.mesh, "model")
        opt_state = opt_state._replace(
            m=_whole_tree(opt_state.m, dims, group),
            v=_whole_tree(opt_state.v, dims, group))
    return whole, opt_state


def _narrow(arr: np.ndarray, dim: int, placement) -> np.ndarray:
    """This rank's slice of a whole leaf along ``dim`` over ``model``."""
    m = axis_size(placement.mesh, "model")
    r = axis_rank(placement.mesh, "model")
    size = arr.shape[dim] // m
    index = [slice(None)] * arr.ndim
    index[dim] = slice(r * size, (r + 1) * size)
    return arr[tuple(index)]


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # ascontiguousarray makes a 0-d array 1-d: keep the leaf's shape
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))


def _check_shape(name: str, arr: np.ndarray, like) -> None:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {name}: shape {arr.shape} != "
                         f"{tuple(like.shape)}")


@torch.no_grad()
def _restore_module(module: torch.nn.Module, flat, prefix: str
                    ) -> torch.nn.Module:
    """Copy the reference-named leaves into the module's parameters (a
    placed module's cut ones: this rank's slice)."""
    placement = _placement(module)
    stacked: dict[str, np.ndarray] = {}
    for pname, p in module.named_parameters():
        path, layer = ref_path(pname)
        name = _join(prefix, "/".join(path))
        if name not in stacked:
            stacked[name] = flat[name]
        arr = stacked[name] if layer is None else stacked[name][layer]
        if placement is not None and pname in placement.cut:
            arr = _narrow(arr, placement.cut[pname], placement)
        _check_shape(pname, arr, p)
        p.copy_(_tensor(arr))
    return module


def _unflatten_like(tree: Any, flat, device, prefix: str = "",
                    in_place: bool = False, cut=None) -> Any:
    """``cut``: (placement, flat name -> dim) of the leaves a rank holds a
    slice of."""
    if isinstance(tree, torch.nn.Module):
        return _restore_module(tree, flat, prefix)
    items = _items(tree)
    if items is None:
        arr = flat[prefix]
        if cut is not None and prefix in cut[1]:
            arr = _narrow(arr, cut[1][prefix], cut[0])
        _check_shape(prefix, arr, tree)
        if isinstance(tree, torch.Tensor):
            src = _tensor(arr)
            if in_place:
                with torch.no_grad():
                    return tree.copy_(src)
            dev = tree.device if device is None else torch.device(device)
            return src.to(device=dev, dtype=tree.dtype)
        return arr.astype(np.asarray(tree).dtype)
    in_place = in_place or _is_namedtuple(tree)
    out = {name: _unflatten_like(child, flat, device, _join(prefix, name),
                                 in_place, cut)
           for name, child in items}
    if isinstance(tree, dict):
        return {k: out[str(k)] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(out[f".{f}"] for f in tree._fields))
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
        """Write (params, opt_state) as step ``step``.  A placed module's
        every rank calls it: the leaves are gathered whole, rank 0 writes
        and all wait until the step is published (module docstring)."""
        placement = _placement(params)
        if placement is not None:
            import torch.distributed as dist

            params, opt_state = _whole(params, opt_state)
            if dist.get_rank() == 0:
                if not isinstance(params, torch.nn.Module):
                    params = params_to_numpy(params)
                self._write(_flatten_with_names(params),
                            _flatten_with_names(opt_state), step, extra)
            dist.barrier()
            return
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
                       device: str | torch.device | None = None, *,
                       mesh=None, specs=None):
        """Restore into the structure of (params_like, opt_like): each leaf
        takes its like-leaf's dtype.  An ``LM`` and a NamedTuple state
        (``OptState``) are overwritten in place on their own device; other
        tensor leaves go to ``device`` (default: the like-leaf's device),
        numpy leaves stay numpy.  With ``mesh``, an ``LM`` not yet placed is
        placed by ``specs`` (default ``param_specs(params_like, mesh)``), and
        each rank copies its slice of every cut leaf and of its moments
        (the reference's ``shardings``: the elastic restore)."""
        step = self.latest_step()
        if step is None:
            return None
        if mesh is not None and isinstance(params_like, torch.nn.Module) \
                and _placement(params_like) is None:
            from repro_torch.launch.shardings import param_specs, place

            place(params_like, mesh,
                  specs if specs is not None else
                  param_specs(params_like, mesh))
        placement = _placement(params_like)
        cut = None
        if placement is not None and placement.cut:
            dims = _moment_dims(placement)
            cut = (placement, {f"{f}/{n}": d for n, d in dims.items()
                               for f in (".m", ".v")})
        d = self.dir / f"step{step:010d}"
        with np.load(d / "params.npz") as z:
            params = _unflatten_like(params_like, z, device)
        with np.load(d / "opt.npz") as z:
            opt = _unflatten_like(opt_like, z, device, cut=cut)
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
        timestamps, clock), every replica module's five tensors, the
        placement table, and the tuned kernel table for the engine's
        platform.

        The manifest records how many query-log lines the snapshot covers
        (``n_queries_logged``), so a restore replays only the suffix."""
        from repro_torch.core.placement import placement_state
        from repro_torch.kernels import build, tuning

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

        # tuned kernel table, in the loader's own on-disk format: a restored
        # master builds with it by pointing ADHASH_TUNED_DIR at
        # <snapshot>/tuned.  On the card it is the table the loaded kernel
        # library was built with; the CPU builds no kernel, and its "cpu"
        # table is written for the reference's format alone.
        if torch.device(engine.device).type == "cuda":
            platform, table = tuning.BUILD_PLATFORM, build.built_table()
        else:
            platform, table = "cpu", tuning.tuned_table("cpu")
        tuned_dir = tmp / "tuned"
        tuned_dir.mkdir()
        (tuned_dir / f"{platform}.json").write_text(json.dumps(
            {"platform": platform, "kernels": table},
            indent=2, sort_keys=True,
        ) + "\n")

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
            "tuned": {platform: table},
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
        recovery.  The tuned kernel table travels in the snapshot and is
        not read here; point ``ADHASH_TUNED_DIR`` at ``<snapshot>/tuned``
        to build with it."""
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
