"""Sharding rules: parameter, batch and cache specs, and the placement of a
model's parameters on a mesh.

PyTorch port of ``repro.launch.shardings``.  The rules are the reference's,
name and path based, over the reference's tree of each leaf:

  vocab tables      ('model', None)        row (vocab) sharded
  LM head           (None, 'model')
  QKV / FFN-in      (None, 'model')        TP column-parallel
  attn-out / FFN-out('model', None)        TP row-parallel
  MoE expert stacks ('model', None, None)  EP over experts
  SSM mixers        replicated
  norms / scalars   replicated

Stacked-layer leading axes are never sharded; an axis is used only where
it divides the dimension (``_fits``).  A spec is a tuple with one entry a
dimension: ``None``, an axis name, or a tuple of axis names (the
reference's ``PartitionSpec`` entries).  ``param_specs`` keys them by the
leaf's path in the reference's tree (``convert.ref_path``: the port's
``blocks.3.attn.wq`` is leaf ``("blocks", "attn", "wq")``, stacked), so a
test can hold them to the reference's leaf by leaf; ``cache_specs`` keys
the cache's leaves by their paths likewise.

``place(params, mesh, specs)`` is the counterpart of ``named`` plus
``jax.device_put``.  The port keeps activations, and so the dense layers,
replicated in this slice (tensor-parallel dense layers: ROADMAP §1 item
12d.2), which computes what GSPMD computes.  So only a leaf that a
per-shard body consumes is laid out as its spec says: the embedding
table's rows over ``model`` (``embedding.adaptive_embed`` serves the cold
rows this rank owns; the plain lookup runs the reference's
vocab-parallel lowering over them, and the tied LM head gathers them).  The expert stacks stay
whole on every rank, since a replica slot of the hot-expert plan reads an
expert another rank owns; ``moe_sharded.moe_ffn_sharded`` gathers only this
rank's slots of them, each call.  Every other leaf is replicated.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.models.collectives import axis_rank, axis_size
from repro_torch.models.common import ModelConfig

from .mesh import batch_axes

__all__ = ["param_specs", "batch_specs", "cache_specs", "place", "leaves",
           "Stats"]

# parameter-name -> spec for the *trailing* dims (leading dims replicated)
_LAST2 = {
    "table": ("model", None),
    "tok": ("model", None),
    "out": (None, "model"),
    "wq": (None, "model"),
    "wk": (None, "model"),
    "wv": (None, "model"),
    "w1": (None, "model"),
    "w3": (None, "model"),
    "w_y": (None, "model"),
    "w_x": (None, "model"),
    "w_i": (None, "model"),
    "w_r": (None, "model"),
    "in_proj": (None, "model"),
    "wo": ("model", None),
    "w2": ("model", None),
    "w_o": ("model", None),
    "out_proj": ("model", None),
    "conv": (None, "model"),
}
_BIAS_MODEL = {"bq", "bk", "bv", "lam", "norm_g"}
_REPLICATED = {"router", "enc_pos", "dec_pos", "projector"}
_MOE3 = {"w1", "w3", "w2"}  # under a 'moe' path: (E, D, F) expert stacks


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def leaves(tree, path: tuple[str, ...] = ()):
    """(path, leaf) of every leaf of a tree of dicts and lists, in order; a
    list index is a path name, as in the reference's key paths.  A leaf is
    a tensor, an array or a shape tuple."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    else:
        yield path, tree


def _sizes(mesh) -> dict[str, int]:
    if mesh is None:
        return {}
    return {a: axis_size(mesh, a) for a in mesh.mesh_dim_names}


def _fits(tail: tuple, shape: tuple, sizes: dict) -> bool:
    """Argument shardings require divisibility."""
    off = len(shape) - len(tail)
    return all(ax is None or shape[off + i] % sizes.get(ax, 1) == 0
               for i, ax in enumerate(tail))


def _spec_for(names: tuple[str, ...], shape: tuple[int, ...],
              sizes: dict) -> tuple:
    name = names[-1] if names else ""
    nd = len(shape)
    replicated = (None,) * nd

    def fit(*cands):
        for tail in cands:
            if len(tail) <= nd and _fits(tail, shape, sizes):
                return (None,) * (nd - len(tail)) + tuple(tail)
        return replicated

    if "ssm" in names:  # SSM mixers replicated (DP-only family)
        return replicated
    if name in _REPLICATED or any(n in _REPLICATED for n in names):
        return replicated
    if "moe" in names and name in _MOE3 and nd >= 3:
        # EP over experts; fall back to TP inside experts if E not divisible
        if name == "w2":  # (E, F, D)
            return fit(("model", None, None), (None, "model", None))
        return fit(("model", None, None), (None, None, "model"))
    if name in _LAST2 and nd >= 2:
        return fit(_LAST2[name])
    if name in _BIAS_MODEL and nd >= 1:
        return fit(("model",))
    return replicated


def param_specs(params, mesh=None) -> dict[tuple[str, ...], tuple]:
    """{reference path: spec} for every leaf of the reference's tree of
    ``params`` (an ``LM``, a ``Whisper``, or a tree of shapes as
    ``convert.ref_shapes`` gives).  ``mesh`` enables the divisibility
    fallbacks; without it the rules assume divisibility."""
    from repro_torch.models.convert import ref_shapes

    tree = params if isinstance(params, dict) else ref_shapes(params)
    sizes = _sizes(mesh)
    return {path: _spec_for(path, _shape(leaf), sizes)
            for path, leaf in leaves(tree)}


def _bspec(mesh, global_batch: int):
    """The batch dimension's entry: its data axes, one axis by its name,
    none as None (``PartitionSpec`` reads an empty tuple as None)."""
    dp = batch_axes(mesh, global_batch)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def batch_specs(cfg: ModelConfig, mesh, shape, kind: str) -> dict:
    """Input specs for one (arch, shape) cell."""
    bspec = _bspec(mesh, shape.global_batch)
    if kind in ("train", "prefill"):
        out = {"tokens": (bspec, None), "labels": (bspec, None)}
        if cfg.family == "vlm":
            out["patches"] = (bspec, None, None)
        if cfg.family == "audio":
            out["frames"] = (bspec, None, None)
        return out
    out = {"tokens": (bspec, None), "pos": ()}
    if cfg.family == "audio":
        out["enc"] = (bspec, None, None)
    return out


def _cache_leaf_spec(names: tuple[str, ...], shape: tuple[int, ...],
                     mesh, global_batch: int) -> tuple:
    """KV caches: (L, B, T, KV, hd) -- batch on data axes; the sequence
    axis on 'model' when KV heads don't cover the model axis; recurrent
    states: batch-sharded only."""
    nd = len(shape)
    bspec = _bspec(mesh, global_batch)
    m = axis_size(mesh, "model")
    if names and names[-1] in ("k_scale", "v_scale"):
        # (L, B, T, KV) or (B, T, KV) quantization scales: follow the cache
        spec = [None] * nd
        spec[nd - 3] = bspec
        if shape[nd - 2] % m == 0:
            spec[nd - 2] = "model"
        return tuple(spec)
    if names and names[0] in ("kv", "attn") or (names and
                                                 names[-1] in ("k", "v")):
        if nd in (4, 5):  # (L,) B, T, KV, hd
            lead = (None,) if nd == 5 else ()
            t, kvh = shape[-3], shape[-2]
            if kvh % m == 0 and kvh >= m:
                return lead + (bspec, None, "model", None)
            if t % m == 0:
                return lead + (bspec, "model", None, None)  # SP on cache
            return lead + (bspec, None, None, None)
    # recurrent / conv states: shard whichever leading dim is the batch
    for i in range(min(nd, 2)):
        if shape[i] == global_batch:
            return (None,) * i + (bspec,) + (None,) * (nd - i - 1)
    return (None,) * nd


def cache_specs(cache, cfg: ModelConfig, mesh, global_batch: int
                ) -> dict[tuple[str, ...], tuple]:
    """{cache path: spec} for every leaf of a decode cache."""
    return {path: _cache_leaf_spec(path, _shape(leaf), mesh, global_batch)
            for path, leaf in leaves(cache)}


def place(params: nn.Module, mesh, specs: dict[tuple[str, ...], tuple]
          ) -> nn.Module:
    """Put ``params`` on the mesh's device, in place, and return it.  The
    embedding table is cut to this rank's rows where its spec shards them
    over ``model`` (``params.embed.mesh`` then names the mesh); every other
    leaf stays whole (module docstring)."""
    from repro_torch.models.convert import ref_path

    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    params.to(dev)
    embed = getattr(params, "embed", None)
    if embed is not None and getattr(embed, "mesh", None) is None:
        path, _ = ref_path("embed.table")
        if specs[path][0] == "model":
            m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
            t = embed.table
            rows = t.shape[0] // m
            embed.table = nn.Parameter(
                t.detach()[r * rows:(r + 1) * rows].clone(),
                requires_grad=t.requires_grad)
            embed.mesh = mesh
    return params


class Stats:
    """Small helper: parameter/bytes accounting for reports."""

    @staticmethod
    def bytes_of(tree: Any) -> int:
        """Bytes of a module's parameters, or of a tree's tensors."""
        ts = (tree.parameters() if isinstance(tree, nn.Module)
              else (x for _, x in leaves(tree)))
        return sum(t.numel() * t.element_size() for t in ts)
