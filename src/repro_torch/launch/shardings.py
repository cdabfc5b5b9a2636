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
``jax.device_put``: it cuts each leaf over ``model`` as its spec says,
where the port's per-rank layers compute with the cut, and keeps it whole
(replicated) where they cannot; activations stay replicated over
``model`` and the cut layers run Megatron style (``models.collectives``):

  embed.table, tok     rows (``embedding.vocab_lookup``: the
                       vocab-parallel lookup, and ``adaptive_embed``'s
                       owned rows)
  LM head              embed.out by columns, a tied table by its rows:
                       vocab-parallel logits, the loss's log-sum-exp
                       from them (``transformer.chunked_nll``), decode
                       logits gathered at the end of a step
  attention            wq, bq by columns and wo by rows, on whole query
                       heads; wk, wv, bk, bv by columns where the KV heads
                       split over ``model`` (``models.attention``; the
                       hybrid family's windowed MQA and whisper's self-
                       and cross-attention too)
  SwiGLU (mlp, and     w1, w3 by columns, w2 by rows
  moe.shared)
  GeLU MLP (whisper)   w1 by columns, w2 by rows; b1 and b2 whole, as the
                       spec keeps them (``models.mlp``)
  RG-LRU (hybrid)      w_y, w_x, conv, w_i, w_r by columns, lam by
                       channels, w_o by rows; the recurrence per channel
                       (``models.rglru``)
  moe expert stacks    over the experts, or within each expert's hidden
                       width where E does not divide (60 experts over 8)

Kept whole although the spec cuts them:

  * a cut that is not on whole heads: wq/bq/wo where H does not split
    over ``model`` (then the whole layer: whisper-tiny's 6 heads over 4),
    wk/wv/bk/bv where KV does not (recurrentgemma-2b's single KV head,
    llama3-8b's 8 over 16); and a layer whose query heads' KV heads are
    not a whole run of heads;
  * a cut of the stacked layer axis (the reference cuts the (L, D, F)
    shared-expert stacks over layers where L divides and the width does
    not: qwen2-moe's smoke config at ``model`` 2).

Whisper-tiny's ``tok`` (51,865 rows, odd) stays whole on every mesh by
the spec itself, as do the vlm ``projector``, whisper's ``enc_pos`` and
``dec_pos``, the norms, and the ssm family's mixers.  A cut RG-LRU's
decode state holds this rank's channels (``transformer.init_lm_cache``
with the placed params), where the reference's ``cache_specs`` keeps it
replicated over ``model``: no rank reads another rank's channels.

``Placement`` (``params.placement``) records the mesh and each cut leaf's
dimension: ``gather_whole`` joins cut leaves back to their whole shape (the
checkpoint's save, the tests), the checkpoint's restore takes each rank's
slice of a whole one, and the optimizer's global norm sums a cut leaf's
squares over ``model``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn

from repro_torch.models.attention import Attention, AttnTP
from repro_torch.models.collectives import axis_group, axis_rank, axis_size
from repro_torch.models.common import ModelConfig
from repro_torch.models.mlp import GeLUMLP, SwiGLU
from repro_torch.models.moe import MoE, MoETP
from repro_torch.models.rglru import RGLRU

from .mesh import batch_axes

__all__ = ["param_specs", "batch_specs", "cache_specs", "place", "leaves",
           "Placement", "gather_cut", "gather_whole", "Stats"]

#: the families whose layers ``place`` cuts (the ssm family's spec keeps
#: its mixers whole)
TP_FAMILIES = ("dense", "moe", "vlm", "hybrid", "audio")

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


@dataclass
class Placement:
    """The mesh a module is placed on and each cut parameter's dimension
    (port parameter name -> dim of this rank's slice), over ``model``."""

    mesh: Any
    cut: dict[str, int] = field(default_factory=dict)


def _device(mesh) -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if mesh.device_type == "cuda" else torch.device("cpu"))


def _layer_spec(specs: dict, name: str) -> tuple | None:
    """The spec of port parameter ``name`` over its own dimensions; None
    where the reference's cuts its stacked layer axis."""
    from repro_torch.models.convert import ref_path

    path, layer = ref_path(name)
    spec = specs[path]
    if layer is None:
        return tuple(spec)
    return None if spec[0] is not None else tuple(spec[1:])


def _cuts(specs: dict, prefix: str, names, dims: tuple[int, ...]) -> bool:
    """Whether each of ``names`` (parameters under ``prefix``; None entries
    skipped) has its spec cut exactly dimension ``dims[i]`` over model."""
    for n, dim in zip(names, dims):
        if n is None:
            continue
        spec = _layer_spec(specs, f"{prefix}{n}")
        if spec is None or spec[dim] != "model" or \
                any(a is not None for i, a in enumerate(spec) if i != dim):
            return False
    return True


def _cut(module: nn.Module, name: str, dim: int, m: int, r: int) -> None:
    t = getattr(module, name)
    size = t.shape[dim] // m
    part = t.detach().narrow(dim, r * size, size).clone()
    setattr(module, name, nn.Parameter(part, requires_grad=t.requires_grad))


def _cut_all(module: nn.Module, prefix: str, names, dims, m: int, r: int,
             cut: dict) -> None:
    """``_cut`` each of ``names`` (None entries skipped) along its dim, and
    record it in ``cut``."""
    for n, dim in zip(names, dims):
        if n is not None:
            _cut(module, n, dim, m, r)
            cut[f"{prefix}{n}"] = dim


def _place_attention(mod: Attention, prefix: str, specs, cfg, mesh, m, r,
                     cut: dict) -> None:
    hd = cfg.hd
    h, kv = mod.wq.shape[1] // hd, mod.wk.shape[1] // hd
    bias = mod.bq is not None
    q_names = ("wq", "bq" if bias else None, "wo")
    kv_names = ("wk", "wv", "bk" if bias else None, "bv" if bias else None)
    if h % m or not _cuts(specs, prefix, q_names, (1, 0, 0)):
        return
    h_loc, g = h // m, h // kv
    kv_cut = kv % m == 0 and _cuts(specs, prefix, kv_names, (1, 1, 0, 0))
    if kv_cut:
        lo, hi = r * (kv // m), (r + 1) * (kv // m)
    else:  # the KV heads of query heads [r h_loc, (r + 1) h_loc)
        lo, hi = r * h_loc // g, ((r + 1) * h_loc - 1) // g + 1
        if h_loc % g and g % h_loc:  # not a whole run of KV heads
            return
    _cut_all(mod, prefix, q_names, (1, 0, 0), m, r, cut)
    if kv_cut:
        _cut_all(mod, prefix, kv_names, (1, 1, 0, 0), m, r, cut)
    mod.tp = AttnTP(axis_group(mesh, "model"), kv_cut, lo, hi)


def _place_swiglu(mod: SwiGLU, prefix: str, specs, mesh, m, r,
                  cut: dict) -> None:
    names, dims = ("w1", "w3", "w2"), (1, 1, 0)
    if _cuts(specs, prefix, names, dims):
        _cut_all(mod, prefix, names, dims, m, r, cut)
        mod.tp = axis_group(mesh, "model")


def _place_gelu(mod: GeLUMLP, prefix: str, specs, mesh, m, r,
                cut: dict) -> None:
    names, dims = ("w1", "w2"), (1, 0)
    if _cuts(specs, prefix, names, dims):
        _cut_all(mod, prefix, names, dims, m, r, cut)
        mod.tp = axis_group(mesh, "model")


def _place_rglru(mod: RGLRU, prefix: str, specs, mesh, m, r,
                 cut: dict) -> None:
    names = ("w_y", "w_x", "conv", "w_i", "w_r", "lam", "w_o")
    dims = (1, 1, 1, 1, 1, 0, 0)
    if _cuts(specs, prefix, names, dims):
        _cut_all(mod, prefix, names, dims, m, r, cut)
        mod.tp = axis_group(mesh, "model")


def _place_rows(params: nn.Module, name: str, specs, mesh, m, r,
                cut: dict):
    """Cut ``params``' table ``name`` by rows over ``model`` where its spec
    does; returns the ``model`` group if it did, else None."""
    if m > 1 and _layer_spec(specs, name) == ("model", None):
        _cut_all(params, "", (name,), (0,), m, r, cut)
        return axis_group(mesh, "model")
    return None


def _place_head(embed: nn.Module, specs, cfg, mesh, m, r, cut: dict
                ) -> None:
    """The vocab-parallel head: ``out`` cut by columns, or a tied table
    already cut by rows."""
    if m == 1:
        return
    if cfg.tie_embeddings:
        if "embed.table" in cut:
            embed.head = axis_group(mesh, "model")
    elif _cuts(specs, "embed.", ("out",), (1,)):
        _cut_all(embed, "embed.", ("out",), (1,), m, r, cut)
        embed.head = axis_group(mesh, "model")


def _place_moe(mod: MoE, prefix: str, specs, mesh, m, r, cut: dict) -> None:
    names = ("w1", "w3", "w2")
    for by_experts, dims in ((True, (0, 0, 0)), (False, (2, 2, 1))):
        if _cuts(specs, prefix, names, dims):
            _cut_all(mod, prefix, names, dims, m, r, cut)
            mod.tp = MoETP(axis_group(mesh, "model"), m, r, by_experts)
            return


def place(params: nn.Module, mesh, specs: dict[tuple[str, ...], tuple]
          ) -> nn.Module:
    """Put ``params`` on the mesh's device, in place, and return it, each
    leaf cut over ``model`` where the module docstring says; records the
    ``Placement`` as ``params.placement``.  ``specs``: ``param_specs(params,
    mesh)`` of the whole module.  A module placed once is not cut again."""
    dev = _device(mesh)
    if any(t.device != dev for t in params.parameters()):
        params.to(dev)
    if getattr(params, "placement", None) is not None:
        return params
    m, r = axis_size(mesh, "model"), axis_rank(mesh, "model")
    cut: dict[str, int] = {}
    cfg = getattr(params, "cfg", None)
    embed = getattr(params, "embed", None)
    if embed is not None and getattr(embed, "mesh", None) is None:
        if _layer_spec(specs, "embed.table")[0] == "model":
            _cut_all(embed, "embed.", ("table",), (0,), m, r,
                     cut if m > 1 else {})
            embed.mesh = mesh
        if cfg is not None:
            _place_head(embed, specs, cfg, mesh, m, r, cut)
    if m > 1 and cfg is not None and cfg.family in TP_FAMILIES:
        if cfg.family == "audio":
            params.tok_tp = _place_rows(params, "tok", specs, mesh, m, r,
                                        cut)
        for prefix, mod in params.named_modules():
            prefix = f"{prefix}." if prefix else ""
            if isinstance(mod, Attention):
                _place_attention(mod, prefix, specs, cfg, mesh, m, r, cut)
            elif isinstance(mod, SwiGLU):
                _place_swiglu(mod, prefix, specs, mesh, m, r, cut)
            elif isinstance(mod, GeLUMLP):
                _place_gelu(mod, prefix, specs, mesh, m, r, cut)
            elif isinstance(mod, RGLRU):
                _place_rglru(mod, prefix, specs, mesh, m, r, cut)
            elif isinstance(mod, MoE):
                _place_moe(mod, prefix, specs, mesh, m, r, cut)
    params.placement = Placement(mesh, cut)
    return params


def gather_cut(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A leaf cut along ``dim`` over ``group``, joined back whole from
    every rank's slice (every rank of the group calls it)."""
    import torch.distributed as dist

    t = t.detach().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_whole(tensors: dict[str, torch.Tensor], placement: Placement | None
                 ) -> dict[str, torch.Tensor]:
    """``tensors`` (port parameter name -> a parameter, or a tensor of its
    shape such as its gradient) with each cut one joined back to its whole
    shape over ``model``; every rank calls it (a collective a cut leaf)."""
    if placement is None or not placement.cut:
        return dict(tensors)
    group = axis_group(placement.mesh, "model")
    return {name: (t if name not in placement.cut else
                   gather_cut(t, placement.cut[name], group))
            for name, t in tensors.items()}


class Stats:
    """Small helper: parameter/bytes accounting for reports."""

    @staticmethod
    def bytes_of(tree: Any) -> int:
        """Bytes of a module's parameters, or of a tree's tensors."""
        ts = (tree.parameters() if isinstance(tree, nn.Module)
              else (x for _, x in leaves(tree)))
        return sum(t.numel() * t.element_size() for t in ts)
