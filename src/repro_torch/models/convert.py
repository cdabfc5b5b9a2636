"""Carry LM weights and optimizer state between the JAX package and the
port, both ways.

``params_from_numpy`` takes the parameter pytree of ``repro.models.
transformer.init_lm`` (or ``repro.models.vlm.init_vlm``, or
``repro.models.whisper.init_whisper``) as numpy
(``jax.tree.map(np.asarray, params)``), whose blocks (the hybrid family's
groups, whisper's ``enc`` and ``dec`` layers) are stacked on axis 0 by
``vmap``, and builds the port's ``LM`` (``whisper.Whisper``).
The port stores weights in the JAX package's (in, out) layout, so nothing
is transposed; each array is copied and cast to ``dtype``.

``params_to_numpy`` goes the other way: the port's ``LM`` (or a mapping of
its parameter names to tensors, such as its gradients) becomes the
reference's tree, blocks stacked on axis 0.  ``ref_path`` is the one place
that names a port parameter in that tree: ``"blocks.3.attn.wq"`` is leaf
``("blocks", "attn", "wq")``, layer 3; ``"groups.1.rec2.mixer.w_y"`` is
``("groups", "rec2", "mixer", "w_y")``, group 1;
``"dec.2.cross.wk"`` is ``("dec", "cross", "wk")``, decoder layer 2; the
hybrid ``tail`` is a
list in both trees, so ``"tail.0.mlp.w1"`` is ``("tail", "0", "mlp",
"w1")`` with no layer.  ``opt_state_to_numpy`` /
``opt_state_from_numpy`` carry an ``OptState``, whose ``m`` and ``v`` are
already trees of the reference's structure.

``cache_from_numpy`` / ``cache_to_numpy`` carry a decode cache (nested
dicts and lists of arrays, the same structure in both packages) across,
each leaf in its own dtype: an int8 cache's payloads ``k`` and ``v`` stay
int8 beside their float32 ``k_scale`` and ``v_scale``, a bf16 leaf stays
bf16, so both packages' decode can step from the same cache.  A hybrid
cache made for a model placed cut over ``model`` holds this rank's
channels of each RG-LRU state: ``cache_to_numpy(cache, params)`` gathers
them whole (every rank calls it).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch.core.backend import resolve_device

from . import attention as attn
from . import embedding as emb
from . import mlp as mlpm
from . import moe as moem
from . import rglru as rg
from . import ssm as ssmm
from . import transformer as tfm
from . import vlm as vlmm
from . import whisper as whm
from .common import ModelConfig

__all__ = ["params_from_numpy", "params_to_numpy", "ref_path", "ref_shapes",
           "tree_leaf", "opt_state_to_numpy", "opt_state_from_numpy",
           "cache_from_numpy", "cache_to_numpy"]


#: the port's layer lists the reference stacks on axis 0
_STACKED = ("blocks", "groups", "enc", "dec")


def ref_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """(path in the reference's tree, layer) of a port parameter name:
    block (group) parameters name their stacked leaf and their index on
    axis 0; a hybrid tail parameter names its list index in the path."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def tree_leaf(tree: dict, name: str):
    """The leaf of a reference-structured tree that port parameter ``name``
    maps to: the stacked leaf's row for a block parameter (a view for a
    tensor, so writing it writes the tree)."""
    path, layer = ref_path(name)
    leaf = tree
    for key in path:
        leaf = leaf[int(key)] if isinstance(leaf, list) else leaf[key]
    return leaf if layer is None else leaf[layer]


def _named(src) -> dict[str, torch.Tensor]:
    if isinstance(src, torch.nn.Module):
        return dict(src.named_parameters())
    return dict(src)


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _ref_tree(src, leaf, stack) -> dict[str, Any]:
    """The reference's tree of ``leaf(tensor)`` per port parameter, the
    block leaves joined by ``stack`` in layer order."""
    tree: dict[str, Any] = {}
    stacked: dict[tuple[str, ...], dict[int, Any]] = {}
    for name, t in _named(src).items():
        path, layer = ref_path(name)
        if layer is None:
            _put(tree, path, leaf(t))
        else:
            stacked.setdefault(path, {})[layer] = leaf(t)
    for path, rows in stacked.items():
        _put(tree, path, stack([rows[i] for i in range(len(rows))]))
    if isinstance(src, tfm.LM) and src.cfg.family == "hybrid":
        tree.setdefault("tail", {})
    if "tail" in tree:  # a list in the reference's tree
        tree["tail"] = [tree["tail"][str(i)]
                        for i in range(len(tree["tail"]))]
    return tree


def params_to_numpy(src: "tfm.LM | Mapping[str, torch.Tensor]"
                    ) -> dict[str, Any]:
    """The reference's float32 numpy tree of the port's ``LM``, or of a
    mapping from its parameter names to tensors (its gradients, say), with
    the block leaves stacked on axis 0 in layer order."""
    return _ref_tree(src, lambda t: t.detach().float().cpu().numpy(),
                     np.stack)


def ref_shapes(src: "tfm.LM | Mapping[str, torch.Tensor]") -> dict[str, Any]:
    """The reference tree's leaf shapes for the port's ``LM`` (nothing is
    copied)."""
    return _ref_tree(src, lambda t: tuple(t.shape),
                     lambda rows: (len(rows), *rows[0]))


def opt_state_to_numpy(state) -> tuple[int, dict, dict]:
    """(step, m, v) of the port's ``OptState`` as a Python int and the
    reference's float32 numpy trees."""
    host = lambda t: t.detach().cpu().numpy()
    return int(state.step), tree_map(host, state.m), tree_map(host, state.v)


def opt_state_from_numpy(step, m: dict, v: dict,
                         device: str | torch.device = "cuda"):
    """The port's ``OptState`` holding a reference state's step and its
    (m, v) numpy trees, float32 on ``device``."""
    from repro_torch.optim.adamw import OptState

    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    return OptState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                 device=dev),
                    tree_map(t, m), tree_map(t, v))


def _cache_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _cache_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cache_map(v, fn) for v in tree]
    return fn(tree)


def cache_from_numpy(tree, device: str | torch.device = "cuda"):
    """The port's decode cache holding a reference cache's numpy leaves
    (``jax.tree.map(np.asarray, cache)``) on ``device``: int8 and float32
    leaves keep their dtype, bfloat16 ones (``ml_dtypes``) become
    ``torch.bfloat16``."""
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(dev)

    return _cache_map(tree, leaf)


def cache_to_numpy(cache, params=None):
    """The reference's numpy tree of a port decode cache: int8 leaves stay
    int8, float leaves become float32 (exact for bf16).  ``params``: the
    model the cache is for; where it is a hybrid whose RG-LRU blocks are
    cut over ``model``, their states (this rank's channels, the last
    dimension) are gathered whole over it."""
    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.numpy() if t.dtype in (torch.int8, torch.float32)
                else t.float().numpy())

    placement = getattr(params, "placement", None)
    if placement is not None and any(n.endswith("mixer.lam")
                                     for n in placement.cut):
        from repro_torch.launch.shardings import gather_cut
        from .collectives import axis_group

        group = axis_group(placement.mesh, "model")
        whole = lambda t: gather_cut(t, t.dim() - 1, group)
        cache = {k: (_cache_map(v, whole) if k in _REC_STATES else v)
                 for k, v in cache.items()}
    return _cache_map(cache, leaf)


#: a hybrid cache's RG-LRU states
_REC_STATES = ("rec1", "rec2", "tail")


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None
                      ) -> "tfm.LM | whm.Whisper":
    """The port's ``LM`` holding the weights of ``tree`` (a dense, moe,
    ssm, hybrid or vlm model's numpy pytree; a ``Whisper`` for the audio
    family's), on ``device``, stored as ``dtype`` (default the config's
    param dtype)."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.pdtype

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dt)

    if cfg.family == "audio":
        return _whisper(cfg, tree, t)

    embed = emb.Embedding({k: t(v) for k, v in tree["embed"].items()})
    if cfg.family == "hybrid":
        groups = [tfm.HybridGroup(*(
            _hybrid_sub(cfg, kind, tree["groups"][name], t, g)
            for name, kind in (("rec1", "rec"), ("rec2", "rec"),
                               ("attn", "attn"))))
            for g in range(tfm.hybrid_counts(cfg)[0])]
        tail = [_hybrid_sub(cfg, "rec", d, t) for d in tree["tail"]]
        return tfm.LM(cfg, embed, groups, t(tree["ln_f"]), tail)
    stacked = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        layer = lambda d: {k: t(v[i]) for k, v in d.items()}
        if cfg.family == "ssm":
            blocks.append(tfm.SSMBlock(cfg, t(stacked["ln1"][i]),
                                       ssmm.SSM(cfg, layer(stacked["ssm"]))))
            continue
        if cfg.moe is not None:
            m = stacked["moe"]
            ffn = moem.MoE(layer({k: v for k, v in m.items()
                                  if k != "shared"}),
                           mlpm.SwiGLU(layer(m["shared"]))
                           if "shared" in m else None)
        else:
            ffn = mlpm.SwiGLU(layer(stacked["mlp"]))
        blocks.append(tfm.Block(
            cfg, t(stacked["ln1"][i]), t(stacked["ln2"][i]),
            attn.Attention(cfg, layer(stacked["attn"])), ffn))
    lm = tfm.LM(cfg, embed, blocks, t(tree["ln_f"]))
    if "projector" in tree:
        lm.projector = vlmm.Projector({k: t(v) for k, v in
                                       tree["projector"].items()})
    return lm


def _hybrid_sub(cfg: ModelConfig, kind: str, d: dict, t,
                i: int | None = None) -> tfm.HybridSub:
    """A hybrid sub-block from its tree ``d``: row ``i`` of a stacked
    group's leaves, or a tail entry's own (``i`` None)."""
    row = (lambda a: t(a)) if i is None else (lambda a: t(a[i]))
    leaves = lambda sub: {k: row(v) for k, v in sub.items()}
    mixer = (rg.RGLRU(cfg, leaves(d["mixer"])) if kind == "rec" else
             attn.Attention(cfg, leaves(d["mixer"])))
    return tfm.HybridSub(cfg, kind, row(d["ln1"]), mixer, row(d["ln2"]),
                         mlpm.SwiGLU(leaves(d["mlp"])))


def _whisper(cfg: ModelConfig, tree: dict, t) -> whm.Whisper:
    """A ``Whisper`` from the reference's tree: ``enc`` and ``dec`` rows
    unstacked, one layer each."""
    def layer(d: dict, i: int):
        ln = lambda name: whm.LayerNorm(t(d[name]["g"][i]),
                                        t(d[name]["b"][i]))
        leaves = lambda name: {k: t(v[i]) for k, v in d[name].items()}
        return ln, leaves

    enc = []
    for i in range(cfg.encdec.n_enc_layers):
        ln, leaves = layer(tree["enc"], i)
        enc.append(whm.EncLayer(cfg, ln("ln1"),
                                attn.Attention(cfg, leaves("attn")),
                                ln("ln2"), mlpm.GeLUMLP(leaves("mlp"))))
    dec = []
    for i in range(cfg.n_layers):
        ln, leaves = layer(tree["dec"], i)
        dec.append(whm.DecLayer(
            cfg, ln("ln1"), attn.Attention(cfg, leaves("self")), ln("ln2"),
            attn.Attention(cfg, leaves("cross")), ln("ln3"),
            mlpm.GeLUMLP(leaves("mlp"))))
    norm = lambda d: whm.LayerNorm(t(d["g"]), t(d["b"]))
    return whm.Whisper(cfg, t(tree["enc_pos"]), t(tree["dec_pos"]),
                       t(tree["tok"]), enc, dec, norm(tree["ln_enc"]),
                       norm(tree["ln_dec"]))
