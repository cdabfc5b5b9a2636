"""Carry LM weights and optimizer state between the JAX package and the
port, both ways.

``params_from_numpy`` takes the parameter pytree of ``repro.models.
transformer.init_lm`` as numpy (``jax.tree.map(np.asarray, params)``), whose
blocks are stacked on axis 0 by ``vmap``, and builds the port's ``LM``.  The
port stores weights in the JAX package's (in, out) layout, so nothing is
transposed; each array is copied and cast to ``dtype``.

``params_to_numpy`` goes the other way: the port's ``LM`` (or a mapping of
its parameter names to tensors, such as its gradients) becomes the
reference's tree, blocks stacked on axis 0.  ``ref_path`` is the one place
that names a port parameter in that tree: ``"blocks.3.attn.wq"`` is leaf
``("blocks", "attn", "wq")``, layer 3.  ``opt_state_to_numpy`` /
``opt_state_from_numpy`` carry an ``OptState``, whose ``m`` and ``v`` are
already trees of the reference's structure.
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
from . import transformer as tfm
from .common import ModelConfig

__all__ = ["params_from_numpy", "params_to_numpy", "ref_path", "ref_shapes",
           "tree_leaf", "opt_state_to_numpy", "opt_state_from_numpy"]


def ref_path(name: str) -> tuple[tuple[str, ...], int | None]:
    """(path in the reference's tree, layer) of a port parameter name:
    block parameters name their stacked leaf and their index on axis 0."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return ("blocks", *parts[2:]), int(parts[1])
    return tuple(parts), None


def tree_leaf(tree: dict, name: str):
    """The leaf of a reference-structured tree that port parameter ``name``
    maps to: the stacked leaf's row for a block parameter (a view for a
    tensor, so writing it writes the tree)."""
    path, layer = ref_path(name)
    leaf = tree
    for key in path:
        leaf = leaf[key]
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


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> tfm.LM:
    """The port's ``LM`` holding the weights of ``tree`` (a dense or moe
    model's numpy pytree), on ``device``, stored as ``dtype`` (default the
    config's param dtype)."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.pdtype

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dt)

    stacked = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        layer = lambda d: {k: t(v[i]) for k, v in d.items()}
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
    return tfm.LM(cfg, emb.Embedding({k: t(v) for k, v in
                                      tree["embed"].items()}),
                  blocks, t(tree["ln_f"]))
