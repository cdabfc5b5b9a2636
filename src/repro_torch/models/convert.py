"""Carry the JAX package's LM weights into the port.

``params_from_numpy`` takes the parameter pytree of ``repro.models.
transformer.init_lm`` as numpy (``jax.tree.map(np.asarray, params)``), whose
blocks are stacked on axis 0 by ``vmap``, and builds the port's ``LM``.  The
port stores weights in the JAX package's (in, out) layout, so nothing is
transposed; each array is copied and cast to ``dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.backend import resolve_device

from . import attention as attn
from . import embedding as emb
from . import mlp as mlpm
from . import transformer as tfm
from .common import ModelConfig

__all__ = ["params_from_numpy"]


def params_from_numpy(tree: dict, cfg: ModelConfig,
                      device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> tfm.LM:
    """The port's ``LM`` holding the weights of ``tree`` (a dense model's
    numpy pytree), on ``device``, stored as ``dtype`` (default the config's
    param dtype)."""
    tfm.check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or cfg.pdtype

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, dt)

    stacked = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        layer = lambda d: {k: t(v[i]) for k, v in d.items()}
        blocks.append(tfm.Block(
            cfg, t(stacked["ln1"][i]), t(stacked["ln2"][i]),
            attn.Attention(cfg, layer(stacked["attn"])),
            mlpm.SwiGLU(layer(stacked["mlp"]))))
    return tfm.LM(cfg, emb.Embedding({k: t(v) for k, v in
                                      tree["embed"].items()}),
                  blocks, t(tree["ln_f"]))
