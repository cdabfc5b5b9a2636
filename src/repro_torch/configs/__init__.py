"""Architecture configs (one module per arch) + shape sets.

The port's own copy of ``repro.configs`` for the dense family
(``llama3-8b``, ``qwen1.5-4b``, ``yi-9b``, ``codeqwen1.5-7b``), the moe
family (``qwen2-moe-a2.7b``, ``moonshot-v1-16b-a3b``), the ssm family
(``mamba2-130m``), the hybrid family (``recurrentgemma-2b``), the vlm
family (``internvl2-2b``) and the audio family (``whisper-tiny``), which
``repro_torch.models.model_zoo.build_model`` builds: every arch of the JAX
package (``LATER``, the archs still to port, is empty).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.common import ModelConfig

from . import (codeqwen15_7b, internvl2_2b, llama3_8b, mamba2_130m,
               moonshot_v1_16b_a3b, qwen2_moe_a27b, qwen15_4b,
               recurrentgemma_2b, whisper_tiny, yi_9b)

__all__ = ["ARCH_IDS", "LATER", "SHAPES", "ShapeSpec", "get_config",
           "get_smoke_config", "applicable_shapes"]

_MODULES = {
    "yi-9b": yi_9b,
    "llama3-8b": llama3_8b,
    "codeqwen1.5-7b": codeqwen15_7b,
    "qwen1.5-4b": qwen15_4b,
    "mamba2-130m": mamba2_130m,
    "recurrentgemma-2b": recurrentgemma_2b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "internvl2-2b": internvl2_2b,
    "whisper-tiny": whisper_tiny,
}
#: the JAX package's archs not ported yet, by family: none
LATER: dict[str, str] = {}

ARCH_IDS = tuple(_MODULES)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# families with sub-quadratic sequence mixing (may run long_500k)
_SUBQUADRATIC = {"ssm", "hybrid"}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def applicable_shapes(arch: str) -> list[str]:
    """The shape cells of ``arch``, as the reference's rule gives them:
    every shape, but ``long_500k`` only for the sub-quadratic families."""
    cfg = get_config(arch)
    return [name for name in SHAPES
            if name != "long_500k" or cfg.family in _SUBQUADRATIC]
