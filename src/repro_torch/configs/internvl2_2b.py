"""internvl2-2b: InternViT (stub) + InternLM2 backbone [arXiv:2404.16821]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    vlm=VLMConfig(n_patches=256, d_vision=1024),
    adaptive=AdaptiveConfig(embedding_hot_budget=4096,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, vlm=VLMConfig(n_patches=8, d_vision=32), remat=False,
    )
