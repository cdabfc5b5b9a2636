"""llama3-8b: dense GQA, 128k vocab [arXiv:2407.21783; unverified]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    adaptive=AdaptiveConfig(embedding_hot_budget=8192,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, remat=False,
    )
