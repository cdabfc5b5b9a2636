"""yi-9b: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    adaptive=AdaptiveConfig(embedding_hot_budget=4096,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512, remat=False,
    )
