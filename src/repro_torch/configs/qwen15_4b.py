"""qwen1.5-4b: QKV bias, MHA kv=20, 152k vocab [hf:Qwen/Qwen1.5-4B]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    adaptive=AdaptiveConfig(embedding_hot_budget=8192,
                            embedding_cold_frac=0.4),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False,
    )
