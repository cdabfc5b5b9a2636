"""codeqwen1.5-7b: qwen1.5 arch (QKV bias, MHA kv=32) [hf:Qwen/CodeQwen1.5-7B]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    adaptive=AdaptiveConfig(embedding_hot_budget=8192,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False,
    )
