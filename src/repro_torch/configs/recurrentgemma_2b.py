"""recurrentgemma-2b: RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,       # MQA in the local-attention blocks
    d_ff=7680,
    vocab_size=256000,
    tie_embeddings=True,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=2560,
                        window=2048),
    adaptive=AdaptiveConfig(embedding_hot_budget=16384,
                            embedding_cold_frac=0.35),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=512,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"), lru_width=64,
                            window=16),
        remat=False,
    )
