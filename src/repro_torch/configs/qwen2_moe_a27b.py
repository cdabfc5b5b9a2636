"""qwen2-moe-a2.7b: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,           # routed expert width
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_expert=1408,
                  capacity_factor=1.25),
    adaptive=AdaptiveConfig(embedding_hot_budget=8192,
                            embedding_cold_frac=0.4, expert_replication=8),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
        vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=64,
                      capacity_factor=1.5),
        remat=False,
    )
