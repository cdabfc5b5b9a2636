"""moonshot-v1-16b-a3b: kimi/moonlight MoE, 64e top-6
[hf:moonshotai/Moonlight-16B-A3B]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
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
