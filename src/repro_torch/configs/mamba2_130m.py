"""mamba2-130m: SSD state-space model, attention-free [arXiv:2405.21060]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,         # d_inner / head_dim = 1536 / 64
    n_kv_heads=24,
    d_ff=0,             # attention-free; no MLP (mixer-only blocks)
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    tie_embeddings=True,
    adaptive=AdaptiveConfig(embedding_hot_budget=2048,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=16),
        remat=False,
    )
