"""whisper-tiny: enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from dataclasses import replace

from repro_torch.models.common import AdaptiveConfig, EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,          # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=4, n_frames=1500),
    adaptive=AdaptiveConfig(embedding_hot_budget=2048,
                            embedding_cold_frac=0.5),
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, encdec=EncDecConfig(n_enc_layers=2, n_frames=32),
        remat=False,
    )
