"""llama3.2-1b — [dense] 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "llama3.2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        num_layers=16,
        d_model=2048,
        d_ff=8192,
        vocab_size=128_256,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=8, head_dim=64,
            rope_theta=500_000.0),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=1,
                                  head_dim=16, rope_theta=500_000.0),
        ce_chunk=64)
