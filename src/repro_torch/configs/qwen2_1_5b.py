"""qwen2-1.5b — [dense] 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias.  [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "qwen2-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        num_layers=28,
        d_model=1536,
        d_ff=8960,
        vocab_size=151_936,
        attention=AttentionConfig(
            kind="gqa", num_heads=12, num_kv_heads=2, head_dim=128,
            rope_theta=1_000_000.0, qkv_bias=True),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=1_000_000.0,
                                  qkv_bias=True))
