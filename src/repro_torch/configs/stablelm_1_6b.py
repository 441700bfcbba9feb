"""stablelm-1.6b — [dense] 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]

kv=32 == num_heads, so the GQA config degenerates to MHA.  StableLM-2
uses LayerNorm and an untied LM head; full rotary is kept, as in the
reference config.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        num_layers=24,
        d_model=2048,
        d_ff=5632,
        vocab_size=100_352,
        attention=AttentionConfig(
            kind="gqa", num_heads=32, num_kv_heads=32, head_dim=64,
            rope_theta=10_000.0),
        norm="layernorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=4,
                                  head_dim=16, rope_theta=10_000.0))
