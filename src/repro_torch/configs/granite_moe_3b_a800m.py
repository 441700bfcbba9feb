"""granite-moe-3b-a800m — [moe] 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8 — 32… (40) experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Served through ``models/moe.py`` by every engine of the port.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=1536,
        d_ff=512,
        vocab_size=49_155,
        attention=AttentionConfig(
            kind="gqa", num_heads=24, num_kv_heads=8, head_dim=64,
            rope_theta=10_000.0),
        moe=MoEConfig(num_experts=40, top_k=8, d_ff=512),
        tie_embeddings=True,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=64, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=10_000.0),
        moe=MoEConfig(num_experts=5, top_k=2, d_ff=64),
        ce_chunk=64)
