"""llama4-scout-17b-a16e — [moe] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16e top-1 — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Every layer is MoE (16 routed experts, top-1, plus one always-on shared
expert, llama4-style).  Public Scout interleaves chunked-local attention
(window 8192) with occasional global NoPE layers; this config uses the
window everywhere.  The window keeps it off the paged engines: it serves
through the eager ``Engine`` over a contiguous cache.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

ARCH_ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=48,
        d_model=5120,
        d_ff=8192,
        vocab_size=202_048,
        attention=AttentionConfig(
            kind="gqa", num_heads=40, num_kv_heads=8, head_dim=128,
            rope_theta=500_000.0, window=8192),
        moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192,
                      num_shared_experts=1, shared_d_ff=8192),
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=2, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=500_000.0,
                                  window=32),
        moe=MoEConfig(num_experts=4, top_k=1, d_ff=128,
                      num_shared_experts=1, shared_d_ff=128),
        ce_chunk=64)
