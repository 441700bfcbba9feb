"""jamba-1.5-large-398b — [hybrid] 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Block group of 8 = 1 attention + 7 Mamba layers (attention at index 4,
as in the public config); MoE MLP on every other layer.  The port
builds, trains and serves it through the eager ``Engine`` (the paged
engines refuse its Mamba blocks, as the reference's do); one H100 holds
its first five layers at full width (``block_pattern[:5]``).
"""
from repro_torch.configs.base import (AttentionConfig, ModelConfig, MoEConfig,
                                SSMConfig)

ARCH_ID = "jamba-1.5-large-398b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=72,
        d_model=8192,
        d_ff=24_576,
        vocab_size=65_536,
        attention=AttentionConfig(
            kind="gqa", num_heads=64, num_kv_heads=8, head_dim=128,
            rope_theta=10_000.0),
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff=24_576),
        moe_every=2,
        norm="rmsnorm",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        num_layers=4, d_model=64, d_ff=128, vocab_size=512,
        attention=AttentionConfig(kind="gqa", num_heads=4, num_kv_heads=2,
                                  head_dim=16, rope_theta=10_000.0),
        ssm=SSMConfig(kind="mamba", d_state=8, d_conv=4, expand=2),
        block_pattern=("mamba", "attn"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=128),
        moe_every=2,
        ce_chunk=64)
